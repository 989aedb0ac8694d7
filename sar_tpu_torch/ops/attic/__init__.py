"""Counterparts of sar_tpu/ops/attic/: the two parked TPU decode kernels,
each with a hand-written Hopper kernel (K9, K10) and its plain PyTorch
version. As in the JAX package, nothing on a decode path calls them:

- decode_self.py (K9): s8 self-attention decode over head-minor int8
  slabs with a dynamic valid length;
- attention.py (K10): bf16 flash-decode attention of one query row,
  optionally masked to a valid length.
"""
