"""Data and tensor parallelism over torch.distributed (counterpart of
sar_tpu/parallel): `distributed` starts the process group and splits
batches, `sharding` builds meshes, places parameters and holds the
collectives the model calls."""
