from sar_tpu_torch.data.tokenizer import CharTokenizer  # noqa: F401
