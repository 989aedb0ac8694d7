"""Command-line entry points of the port (`python -m sar_tpu_torch.scripts.<name>`)."""
