"""Command-line tools of the port (`python -m drone2d_tpu_torch.scripts.<name>`)."""
