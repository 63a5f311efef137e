"""Command-line entry points of the port (``python -m
morefusion_tpu_torch.cli.<name>``)."""
