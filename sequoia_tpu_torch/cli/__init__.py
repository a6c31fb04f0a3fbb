"""Command-line entry points of the port (``python -m sequoia_tpu_torch.cli.<name>``)."""
