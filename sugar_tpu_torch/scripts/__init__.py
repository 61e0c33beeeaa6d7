"""Command-line entry points: ``python -m sugar_tpu_torch.scripts.<name>``."""
