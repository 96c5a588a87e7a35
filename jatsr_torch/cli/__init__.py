"""Command-line entry points of the port (``python -m jatsr_torch.cli.*``)."""
