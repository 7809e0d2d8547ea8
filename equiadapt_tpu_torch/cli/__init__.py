"""Command-line entry points of the port (`python -m equiadapt_tpu_torch.cli.<name>`)."""
