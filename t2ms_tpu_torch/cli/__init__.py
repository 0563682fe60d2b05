"""Command-line entry points: ``python -m t2ms_tpu_torch.cli.train`` and
``python -m t2ms_tpu_torch.cli.infer``."""
