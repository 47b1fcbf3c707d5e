"""Command-line entry points: python -m voxactb_tpu_torch.cli.train / .eval / .dataset"""
