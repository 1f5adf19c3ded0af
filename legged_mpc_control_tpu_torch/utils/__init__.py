"""utils modules of the PyTorch port: checkpoints, diagnostics bags, the
live gain channel."""
