"""control modules of the PyTorch port."""
