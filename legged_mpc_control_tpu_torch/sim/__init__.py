"""sim modules of the PyTorch port."""
