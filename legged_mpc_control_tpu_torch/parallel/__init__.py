"""parallel modules of the PyTorch port."""
