"""mpc modules of the PyTorch port."""
