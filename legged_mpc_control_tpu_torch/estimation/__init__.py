"""State estimators of the PyTorch port."""
