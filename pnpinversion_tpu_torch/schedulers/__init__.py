"""schedulers of the PyTorch port."""
