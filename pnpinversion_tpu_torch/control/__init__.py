"""control of the PyTorch port."""
