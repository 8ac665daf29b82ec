"""inversion of the PyTorch port."""
