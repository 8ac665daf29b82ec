"""editors of the PyTorch port."""
