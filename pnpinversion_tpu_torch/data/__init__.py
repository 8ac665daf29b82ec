"""PIE-Bench data layer of the PyTorch port."""
