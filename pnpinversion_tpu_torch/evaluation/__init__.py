"""The PIE-Bench evaluator of the PyTorch port."""
