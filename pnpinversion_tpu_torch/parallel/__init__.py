"""Batched multi-image editing on one GPU."""
