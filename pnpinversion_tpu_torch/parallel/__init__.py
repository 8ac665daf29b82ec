"""Batched multi-image editing on one GPU (``sweep``), and several processes, one
per GPU, over ``torch.distributed`` (``multihost``)."""
