"""Batched multi-image editing on one GPU (``sweep``), several processes, one
per GPU, over ``torch.distributed`` (``multihost``), and the tensor-parallel
axis over groups of them (``tensor_parallel``)."""
