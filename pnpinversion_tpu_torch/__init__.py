"""PyTorch/CUDA port of pnpinversion_tpu for NVIDIA Hopper GPUs.

It imports torch and never jax, and nothing of ``pnpinversion_tpu``: it keeps
its own copies of what it needs. Public functions keep the JAX package's
layouts (latents NHWC, images uint8 (H, W, 3), attention (B, H, S, D)).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
