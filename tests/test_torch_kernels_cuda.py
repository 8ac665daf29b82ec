"""The PyTorch port's CUDA kernels on the card: each against its plain
version, and the wrappers' refusals. Skipped without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs on a GPU host without
them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from pnpinversion_tpu_torch.ops import flash_attention as tflash


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,strided", [(1024, 1024, 80, True), (4096, 4096, 40, True),
                                             (1000, 77, 40, False), (256, 256, 64, False)])
def test_kernel_matches_plain_on_cuda(cuda_device, sq, sk, d, strided):
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def make(s):
        if strided:  # heads split from (B, S, H*D), as the UNet makes them
            x = torch.randn((2, s, 8 * d), generator=gen, device=cuda_device)
            return x.to(torch.bfloat16).view(2, s, 8, d).transpose(1, 2)
        return torch.randn((2, 8, s, d), generator=gen, device=cuda_device).to(torch.bfloat16)

    q, k, v = make(sq), make(sk), make(sk)
    before = tflash.flash_attention_fwd.launches
    out, lse = tflash.flash_attention_fwd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert tflash.flash_attention_fwd.launches == before + 1
    want, lse_want = tflash.flash_attention_reference(q, k, v, d ** -0.5)
    # bf16 output rounding of values |O| < ~3
    assert (out.float() - want.float()).abs().max().item() <= 1e-2
    assert ((lse - lse_want).abs() / lse_want.abs()).max().item() <= 1e-3


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_cuda(cuda_device):
    """On a CUDA tensor the wrapper launches the kernel or raises."""
    x32 = torch.zeros(1, 2, 128, 40, device=cuda_device)
    with pytest.raises(TypeError):
        tflash.flash_attention_fwd(x32, x32, x32, 0.1)
    x = torch.zeros(1, 2, 128, 136, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tflash.flash_attention_fwd(x, x, x, 0.1)
