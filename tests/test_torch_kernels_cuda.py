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
@pytest.mark.parametrize("b,sq,sk,d,strided", [
    (2, 1024, 1024, 80, True), (2, 4096, 4096, 40, True), (2, 1000, 77, 40, False),
    (2, 256, 256, 64, False),
    # edges of the forward's tiling: Sq and Sk not multiples of 128 (64- and
    # 128-row tiles), d = 128 and 16, a long cross shape, the 4-row 64^2 site
    (1, 1000, 1000, 80, True), (4, 1000, 1000, 80, True), (1, 1024, 1024, 128, False),
    (2, 1024, 1024, 16, False), (1, 4096, 77, 40, True), (4, 4096, 4096, 40, True)])
def test_kernel_matches_plain_on_cuda(cuda_device, b, sq, sk, d, strided):
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def make(s):
        if strided:  # heads split from (B, S, H*D), as the UNet makes them
            x = torch.randn((b, s, 8 * d), generator=gen, device=cuda_device)
            return x.to(torch.bfloat16).view(b, s, 8, d).transpose(1, 2)
        return torch.randn((b, 8, s, d), generator=gen, device=cuda_device).to(torch.bfloat16)

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
def test_kernel_takes_expanded_inputs_on_cuda(cuda_device):
    """K/V broadcast over the batch (stride 0), which a TMA tensor map cannot
    describe: the wrapper copies them and the result matches."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((3, 8, 256, 40), generator=gen, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((1, 8, 200, 40), generator=gen, device=cuda_device)
            .to(torch.bfloat16).expand(3, -1, -1, -1) for _ in range(2))
    out, lse = tflash.flash_attention_fwd(q, k, v, 40 ** -0.5)
    torch.cuda.synchronize()
    want, lse_want = tflash.flash_attention_reference(q, k, v, 40 ** -0.5)
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


def _bwd_inputs(device, b, h, sq, sk, d, strided, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(s):
        if strided:
            x = torch.randn((b, s, h * d), generator=gen, device=device)
            return x.to(torch.bfloat16).view(b, s, h, d).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen, device=device).to(torch.bfloat16)

    q, k, v, do = make(sq), make(sk), make(sk), make(sq)
    out, lse = tflash.flash_attention_fwd(q, k, v, d ** -0.5)
    return q, k, v, out, lse, do


def _bwd_rel_errs(got, want):
    """max |kernel - plain| / max |plain| of dQ, dK and dV: P and dS are
    rounded to bf16 before their products, and the outputs are bf16."""
    errs = []
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        errs.append(((g.float() - w.float()).abs().max() / w.float().abs().max()).item())
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,d,strided", [
    (1, 4096, 4096, 40, True), (1, 1024, 1024, 80, True), (2, 1000, 77, 40, False),
    (1, 200, 330, 64, False),
    # ragged key and query tiles (keys past Sk masked, rows past Sq zero),
    # the long cross shape, the smallest and largest head dims, 2 and 4 rows
    (1, 4096, 77, 40, True), (1, 1000, 1000, 80, True), (4, 1000, 1000, 80, True),
    (2, 1024, 1024, 16, False), (1, 1024, 1024, 128, False), (4, 4096, 4096, 40, True)])
def test_bwd_kernels_match_plain_on_cuda(cuda_device, b, sq, sk, d, strided):
    q, k, v, out, lse, do = _bwd_inputs(cuda_device, b, 8, sq, sk, d, strided)
    scale = d ** -0.5
    before = [fn.launches for fn in tflash.BWD_WRAPPERS]
    got = tflash.flash_attention_bwd(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    assert [fn.launches for fn in tflash.BWD_WRAPPERS] == [n + 1 for n in before]
    want = tflash.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    assert max(_bwd_rel_errs(got, want)) <= 2e-2
    # both key tiles of the main kernel, whichever bwd_tile_keys picks
    for tile in (64, 128):
        stats, dq_acc = tflash.flash_attention_bwd_prep(out, lse, do)
        dk, dv = tflash._launch_bwd_main(q, k, v, do, stats, dq_acc, scale, tile,
                                         tflash._stream(q))
        dq = tflash.flash_attention_bwd_dq_convert(dq_acc, q, scale)
        torch.cuda.synchronize()
        assert max(_bwd_rel_errs((dq, dk, dv), want)) <= 2e-2, tile


@pytest.mark.cuda
def test_bwd_prep_matches_plain_on_cuda(cuda_device):
    """delta = rowsum(dO * O) and LSE * log2(e) per query row, zero past Sq."""
    q, k, v, out, lse, do = _bwd_inputs(cuda_device, 2, 8, 1000, 77, 40, True)
    stats, dq_acc = tflash.flash_attention_bwd_prep(out, lse, do)
    torch.cuda.synchronize()
    want, _ = tflash.flash_attention_bwd_prep_reference(out, lse, do)
    assert ((stats - want).abs() / want.abs().clamp_min(1.0)).max().item() <= 1e-3
    assert not stats[:, -1, :, 1000 % 64:].any() and not dq_acc.any()


@pytest.mark.cuda
def test_bwd_takes_expanded_do_on_cuda(cuda_device):
    """A dO broadcast over the batch (stride 0), as a sum's gradient is: the
    backward copies it and the result matches."""
    q, k, v, out, lse, _ = _bwd_inputs(cuda_device, 3, 8, 256, 200, 40, False)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    do = torch.randn((1, 8, 256, 40), generator=gen, device=cuda_device).to(torch.bfloat16)
    do = do.expand(3, -1, -1, -1)
    got = tflash.flash_attention_bwd(q, k, v, out, lse, do, 40 ** -0.5)
    torch.cuda.synchronize()
    want = tflash.flash_attention_bwd_reference(q, k, v, out, lse, do, 40 ** -0.5)
    assert max(_bwd_rel_errs(got, want)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("sq,d", [(4096, 40), (1024, 80)])
def test_bwd_run_to_run_on_cuda(cuda_device, sq, d):
    """dK and dV are bit-identical from run to run; dQ, summed by bulk
    reduce-adds in an order that varies, stays within a bf16 rounding step
    of itself."""
    q, k, v, out, lse, do = _bwd_inputs(cuda_device, 1, 8, sq, sq, d, True)
    runs = [tflash.flash_attention_bwd(q, k, v, out, lse, do, d ** -0.5) for _ in range(4)]
    torch.cuda.synchronize()
    for dq, dk, dv in runs[1:]:
        assert torch.equal(dk, runs[0][1]) and torch.equal(dv, runs[0][2])
        diff = (dq.float() - runs[0][0].float()).abs().max() / runs[0][0].float().abs().max()
        assert diff.item() <= 2 ** -7


@pytest.mark.cuda
def test_flash_attention_function_round_trip_on_cuda(cuda_device):
    """FlashAttention records a graph on CUDA tensors that require grad, and
    its backward launches the three backward kernels; the raw forward
    refuses such inputs."""
    q, k, v, out, lse, do = _bwd_inputs(cuda_device, 1, 8, 1024, 1024, 80, True)
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    with pytest.raises(RuntimeError):
        tflash.flash_attention_fwd(q, k, v, 80 ** -0.5)
    o = tflash.flash_attention(q, k, v, 80 ** -0.5)
    assert o.grad_fn is not None
    before = [fn.launches for fn in tflash.BWD_WRAPPERS]
    o.backward(do)
    torch.cuda.synchronize()
    assert [fn.launches for fn in tflash.BWD_WRAPPERS] == [n + 1 for n in before]
    want = tflash.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), out, lse,
                                                do, 80 ** -0.5)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert ((g.float() - w.float()).abs().max() / w.float().abs().max()).item() <= 2e-2
