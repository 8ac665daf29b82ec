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
    (2, 1024, 1024, 16, False), (1, 4096, 77, 40, True), (4, 4096, 4096, 40, True),
    # the batched editor at 4 images: 3 rows each in the DirectInversion
    # scan, 4 in the CFG loops
    (12, 4096, 4096, 40, True), (12, 1024, 1024, 80, True), (16, 4096, 4096, 40, True),
    (16, 1024, 1024, 80, True),
    # the batched class at 2 images: 3 and 4 rows each
    (6, 4096, 4096, 40, True), (6, 1024, 1024, 80, True), (8, 4096, 4096, 40, True),
    (8, 1024, 1024, 80, True),
    # training at 256^2 crops: the 32^2 sites of down_blocks[0]/up_blocks[3]
    # (8 heads of d = 40) at batch 8 and 32
    (8, 1024, 1024, 40, True), (32, 1024, 1024, 40, True)])
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
@pytest.mark.parametrize("b,h,s", [(2, 5, 4096), (2, 10, 1024), (8, 5, 4096), (8, 10, 1024)])
def test_kernel_at_sd21_shapes_on_cuda(cuda_device, b, h, s):
    """SD2.1's 64-dim heads (5 at 64^2, 10 at 32^2) at Blended Latent
    Diffusion's 2 rows and its batched class's 8 (4 images), heads split from
    (B, S, H*64) as the UNet makes them."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((b, s, h * 64), generator=gen, device=cuda_device).to(torch.bfloat16)
               .view(b, s, h, 64).transpose(1, 2) for _ in range(3))
    out, lse = tflash.flash_attention_fwd(q, k, v, 0.125)
    torch.cuda.synchronize()
    want, lse_want = tflash.flash_attention_reference(q, k, v, 0.125)
    assert (out.float() - want.float()).abs().max().item() <= 1e-2
    assert ((lse - lse_want).abs() / lse_want.abs()).max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("sq,d", [(4096, 40), (1024, 80)])
def test_kernel_union_shapes_on_cuda(cuda_device, sq, d):
    """MasaCtrl's union at 4 rows: Sk = 2 Sq (each row's half-source K/V and
    its own, concatenated), q heads split from (B, S, H*D), k/v contiguous."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q = (torch.randn((4, sq, 8 * d), generator=gen, device=cuda_device).to(torch.bfloat16)
         .view(4, sq, 8, d).transpose(1, 2))
    k, v = (torch.randn((4, 8, 2 * sq, d), generator=gen, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    out, lse = tflash.flash_attention_fwd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    want, lse_want = tflash.flash_attention_reference(q, k, v, d ** -0.5)
    assert (out.float() - want.float()).abs().max().item() <= 1e-2
    assert ((lse - lse_want).abs() / lse_want.abs()).max().item() <= 1e-3


@pytest.mark.cuda
def test_batched_masactrl_unet_call_on_cuda(cuda_device):
    """One SD1.4 UNet call on the card at 2 images x 4 rows under MasaCtrl at
    an active step: each image's source rows (0 and 2 of its 4) come out as
    the uncontrolled call's, bit for bit (the control gives a source row its
    own K/V and the rows do not mix), its target rows move, and B1 runs at
    every flash site."""
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.control.base import NO_CONTROL
    from pnpinversion_tpu_torch.control.masactrl import MasaCtrlControl, MasaCtrlSpec
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    pipe = SDPipeline.create(SD14, device="cuda")
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((8, 64, 64, 4), generator=gen, device=cuda_device).to(pipe.dtype)
    ctx = torch.cat([pipe.encode_prompt(["", "", "", "a cat"]),
                     pipe.encode_prompt(["", "", "", "a dog"])])
    eps = {}
    for name, control in (("plain", NO_CONTROL), ("masactrl", MasaCtrlControl(MasaCtrlSpec()))):
        before = tflash.flash_attention_fwd.launches
        with torch.inference_mode():
            eps[name], _ = pipe.unet(x, 500, ctx, control, {}, {}, 4)
        torch.cuda.synchronize()
        assert tflash.flash_attention_fwd.launches - before == 10
        assert torch.isfinite(eps[name]).all()
    src, tgt = [0, 2, 4, 6], [1, 3, 5, 7]
    assert torch.equal(eps["masactrl"][src], eps["plain"][src])
    assert all(not torch.equal(eps["masactrl"][r], eps["plain"][r]) for r in tgt)


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
    """On a CUDA tensor the wrapper launches the kernel or raises: f16 (neither
    bf16 nor f32) and a head dim past 128 raise."""
    x16 = torch.zeros(1, 2, 128, 40, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        tflash.flash_attention_fwd(x16, x16, x16, 0.1)
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
    (2, 1024, 1024, 16, False), (1, 1024, 1024, 128, False), (4, 4096, 4096, 40, True),
    # batched null-text at 2, 4 and 8 images (one row each); pix2pix-zero's
    # batched class at 4 images (2 rows each) differentiates 8 rows at 32^2
    (2, 4096, 4096, 40, True), (2, 1024, 1024, 80, True), (8, 4096, 4096, 40, True),
    (4, 1024, 1024, 80, True), (8, 1024, 1024, 80, True),
    # training at 256^2 crops: every microbatch differentiates the 32^2
    # sites of d = 40 at batch 8 and 32
    (8, 1024, 1024, 40, True), (32, 1024, 1024, 40, True)])
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


def _f32_inputs(device, b, sq, sk, d, strided, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(s):
        if strided:  # heads split from (B, S, H*D), as the UNet makes them
            return torch.randn((b, s, 8 * d), generator=gen, device=device).view(
                b, s, 8, d).transpose(1, 2)
        return torch.randn((b, 8, s, d), generator=gen, device=device)

    return make(sq), make(sk), make(sk), make(sq)


@pytest.fixture
def full_f32(cuda_device):
    """TF32 off for the plain versions, as the f32 pipeline runs."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,d,strided", [
    (1, 4096, 4096, 40, True), (3, 1024, 1024, 80, True), (1, 1000, 77, 40, False),
    (2, 1000, 1000, 80, True), (1, 1024, 1024, 128, False), (2, 200, 330, 16, False),
    # the backward's tiles: 128-row dK/dV up to d = 48, 16 and 8 queries a stage
    (2, 1000, 1000, 48, False), (1, 200, 333, 96, False), (1, 77, 300, 120, False)])
def test_f32_kernels_match_plain_on_cuda(full_f32, b, sq, sk, d, strided):
    """The f32 forward (split pass and 3xTF32 kernel), dQ and dK/dV kernels
    (3xTF32, each after its split pass) against their plain versions in full
    f32: O within 2e-5 of max |O|, LSE within 1e-5, the gradients within
    1e-4 of their largest value, and the backward bit-identical run to run.
    A transposed tile (V^T, K^T, Q^T, dO^T) whose positions were stored out
    of the order the products read them (F32_KEY_PERM) fails here."""
    q, k, v, do = _f32_inputs(full_f32, b, sq, sk, d, strided)
    scale = d ** -0.5
    before = [fn.launches for fn in tflash.F32_WRAPPERS]
    out, lse = tflash.flash_attention_fwd(q, k, v, scale)
    grads = [tflash.flash_attention_bwd(q, k, v, out, lse, do, scale) for _ in range(2)]
    torch.cuda.synchronize()
    # forward, its split, two dQ and two dK/dV, each after its own split pass
    assert [fn.launches for fn in tflash.F32_WRAPPERS] == [
        n + m for n, m in zip(before, (1, 1, 2, 2, 4))]
    want, lse_want = tflash.flash_attention_reference(q, k, v, scale)
    assert out.dtype == torch.float32
    assert ((out - want).abs().max() / want.abs().max()).item() <= 2e-5
    assert (lse - lse_want).abs().max().item() <= 1e-5
    for g, w in zip(grads[0], tflash.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)):
        assert g.dtype == torch.float32
        assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
def test_f32_pipeline_unet_call_on_cuda(cuda_device):
    """An f32 SD1.4 pipeline on the card (TF32 turned off by create) runs a
    UNet call through the f32 forward kernel at its 10 flash sites."""
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        pipe = SDPipeline.create(SD14, device="cuda", dtype=torch.float32)
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        gen = torch.Generator(device=cuda_device).manual_seed(4)
        x = torch.randn((1, 64, 64, 4), generator=gen, device=cuda_device)
        before = tflash.flash_attention_fwd_f32.launches, tflash.flash_attention_fwd.launches
        with torch.inference_mode():
            eps, _ = pipe.unet(x, 500, pipe.encode_prompt(["a cat on a mat"]))
        torch.cuda.synchronize()
        assert eps.shape == x.shape and eps.dtype == torch.float32
        assert torch.isfinite(eps).all()
        assert (tflash.flash_attention_fwd_f32.launches - before[0],
                tflash.flash_attention_fwd.launches - before[1]) == (10, 0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("rows,sq,d", [(r, s, d) for r in (8, 12, 16)
                                       for s, d in ((4096, 40), (1024, 80))])
def test_f32_forward_at_batched_shapes_on_cuda(full_f32, rows, sq, d):
    """The f32 forward at the f32 paths' batched shapes (B.H 64, 96, 128:
    EDICT's 2 and 3 rows, EF's 2 and 4, the instruction editors' 3, each at
    4 images) against its plain version in full f32, to the bounds above."""
    q, k, v, _ = _f32_inputs(full_f32, rows, sq, sq, d, True)
    out, lse = tflash.flash_attention_fwd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    want, lse_want = tflash.flash_attention_reference(q, k, v, d ** -0.5)
    assert ((out - want).abs().max() / want.abs().max()).item() <= 2e-5
    assert (lse - lse_want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("sk,d", [(4096, 40), (1000, 80), (77, 40), (330, 128)])
def test_f32_split_matches_plain_on_cuda(cuda_device, sk, d):
    """The f32 forward's split pass (K and V^T, hi and lo, in tiles, zero past
    Sk) against its plain version, bit for bit."""
    _, k, v, _ = _f32_inputs(cuda_device, 2, 1, sk, d, True)
    got = tflash.flash_attention_fwd_f32_split(k, v)
    assert torch.equal(got, tflash.flash_attention_fwd_f32_split_reference(k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,d", [(4096, 40), (1024, 80)])
def test_f32_forward_repeats_and_is_batch_independent_on_cuda(full_f32, sq, d):
    """The f32 forward repeats bit for bit; batch row 3 of an 8-row call (B.H
    64) equals a call on that row alone (B.H 8), and, where d allows both
    tiles, 64 and 128 query rows per CTA give the same bits: no atomics, and
    a row's sums do not depend on the grid."""
    q, k, v, _ = _f32_inputs(full_f32, 8, sq, sq, d, True)
    scale = d ** -0.5
    out, lse = tflash.flash_attention_fwd(q, k, v, scale)
    again = tflash.flash_attention_fwd(q, k, v, scale)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    one = [x[3:4] for x in (q, k, v)]
    small = tflash.flash_attention_fwd(*one, scale)
    assert torch.equal(small[0], out[3:4]) and torch.equal(small[1], lse[3:4])
    if d <= tflash.F32_WIDE_TILE_MAX_D:
        rows64, rows128 = (tflash._launch_fwd_f32(*one, scale, r) for r in (64, 128))
        assert torch.equal(rows64[0], rows128[0]) and torch.equal(rows64[1], rows128[1])


@pytest.mark.cuda
def test_f32_forward_refuses_a_tile_that_does_not_fit_on_cuda(full_f32):
    """128 query rows per CTA exist only up to F32_WIDE_TILE_MAX_D; asked for more, the
    C entry refuses before launching and the wrapper raises."""
    q, k, v, _ = _f32_inputs(full_f32, 1, 256, 256, 80, False)
    assert tflash.fwd_f32_smem_bytes(128, 80) == -1 and tflash.fwd_f32_smem_bytes(64, 80) > 0
    with pytest.raises(RuntimeError, match="f32 flash kernel launch failed"):
        tflash._launch_fwd_f32(q, k, v, 0.1, 128)


@pytest.mark.cuda
def test_edict_p2p_unet_call_on_cuda(cuda_device):
    """One f32 SD1.4 UNet call (a bf16 pipeline's UNet on f32 inputs) at 2 images x 3
    rows [uncond, base, edit] under EDICT's takeover: each image's uncond
    and base rows come out as the uncontrolled call's, bit for bit (the
    takeover writes only the edit row), the edit rows move, and only the f32
    forward runs, at every flash site."""
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.control.base import NO_CONTROL
    from pnpinversion_tpu_torch.control.edict_p2p import EdictP2PControl, make_edict_p2p_tensors
    from pnpinversion_tpu_torch.control.p2p import stack_tensors
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        pipe = SDPipeline.create(SD14, device="cuda")
        unet = pipe.unet
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        gen = torch.Generator(device=cuda_device).manual_seed(6)
        x = torch.randn((2, 1, 64, 64, 4), generator=gen, device=cuda_device).expand(
            -1, 3, -1, -1, -1).reshape(6, 64, 64, 4)
        pairs = [("a cat on a mat", "a dog on a mat"), ("a red car", "a blue car")]
        ctx = torch.cat([pipe.encode_prompt(["", *p]) for p in pairs])
        tensors = stack_tensors([make_edict_p2p_tensors(*p, pipe.tokenizer, device=cuda_device)
                                 for p in pairs])
        eps = {}
        for name, control in (("plain", NO_CONTROL), ("edict", EdictP2PControl())):
            before = tflash.flash_attention_fwd_f32.launches, tflash.flash_attention_fwd.launches
            with torch.inference_mode():
                eps[name], _ = unet(x, 500, ctx, control, tensors, {}, 0)
            torch.cuda.synchronize()
            assert (tflash.flash_attention_fwd_f32.launches - before[0],
                    tflash.flash_attention_fwd.launches - before[1]) == (10, 0)
            assert eps[name].dtype == torch.float32 and torch.isfinite(eps[name]).all()
        kept, edited = [0, 1, 3, 4], [2, 5]
        assert torch.equal(eps["edict"][kept], eps["plain"][kept])
        assert all(not torch.equal(eps["edict"][r], eps["plain"][r]) for r in edited)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,dkv", [(4096, 40, False), (4096, 40, True), (1000, 80, False),
                                     (1000, 80, True), (77, 40, True), (330, 128, False),
                                     (330, 128, True)])
def test_f32_bwd_split_matches_plain_on_cuda(cuda_device, s, d, dkv):
    """The f32 backward's split passes (the dQ kernel's K, V and K^T; the
    dK/dV kernel's Q, dO, Q^T, dO^T, LSE and delta; hi and lo, in tiles,
    zero and +inf past the sequence) against their plain versions, bit for
    bit."""
    x, _, _, y = _f32_inputs(cuda_device, 2, s, s, d, True)
    stats = ()
    if dkv:
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        stats = tuple(torch.randn((2, 8, s), generator=gen, device=cuda_device) for _ in range(2))
    got = tflash.flash_attention_bwd_f32_split(x, y, *stats)
    assert torch.equal(got, tflash.flash_attention_bwd_f32_split_reference(x, y, *stats))


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(4096, 40), (1024, 80)])
def test_f32_backward_repeats_and_is_batch_independent_on_cuda(full_f32, s, d):
    """The f32 backward repeats bit for bit; batch row 1 of a 2-row call
    (B.H 16) equals a call on that row alone (B.H 8), and, where d allows
    both tiles, 64 and 128 rows per CTA give the same bits: no atomics, and
    a row's sums do not depend on the grid."""
    q, k, v, do = _f32_inputs(full_f32, 2, s, s, d, True)
    scale = d ** -0.5
    out, lse = tflash.flash_attention_fwd(q, k, v, scale)
    grads = tflash.flash_attention_bwd(q, k, v, out, lse, do, scale)
    again = tflash.flash_attention_bwd(q, k, v, out, lse, do, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    one = [x[1:2] for x in (q, k, v, out, lse, do)]
    small = tflash.flash_attention_bwd(*one, scale)
    assert all(torch.equal(a[1:2], b) for a, b in zip(grads, small))
    q1, k1, v1, o1, lse1, do1 = one
    delta = (do1 * o1).sum(-1).contiguous()
    for kernel in ("dq", "dkv"):
        if d <= tflash.F32_BWD_WIDE_TILE_MAX_D[kernel]:
            r64, r128 = (tflash._launch_bwd_f32(q1, k1, v1, do1, lse1, delta, scale,
                                                kernel == "dq", r) for r in (64, 128))
            if kernel == "dq":
                r64, r128 = (r64,), (r128,)
            assert all(torch.equal(a, b) for a, b in zip(r64, r128))


@pytest.mark.cuda
def test_f32_backward_refuses_a_tile_that_does_not_fit_on_cuda(full_f32):
    """128 rows per CTA exist only up to F32_BWD_WIDE_TILE_MAX_D; asked for
    more, the C entry refuses before launching and the wrapper raises."""
    q, k, v, do = _f32_inputs(full_f32, 1, 256, 256, 80, False)
    lse = torch.zeros((1, 8, 256), device=full_f32)
    for kernel in ("dq", "dkv"):
        assert tflash.bwd_f32_smem_bytes(kernel, 128, 80) == -1
        assert tflash.bwd_f32_smem_bytes(kernel, 64, 80) > 0
        with pytest.raises(RuntimeError, match="f32 dQ" if kernel == "dq" else "f32 dK/dV"):
            tflash._launch_bwd_f32(q, k, v, do, lse, lse, 0.1, kernel == "dq", 128)
