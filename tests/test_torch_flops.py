"""The port's FLOP count (``pnpinversion_tpu_torch/utils/flops.py``) against
the JAX package's (``scripts/_flops.py``), one call of each model at SD1.4
width, and the flash formula against the plain path's products.

Nothing here loads weights or compiles a JAX program: the JAX side is traced
(``jax.make_jaxpr``) on ``jax.eval_shape`` parameters and the port runs on
the ``meta`` device (shapes only). The counts differ by the amounts
``_torch_flops.py`` names; each test computes them and holds the rest equal.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_flops import (EDIT_KW, PROMPTS, REL, REPO, group_norm_dots, jax_count, rel,
                          self_replace_flops)
from pnpinversion_tpu_torch.utils import flops, mfu


# ---------------------------------------------------------------------------
# one call of each model at SD1.4 width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd14():
    """(JAX SD1.4 parameter shapes, the port's SD1.4 modules on meta)."""
    from pnpinversion_tpu.configs import SD14 as JSD14
    from pnpinversion_tpu.models.clip_text import init_clip_text_params
    from pnpinversion_tpu.models.unet import init_unet_params
    from pnpinversion_tpu.models.vae import init_vae_params
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
    from pnpinversion_tpu_torch.models.unet import UNet
    from pnpinversion_tpu_torch.models.vae import VAE

    key = jax.random.PRNGKey(0)
    shapes = {"unet": jax.eval_shape(lambda k: init_unet_params(k, JSD14.unet), key),
              "vae": jax.eval_shape(lambda k: init_vae_params(k, JSD14.vae), key),
              "text": jax.eval_shape(lambda k: init_clip_text_params(k, JSD14.text), key)}
    with torch.device("meta"):
        modules = {"unet": UNet(SD14.unet), "vae": VAE(SD14.vae),
                   "text": CLIPTextModel(SD14.text)}
    return JSD14, shapes, SD14, modules


def _p2p(package: str, cfg, steps: int = 50):
    """(control, tensors, state) of the main path's scan at ``steps`` steps
    in either package: the cake edit's refine + LocalBlend + reweight
    controller on the source-free 3-row layout. The JAX state is built
    inside the traced function (``init_state`` calls ``jnp.zeros``)."""
    kw = dict(num_steps=steps, cross_replace_steps=0.4, self_replace_steps=0.6,
              is_replace_controller=False, blend_words=EDIT_KW["blend_word"],
              eq_params=EDIT_KW["eq_params"], latent_size=cfg.unet.sample_size)
    if package == "jax":
        from pnpinversion_tpu.control.p2p import P2PControl, make_p2p_control
        from pnpinversion_tpu.models.unet import lb_resolution, num_lb_slots
        from pnpinversion_tpu.utils.tokenizer import default_tokenizer

        ctrl, tensors = make_p2p_control(list(PROMPTS), default_tokenizer(),
                                         num_lb_slots=num_lb_slots(cfg.unet),
                                         lb_res=lb_resolution(cfg.unet), **kw)
        return P2PControl(dataclasses.replace(ctrl.spec, uncond_rows=1)), tensors, None
    from pnpinversion_tpu_torch.control.p2p import P2PControl, make_p2p_control, stack_tensors
    from pnpinversion_tpu_torch.models.unet import lb_resolution, num_lb_slots
    from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

    ctrl, tensors = make_p2p_control(list(PROMPTS), default_tokenizer(), device="meta",
                                     num_lb_slots=num_lb_slots(cfg.unet),
                                     lb_res=lb_resolution(cfg.unet), **kw)
    control = P2PControl(dataclasses.replace(ctrl.spec, uncond_rows=1))
    return control, stack_tensors([tensors]), control.init_state(2, heads=cfg.unet.num_heads,
                                                                 device="meta")


_JAX_UNET = {}


def _jax_unet(jcfg, shapes, rows: int, p2p: bool) -> float:
    """The JAX count of one SD1.4 UNet call (traced once per module)."""
    if (rows, p2p) not in _JAX_UNET:
        _JAX_UNET[rows, p2p] = _trace_jax_unet(jcfg, shapes, rows, p2p)
    return _JAX_UNET[rows, p2p]


def _trace_jax_unet(jcfg, shapes, rows: int, p2p: bool) -> float:
    from pnpinversion_tpu.models.unet import unet_apply

    x = jax.ShapeDtypeStruct((rows, 64, 64, 4), jnp.float32)
    ctx = jax.ShapeDtypeStruct((rows, 77, jcfg.unet.context_dim), jnp.float32)
    if not p2p:
        return jax_count(lambda p, x, c: unet_apply(p, x, jnp.float32(981.0), c, jcfg.unet)[0],
                         shapes["unet"], x, ctx)
    control, tensors, _ = _p2p("jax", jcfg)

    def call(p, x, c, tensors):
        state = control.init_state(2, x.dtype, heads=jcfg.unet.num_heads)
        return unet_apply(p, x, jnp.float32(981.0), c, jcfg.unet, control, tensors, state,
                          jnp.int32(0))[0]

    return jax_count(call, shapes["unet"], x, ctx, tensors)


@pytest.mark.parametrize("rows,control", [(1, None), (3, None), (3, "p2p")])
def test_sd14_unet_call_matches_jax(sd14, rows, control):
    """One SD1.4 UNet call at a 64² latent: the inversion's 1 row, the scan's
    3 rows without and with the main path's P2P control (a step inside the
    self-replace window, which the JAX count always takes). The port's count
    plus the JAX GroupNorm's products is the JAX count exactly; the raw
    counts are within 1e-4."""
    jcfg, shapes, cfg, modules = sd14
    want = _jax_unet(jcfg, shapes, rows, control == "p2p")
    x = torch.empty(rows, 64, 64, 4, device="meta")
    ctx = torch.empty(rows, 77, cfg.unet.context_dim, device="meta")
    args = (x, 981, ctx)
    if control == "p2p":
        args += _p2p("torch", cfg) + (0,)
    with group_norm_dots() as gn, flops.FlopCounter() as fc:
        modules["unet"](*args)
    got = fc.count
    assert got.attention_fwd == got.attention_bwd == 0  # meta tensors take the plain path
    assert got.total + gn[0] == want
    assert rel(got.total, want) < REL
    if rows == 1 and control is None:
        # one 1-row call: 0.8032734 TF against JAX's 0.8032895 TF (the GroupNorm's 2.0e-5)
        assert round(got.total / 1e12, 7) == 0.8032734 and round(want / 1e12, 7) == 0.8032895


def test_sd14_scan_call_outside_the_window(sd14):
    """Outside the self-replace window the port's 3-row scan call skips the
    replace's products, which the JAX count takes on every step."""
    _, _, cfg, modules = sd14
    x = torch.empty(3, 64, 64, 4, device="meta")
    ctx = torch.empty(3, 77, cfg.unet.context_dim, device="meta")
    counts = []
    for step in (0, 40):  # the window is steps [0, 30) of 50
        with flops.FlopCounter() as fc:
            modules["unet"](x, 981, ctx, *_p2p("torch", cfg), step)
        counts.append(fc.count.total)
    assert counts[0] - counts[1] == self_replace_flops(cfg.unet) > 0


@pytest.mark.parametrize("part", ["encode", "decode", "text"])
def test_sd14_vae_and_text_tower_match_jax(sd14, part):
    """The VAE's encode of one 512² image, its decode of the main path's two
    latents, and the CLIP text tower on two prompts."""
    from pnpinversion_tpu.models.clip_text import clip_text_apply
    from pnpinversion_tpu.models.vae import vae_decode, vae_encode

    jcfg, shapes, cfg, modules = sd14
    if part == "encode":
        want = jax_count(lambda p, im: vae_encode(p, im, jcfg.vae), shapes["vae"],
                         jax.ShapeDtypeStruct((1, 512, 512, 3), jnp.float32))
        run = lambda: modules["vae"].encode(torch.empty(1, 512, 512, 3, device="meta"))
    elif part == "decode":
        want = jax_count(lambda p, z: vae_decode(p, z, jcfg.vae), shapes["vae"],
                         jax.ShapeDtypeStruct((2, 64, 64, 4), jnp.float32))
        run = lambda: modules["vae"].decode(torch.empty(2, 64, 64, 4, device="meta"))
    else:
        want = jax_count(lambda p, ids: clip_text_apply(p, ids, jcfg.text), shapes["text"],
                         jax.ShapeDtypeStruct((2, 77), jnp.int32))
        run = lambda: modules["text"](torch.zeros(2, 77, dtype=torch.int64, device="meta"))
    with group_norm_dots() as gn, flops.FlopCounter() as fc:
        run()
    assert fc.count.total + gn[0] == want
    assert rel(fc.count.total, want) < REL
    if part == "text":
        assert gn[0] == 0


def test_sd14_fused_scan_is_121_tf_not_51(sd14):
    """``scripts/mfu.py``'s docstring calls the 50-step fused scan "~51 TF".
    The JAX count of that program (``P2PEditor._fused_direct``, 3 rows a
    step) is 50 times its 3-row controlled call: 121.25 TF."""
    from pnpinversion_tpu.sampling.p2p_forward import fused_direct_inversion_edit_srcfree
    from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule

    jcfg, shapes, _, _ = sd14
    control, tensors, _ = _p2p("jax", jcfg)
    sched = make_ddim_schedule(50)
    d = jcfg.unet.context_dim
    scan = jax_count(
        lambda p, traj, c, u, t: fused_direct_inversion_edit_srcfree(
            p, sched, jcfg.unet, traj, c, u, jnp.float32(7.5), control, t),
        shapes["unet"], jax.ShapeDtypeStruct((51, 1, 64, 64, 4), jnp.float32),
        jax.ShapeDtypeStruct((2, 77, d), jnp.float32),
        jax.ShapeDtypeStruct((2, 77, d), jnp.float32), tensors)
    assert scan == 50 * _jax_unet(jcfg, shapes, 3, True)
    assert round(scan / 1e12, 2) == 121.25


# ---------------------------------------------------------------------------
# flash attention: the formula against the plain path's products
# ---------------------------------------------------------------------------

def _flash_shapes():
    sys.path.insert(0, REPO)
    import chip_smoke

    cases = {(c[1], c[2], c[3], c[4], c[5]) for c in chip_smoke.FLASH_CASES}
    bwd = {(c[1], c[2], c[3], c[4], c[5]) for c in chip_smoke.FLASH_BWD_CASES}
    return sorted(cases), sorted(bwd)


FLASH_SHAPES, FLASH_BWD_SHAPES = _flash_shapes()


def _kernel_stand_in(monkeypatch):
    """The kernel path on meta tensors: outputs of the kernel's shapes and
    no dispatched product, as a ctypes launch dispatches none."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    def fwd(q, k, v, scale):
        return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)

    def bwd(q, k, v, out, lse, do, scale):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)


def _attention_counts(path: str, shape, backward: bool) -> flops.FlopCount:
    from pnpinversion_tpu_torch.ops.attention import apply_probs, attention_probs
    from pnpinversion_tpu_torch.ops.flash_attention import flash_attention

    b, h, sq, sk, d = shape
    q = torch.empty(b, h, sq, d, device="meta", requires_grad=backward)
    k, v = (torch.empty(b, h, sk, d, device="meta", requires_grad=backward) for _ in "kv")
    with flops.FlopCounter() as fc:
        if path == "kernel":
            out = flash_attention(q, k, v, d ** -0.5)
        else:
            out = apply_probs(attention_probs(q, k, d ** -0.5), v)
        fwd = fc.count
        if backward:
            out.backward(torch.empty_like(out))
    return fwd, fc.count - fwd


def test_flash_formula_equals_the_plain_path_at_every_case(monkeypatch):
    """At every shape ``chip_smoke.py`` holds the forward kernel to
    (``FLASH_CASES``) the formula 4·B·H·Sq·Sk·d is the plain path's two
    products, and at every backward case (``FLASH_BWD_CASES``) 8·B·H·Sq·Sk·d
    is the four products of autograd's backward through it."""
    _kernel_stand_in(monkeypatch)
    for shape in FLASH_SHAPES:
        kernel, _ = _attention_counts("kernel", shape, backward=False)
        plain, _ = _attention_counts("plain", shape, backward=False)
        assert kernel.attention_fwd == plain.matmul == plain.total == kernel.total > 0, shape
    for shape in FLASH_BWD_SHAPES:
        _, kernel = _attention_counts("kernel", shape, backward=True)
        _, plain = _attention_counts("plain", shape, backward=True)
        assert kernel.attention_bwd == plain.matmul == plain.total == kernel.total > 0, shape


def test_flash_plain_version_is_not_counted_twice():
    """On CPU tensors ``FlashAttention`` runs the kernels' plain versions,
    whose products (the backward's five, P recomputed) are dropped for the
    formula: the count is the kernel path's and the plain path's."""
    from pnpinversion_tpu_torch.ops.attention import apply_probs, attention_probs
    from pnpinversion_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 256, 16, generator=gen, requires_grad=True) for _ in "qkv")
    with flops.FlopCounter() as fc:
        flash_attention(q, k, v, 0.25).sum().backward()
    with flops.FlopCounter() as plain:
        apply_probs(attention_probs(q, k, 0.25), v).sum().backward()
    n = 2 * 256 * 256 * 16
    assert fc.count == flops.FlopCount(attention_fwd=4.0 * n, attention_bwd=8.0 * n)
    assert plain.count.total == fc.count.total == 12.0 * n


def test_device_activity_unions_intervals_and_names_tensor_core_kernels():
    """Busy time is the union of the kernels' intervals (copies and memsets
    left out); tensor-core time the union of those named as tensor-core
    work, which a CUDA-core (FFMA) GEMM is not; the rest is sorted into
    kinds by name. Names as the H100's traces give them."""
    names = {
        "void (anonymous namespace)::flash_fwd_wgmma_kernel<2, 3>(Maps, Params)": "tensor_core",
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64":
            "tensor_core",
        "nvjet_tst_128x192_64x5_2x1_v_bz_coopB_bias_TNN": "tensor_core",
        "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_nn_align1>":
            "tensor_core",
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8_stage3_warpsize2x2x1_ffma":
            "cuda_core_gemm",
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>": "reduction_or_norm",
        "void (anonymous namespace)::flash_bwd_dq_convert_kernel<40>(Params)": "other",
        "void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float>>":
            "elementwise",
        "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, float, float>":
            "softmax",
    }
    assert {n: mfu.kernel_category(n) for n in names} == names
    assert {n: mfu.is_tensor_core(n) for n in names} == {
        n: cat == "tensor_core" for n, cat in names.items()}
    gemm, simt, red = list(names)[1], list(names)[4], list(names)[5]
    spans = [(gemm, 0.0, 10.0), (red, 5.0, 15.0), (gemm, 20.0, 30.0), (simt, 40.0, 50.0),
             ("Memcpy HtoD (Pageable -> Device)", 60.0, 70.0), (red, 22.0, 25.0)]
    act = mfu.device_activity(spans)
    assert act["busy_us"] == 15.0 + 10.0 + 10.0 and act["tensor_core_us"] == 20.0
    assert act["kernels"] == 5 and act["by_name"][gemm] == [20.0, 2, "tensor_core"]
    assert act["by_category"] == {"tensor_core": 20.0, "reduction_or_norm": 13.0,
                                  "cuda_core_gemm": 10.0}


def test_flop_counter_records_flash_shapes_and_counts_alone():
    """The counter keeps the (kind, B, H, Sq, Sk, d) of every entry into the
    flash kernel, and a second counter inside the first raises rather than
    count the same work twice."""
    from pnpinversion_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 128, 16, generator=gen, requires_grad=True)
    k, v = (torch.randn(2, 3, 80, 16, generator=gen, requires_grad=True) for _ in "kv")
    with flops.FlopCounter() as fc:
        flash_attention(q, k, v, 0.25).sum().backward()
        with pytest.raises(RuntimeError, match="already counting"):
            with flops.FlopCounter():
                pass
    assert fc.attention_shapes == {("fwd", 2, 3, 128, 80, 16), ("bwd", 2, 3, 128, 80, 16)}
    assert flops.count_flops(lambda: None)[1] == flops.FlopCount()  # the slot is free again
