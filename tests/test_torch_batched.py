"""The PyTorch port's batched editor (``parallel/sweep.py``) against its own
single-image editor, image by image, at TINY with 3 DDIM steps, f32 on the
CPU; the per-image early stop of null-text's Adam and the per-image ProxEdit
quantile; and the method strings: the editor dispatches every string the JAX
editor does to the same method with the same options, and the batched class
supports the same strings as the JAX one (neither JAX program is compiled)."""
import numpy as np
import pytest
import torch

from _torch_parity import assert_panels_close, rel_err, seeded_images
from pnpinversion_tpu.editors.p2p_editor import P2PEditor as JaxP2PEditor
from pnpinversion_tpu.parallel.sweep import BatchedDirectInversionP2P as JaxBatched
from pnpinversion_tpu_torch.configs import TINY
from pnpinversion_tpu_torch.control.p2p import P2PControl, stack_tensors
from pnpinversion_tpu_torch.editors.p2p_editor import GUIDANCE_GRID, P2PEditor
from pnpinversion_tpu_torch.inversion.ddim_inversion import null_text_optimization
from pnpinversion_tpu_torch.models.unet import apply_images
from pnpinversion_tpu_torch.parallel.sweep import (
    BatchedDirectInversionP2P,
    group_items_by_spec,
    pad_batch,
)
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.sampling.p2p_forward import proximal_guidance_forward

torch.set_num_threads(2)

STEPS = 3
INNER = 2  # null-text's Adam inner steps in both editors
G = 7.5
# per image: (source, target, blend words, reweighted word); both refine with
# LocalBlend and reweight, so one spec serves the batch
PROMPTS = [("a cat on a mat", "a silver cat on a mat", "cat", "silver"),
           ("a dog on a rug", "a red dog on a rug", "dog", "red")]
# one image alone vs in a batch of two: f32 summation-order noise, which
# Adam's update ~ lr * g / |g| turns into an embedding error of about lr times
# the gradient's relative error (as test_torch_nulltext.py's LOOP_RTOL)
LOOP_RTOL = 1e-4
PROX_KW = dict(proximal="l0", quantile=0.75, use_inversion_guidance=True, recon_lr=1.0,
               recon_t=400)


def _control_kw(i):
    _, _, word, eq = PROMPTS[i]
    return dict(blend_word=((word,), (word,)), eq_params={"words": (eq,), "values": (2.0,)})


@pytest.fixture(scope="module")
def pipe():
    return SDPipeline.create(TINY, seed=61, num_ddim_steps=STEPS, device="cpu")


def _single(editor, method, img, i):
    src, tar = PROMPTS[i][:2]
    kw = _control_kw(i)
    by_method = {
        "null-text-inversion+p2p": lambda: editor.edit_null_text(
            img, src, tar, num_inner_steps=INNER, **kw),
        "ablation_null-text-inversion_single_branch+p2p": lambda: editor.edit_null_text(
            img, src, tar, num_inner_steps=INNER, single_branch=True, **kw),
        "ablation_null-latent-inversion+p2p": lambda: editor.edit_null_latent(
            img, src, tar, num_inner_steps=INNER, **kw),
        "null-text-inversion+proximal-guidance": lambda: editor.edit_null_text_proximal(
            img, src, tar, num_inner_steps=INNER, **PROX_KW, **kw),
        "negative-prompt-inversion+proximal-guidance": lambda: editor(
            "negative-prompt-inversion+proximal-guidance", img, src, tar, **PROX_KW, **kw),
    }
    if method in by_method:
        return by_method[method]()
    if BatchedDirectInversionP2P.step_ablation_steps(method) is not None:
        method = "directinversion+p2p"
    return editor(method, img, src, tar, **kw)


METHODS = list(BatchedDirectInversionP2P.VARIANTS + BatchedDirectInversionP2P.ABLATIONS) + [
    "directinversion+p2p_guidance_25_5", "ablation_directinversion_interval_2+p2p",
    f"ablation_directinversion_step_{STEPS}+p2p"]


@pytest.mark.parametrize("method", METHODS)
def test_batched_matches_single_editor(pipe, method):
    """Two images with their own prompts and control tensors through one
    batched edit == each through the single-image editor: the recon and edit
    panels, within the JAX package's limit for its own batched path."""
    editor = P2PEditor(pipe)
    size = pipe.config.image_size
    imgs = seeded_images(63, 2, size)
    want = [_single(editor, method, imgs[i], i)[:, 2 * size:] for i in range(2)]

    specs, tensors, conds = [], [], []
    for i in range(2):
        spec, t = editor.make_control(list(PROMPTS[i][:2]), **_control_kw(i))
        specs.append(spec)
        tensors.append(t)
        conds.append(pipe.encode_prompt(list(PROMPTS[i][:2])))
    assert specs[0] == specs[1]
    cond = torch.stack(conds)
    if method.startswith("negative-prompt-inversion"):
        uncond = torch.stack([c[:1].expand(2, -1, -1) for c in conds])  # the fake uncond
    else:
        uncond = pipe.encode_prompt(["", ""])
    g = GUIDANCE_GRID[method.split("_")[-1]] if "_guidance_" in method else G
    recon, edit = BatchedDirectInversionP2P(pipe, num_inner_steps=INNER).edit_batch(
        specs[0], imgs, cond, uncond, g, stack_tensors(tensors), method=method)
    assert recon.shape == edit.shape == (2, size, size, 3) and edit.dtype == np.uint8
    for i in range(2):
        assert_panels_close(np.concatenate([recon[i], edit[i]], axis=1), want[i])


def test_batched_rejects_unsupported(pipe):
    with pytest.raises(NotImplementedError):
        BatchedDirectInversionP2P(pipe).edit_batch(None, np.zeros((1, 16, 16, 3), np.uint8),
                                                   None, None, G, {}, method="ddim+masactrl")


def test_null_text_stops_per_image(pipe):
    """Image 0's null-text losses (6-11 here) are under the threshold of 20
    from the first inner step on; image 1's targets are moved by 5 (losses
    29-32), so it never stops early. In one batch image 0 takes one Adam step
    per outer step and image 1 all of them, each as it does alone."""
    rng = np.random.RandomState(64)
    traj = torch.from_numpy(rng.randn(2, STEPS + 1, 1, 8, 8, 4).astype(np.float32))
    traj[1, :-1] += 5.0
    uncond, cond = (torch.from_numpy(rng.randn(2, 1, 77, 32).astype(np.float32))
                    for _ in range(2))

    def run(n, inner, sl=slice(None)):
        return null_text_optimization(pipe.unet, pipe.schedule, traj[sl], uncond[sl], cond[sl],
                                      G, num_inner_steps=inner, epsilon=20.0)

    batched = run(2, 5)
    alone = [run(1, 5, slice(i, i + 1))[0] for i in range(2)]
    one_step = [run(1, 1, slice(i, i + 1))[0] for i in range(2)]
    for i in range(2):
        assert rel_err(batched[i], alone[i]) <= LOOP_RTOL
    assert rel_err(batched[0], one_step[0]) <= LOOP_RTOL  # stopped after its first step
    assert rel_err(batched[1], one_step[1]) > 1e-2  # went on


def test_proximal_quantile_per_image(pipe):
    """ProxEdit's threshold is each image's own quantile of |delta|: two
    images whose deltas differ in scale give in one batch what each gives
    alone (a quantile over the batch would move both thresholds)."""
    rng = np.random.RandomState(65)
    x_t = torch.from_numpy(rng.randn(2, 1, 8, 8, 4).astype(np.float32))
    cond = torch.from_numpy(rng.randn(2, 2, 77, 32).astype(np.float32))
    cond[1] *= 4.0
    uncond = torch.from_numpy(rng.randn(2, 77, 32).astype(np.float32)).expand(2, -1, -1, -1)
    spec, tensors = P2PEditor(pipe).make_control(["a cat on a mat", "a silver cat on a mat"],
                                                 **_control_kw(0))
    control, one_image = P2PControl(spec), stack_tensors([tensors])
    with torch.inference_mode():
        t = pipe.schedule.timesteps[0]
        eps2, _ = apply_images(pipe.unet, x_t.expand(-1, 4, -1, -1, -1), t,
                               torch.cat([uncond, cond], 1))
        delta = (eps2[:, 2:] - eps2[:, :2]).abs().reshape(2, -1)
        q = torch.quantile(delta, 0.75, dim=1)
        assert q[1] > 1.5 * q[0]  # the thresholds differ
        kw = dict(edit_stage=True, prox="l0", quantile=0.75, recon_lr=1.0, recon_t=1000,
                  inversion_guidance=True, x_stars=x_t[:, None].expand(-1, STEPS + 1, -1, -1,
                                                                         -1, -1))
        args = (pipe.unet, pipe.schedule)
        both = proximal_guidance_forward(*args, x_t, cond, uncond, G, control,
                                         stack_tensors([tensors] * 2), **kw)
        for i in range(2):
            sl = slice(i, i + 1)
            one = proximal_guidance_forward(
                *args, x_t[sl], cond[sl], uncond[sl], G, control, one_image,
                **{**kw, "x_stars": kw["x_stars"][sl]})
            assert rel_err(both[i], one[0]) <= 1e-5


SUPPORT_STRINGS = list(JaxBatched.VARIANTS + JaxBatched.ABLATIONS) + [
    "directinversion+p2p_guidance_0_75", "directinversion+p2p_guidance_25_1",
    "ablation_directinversion_interval_5+p2p", "ablation_directinversion_step_20+p2p",
    "ablation_directinversion_step_x+p2p", "null-text-inversion+p2p_a800", "ddim+masactrl",
    "directinversion+masactrl", "directinversion+pnp", "ddim+pix2pix-zero", "edit-friendly+p2p",
    "directinversion+p2p_", "ablation_directinversion_step_20"]


@pytest.mark.parametrize("method", SUPPORT_STRINGS)
def test_supports_agrees_with_jax_class(method):
    assert BatchedDirectInversionP2P.supports(method) == JaxBatched.supports(method)
    assert (BatchedDirectInversionP2P.step_ablation_steps(method)
            == JaxBatched.step_ablation_steps(method))


EDITOR_METHODS = ("edit_ddim", "edit_null_text", "edit_negative_prompt",
                  "edit_null_text_proximal", "edit_direct_inversion", "edit_null_latent")
DISPATCH_STRINGS = [
    "ddim+p2p", "null-text-inversion+p2p", "null-text-inversion+p2p_a800",
    "null-text-inversion+p2p_3090", "ablation_null-text-inversion_single_branch+p2p",
    "negative-prompt-inversion+p2p", "negative-prompt-inversion+proximal-guidance",
    "null-text-inversion+proximal-guidance", "directinversion+p2p",
    *(f"directinversion+p2p_guidance_{i}_{f}" for i in GUIDANCE_GRID for f in ("0", "75")),
    "ablation_null-latent-inversion+p2p", "ablation_directinversion_08+p2p",
    "ablation_directinversion_04+p2p", "ablation_directinversion_interval_3+p2p",
    "ablation_directinversion_add-target+p2p", "ablation_directinversion_add-source+p2p"]


def _recorded_call(editor, method, **kw):
    calls = []
    for name in EDITOR_METHODS:
        setattr(editor, name, lambda *a, _name=name, **k: calls.append((_name, a, k)))
    editor(method, "image.jpg", "src", "tar", **kw)
    return calls


@pytest.mark.parametrize("method", DISPATCH_STRINGS)
def test_editor_dispatch_matches_jax(method):
    """Each method string reaches the same edit method with the same options
    in both editors (the editors' methods are replaced by recorders)."""
    kw = dict(guidance_scale=5.0, proximal="l1", quantile=0.6, npi_interp=0.25,
              use_inversion_guidance=True, blend_word=(("a",), ("b",)))
    got, want = (_recorded_call(e, method, **kw) for e in (P2PEditor(None), JaxP2PEditor(None)))
    assert len(got) == 1 and got == want


def test_unknown_method_raises_in_both():
    for editor in (P2PEditor(None), JaxP2PEditor(None)):
        with pytest.raises(NotImplementedError, match="No edit method named"):
            editor("ddim+masactrl", "image.jpg", "src", "tar")


def test_group_and_pad():
    items = [{"k": 1, "v": 0}, {"k": 2, "v": 1}, {"k": 1, "v": 2}]
    groups = group_items_by_spec(items, lambda it: it["k"])
    assert [[it["v"] for it in g] for g in groups.values()] == [[0, 2], [1]]
    batch, n = pad_batch([np.full((2,), i) for i in range(3)], 4)
    assert n == 3 and batch.shape == (4, 2) and (batch[3] == 2).all()


def test_stack_tensors(pipe):
    editor = P2PEditor(pipe)
    per_image = [editor.make_control(list(PROMPTS[i][:2]), **_control_kw(i))[1]
                 for i in range(2)]
    stacked = stack_tensors(per_image)
    assert sorted(stacked) == sorted(per_image[0])
    for k, v in stacked.items():
        assert v.shape == (2,) + per_image[0][k].shape
        assert torch.equal(v[1], per_image[1][k])
