"""A w8 directinversion+p2p and a null-text edit (``--quant w8``: the UNet's
weights int8, ``ops/quant.py``) through both packages' P2PEditor at TINY,
f32 on the CPU, on the same numpy weights; null-text's Adam runs through
the w8 UNet's backward. The rest of the mode is ``tests/test_torch_quant.py``."""
import jax
import numpy as np
import pytest

from _torch_parity import jax_torch_pipelines
from pnpinversion_tpu.ops import quant as jquant
from pnpinversion_tpu_torch.ops import quant

SRC, TAR = "a cat on a mat", "a silver cat on a mat"
P2P_KW = dict(blend_word=(("cat",), ("cat",)), eq_params={"words": ("silver",), "values": (2.0,)})


@pytest.fixture(scope="module")
def editors():
    """w8 P2P editors of both packages on the same weights (one JAX editor,
    so the programs the two methods share compile once)."""
    from pnpinversion_tpu.editors.p2p_editor import P2PEditor as JaxP2PEditor
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor

    jpipe, tpipe = jax_torch_pipelines(seed=11, steps=2)
    # JAX's function jitted, as its SDPipeline.create runs it
    jpipe.params = dict(jpipe.params,
                        unet=jax.jit(jquant.quantize_unet_dots)(jpipe.params["unet"]))
    quant.quantize_unet_dots(tpipe.unet)
    return JaxP2PEditor(jpipe), P2PEditor(tpipe)


@pytest.mark.parametrize("method", ["directinversion+p2p", "null-text-inversion+p2p"])
def test_w8_edits_match_jax(editors, method):
    """A w8 edit end to end through both packages' P2PEditor (null-text's
    Adam runs through the w8 UNet's backward): the strips within 2 uint8
    levels, the limit of the JAX package's own batched path."""
    jed, ted = editors
    img = (np.random.RandomState(12).rand(16, 16, 3) * 255).astype(np.uint8)
    want = np.asarray(jed(method, img, SRC, TAR, **P2P_KW))
    got = ted(method, img, SRC, TAR, **P2P_KW)
    assert got.shape == want.shape == (16, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[:, :32], want[:, :32])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
