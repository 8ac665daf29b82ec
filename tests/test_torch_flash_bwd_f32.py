"""The f32 flash backward's 3xTF32 design, checked on the CPU: the split
passes' plain versions (TF32 halves, tiles, the transposed tiles' order, LSE
and delta past the edge), the register mapping that lets dS and P^T/dS^T
feed the next product unshuffled, an emulation of the two kernels'
arithmetic from the split operands against float64 gradients and the JAX
package's Pallas backward kernels, and the tile rules. The kernels run only
on the card (tests/test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import rel_err  # also caps torch's CPU threads
from pnpinversion_tpu.ops.flash_attention import flash_attention as jax_flash
from pnpinversion_tpu_torch.ops import flash_attention as tflash
from test_torch_flash_f32 import _a_fragment_tile, _from_core_matrices, _tf32

H100_SMS = 132
SMEM_LIMIT = 232448  # an H100 block's dynamic shared memory


def _inputs(seed, b, h, sq, sk, d):
    """q, k, v, dO as f32 tensors from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
            for s in (sq, sk, sk, sq)]


def _unsplit(tiles: torch.Tensor, d: int, dkv: bool):
    """The arrays of the backward split pass's output, each (B*H, n * T, D)
    with the tiles, the core-matrix order and the transposed tiles' position
    order undone: X hi, X lo, Y hi, Y lo, X^T hi, X^T lo (as rows), and for
    the dK/dV split Y^T hi, Y^T lo, then LSE and delta, each (B*H, n * T)."""
    bh, n, _ = tiles.shape
    t = tflash.bwd_f32_tile_queries(d) if dkv else tflash.bwd_f32_tile_keys(d)
    inv = [tflash.F32_KEY_PERM.index(j) for j in range(8)]
    out = []
    for i in range(8 if dkv else 6):
        x = tiles[:, :, i * t * d:(i + 1) * t * d]
        if i < 4:
            x = _from_core_matrices(x, t, d)
        else:
            x = _from_core_matrices(x, d, t).transpose(-1, -2)
            x = x.reshape(bh, n, t // 8, 8, d)[:, :, :, inv].reshape(bh, n, t, d)
        out.append(x.reshape(bh, n * t, d))
    if dkv:
        stats = tiles[:, :, 8 * t * d:]
        out.extend((stats[:, :, :t].reshape(bh, n * t), stats[:, :, t:].reshape(bh, n * t)))
    return out


@pytest.mark.parametrize("s,d,dkv", [(200, 40, False), (1024, 80, False), (77, 128, False),
                                     (300, 40, True), (1000, 80, True), (70, 128, True),
                                     (64, 16, True)])
def test_split_reference_inverts_to_rows_and_transposed(s, d, dkv):
    """The dQ kernel's split (x = K, y = V) and the dK/dV kernel's (x = Q,
    y = dO, with LSE and delta) invert to X and Y as rows and X^T (and Y^T)
    as transposed tiles: hi has its low 13 mantissa bits zero and hi + lo ==
    x exactly, positions past S are zero, and the dK/dV tiles carry LSE
    (+inf past S) and delta (0 past S)."""
    x, y = _inputs(s + d, 2, 3, s, s, d)[:2]
    lse, delta = (torch.from_numpy(np.random.RandomState(s).randn(2, 3, s).astype(np.float32))
                  for _ in range(2))
    t = tflash.bwd_f32_tile_queries(d) if dkv else tflash.bwd_f32_tile_keys(d)
    n = -(-s // t)
    tiles = (tflash.flash_attention_bwd_f32_split(x, y, lse, delta) if dkv
             else tflash.flash_attention_bwd_f32_split(x, y))
    assert tiles.shape == (6, n, (8 * t * d + 2 * t) if dkv else 6 * t * d)
    arrays = _unsplit(tiles, d, dkv)
    pairs = [(x, 0), (y, 2), (x, 4)] + ([(y, 6)] if dkv else [])
    for src, i in pairs:
        hi, lo = arrays[i], arrays[i + 1]
        want = src.reshape(6, s, d)
        assert not (hi.view(torch.int32) & 0x1FFF).any()
        assert torch.equal(hi[:, :s] + lo[:, :s], want)
        assert not hi[:, s:].any() and not lo[:, s:].any()
    if dkv:
        got_lse, got_delta = arrays[8], arrays[9]
        assert torch.equal(got_lse[:, :s], lse.reshape(6, s))
        assert torch.equal(got_delta[:, :s], delta.reshape(6, s))
        assert torch.isposinf(got_lse[:, s:]).all() and not got_delta[:, s:].any()


@pytest.mark.parametrize("kernel,operand", [("dq", "k"), ("dkv", "do"), ("dkv", "q")])
@pytest.mark.parametrize("perm,same", [(tflash.F32_KEY_PERM, True), (tuple(range(8)), False)])
def test_accumulators_feed_the_next_product_as_a_fragment(kernel, operand, perm, same):
    """An accumulator passed unshuffled as the TF32 A fragment times the
    transposed tile of the split pass gives the product: dS (64 queries x
    T keys) times K^T for dQ; P^T and dS^T (64 keys x T queries) times dO^T
    and Q^T for dV and dK. With the positions of each group in their own
    order it does not."""
    rng = np.random.RandomState(7)
    d = 40
    t = tflash.bwd_f32_tile_keys(d) if kernel == "dq" else tflash.bwd_f32_tile_queries(d)
    acc = torch.from_numpy(rng.randn(64, t))
    x = torch.from_numpy(rng.randn(t, d))
    a = _a_fragment_tile(acc)
    assert not torch.isnan(a).any()
    x_slots = x.reshape(t // 8, 8, d)[:, list(perm)].reshape(t, d)
    assert torch.allclose(a @ x_slots, acc @ x, rtol=0, atol=1e-12) == same
    if same:  # and the split pass's plain version stores the tile in that order
        zero = torch.zeros(1, 1, t, d, dtype=torch.float32)
        xf = x.float()[None, None]
        if kernel == "dq":  # x = K: K^T is array 4
            tiles, index = tflash.flash_attention_bwd_f32_split(xf, zero), 4
        else:  # Q^T is array 4 (x = Q), dO^T array 6 (y = dO)
            stats = torch.zeros(1, 1, t)
            args = (xf, zero) if operand == "q" else (zero, xf)
            tiles = tflash.flash_attention_bwd_f32_split(*args, stats, stats)
            index = 4 if operand == "q" else 6
        hi = _from_core_matrices(tiles[0, 0, index * t * d:(index + 1) * t * d], d, t)
        assert torch.equal(hi.T, tflash.tf32_split(x_slots.float())[0])


def _three(a_hi, a_lo, b_hi, b_lo):
    """a @ b^T from split operands in float64: hi lo + lo hi + hi hi, lo read
    as TF32 reads it, lo lo dropped."""
    a_lo, b_lo = _tf32(a_lo.float()).double(), _tf32(b_lo.float()).double()
    b_hi_t, b_lo_t = b_hi.transpose(-1, -2), b_lo.transpose(-1, -2)
    return a_hi @ b_lo_t + a_lo @ b_hi_t + a_hi @ b_hi_t


def _split64(x: torch.Tensor):
    hi, lo = tflash.tf32_split(x.float())
    return hi.double(), lo.double()


def emulate_bwd(q, k, v, do, lse, delta, scale):
    """The two kernels' arithmetic in float64 from the split passes'
    operands: the dQ kernel over key tiles of ``bwd_f32_tile_keys(d)`` (S and
    dP from zero each tile and rounded to f32, P of keys past Sk zero, dS
    split, dQ in one accumulator over all tiles), the dK/dV kernel over query
    tiles of ``bwd_f32_tile_queries(d)`` (S^T and dP^T, P^T from the tiles'
    LSE, whose +inf past Sq makes those queries' P^T and dS^T 0, dV and dK in
    one accumulator each). Q and dO (dQ), K and V (dK/dV) are split as the
    kernels split them. (dQ, dK, dV) in f32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    log2e = np.log2(np.e)
    scale_log2 = np.float32(scale * np.float32(log2e))
    k_hi, k_lo, v_hi, v_lo, kt_hi, kt_lo = (
        x.double().reshape(b, h, -1, d)
        for x in _unsplit(tflash.flash_attention_bwd_f32_split(k, v), d, False))
    q_hi, q_lo, do_hi, do_lo, qt_hi, qt_lo, dot_hi, dot_lo, lse_t, delta_t = (
        x.double().reshape(b, h, -1, *x.shape[2:])
        for x in _unsplit(tflash.flash_attention_bwd_f32_split(q, do, lse, delta), d, True))

    def probs(s, lse2):  # exp2(s scale log2(e) - LSE log2(e)) in f32
        return torch.exp2(s.float() * scale_log2 - lse2.float()).double()

    # dQ: rows are queries, tiles of keys
    kt = tflash.bwd_f32_tile_keys(d)
    qs_hi, qs_lo = _split64(q)
    dos_hi, dos_lo = _split64(do)
    lse2 = (lse.float() * np.float32(log2e))[..., None]
    dq = torch.zeros(b, h, sq, d, dtype=torch.float64)
    for j in range(0, k_hi.shape[2], kt):
        c = slice(j, j + kt)
        s = _three(qs_hi, qs_lo, k_hi[:, :, c], k_lo[:, :, c]).float()
        dp = _three(dos_hi, dos_lo, v_hi[:, :, c], v_lo[:, :, c]).float()
        p = probs(s, lse2)
        p[..., torch.arange(j, j + kt) >= sk] = 0.0
        ds_hi, ds_lo = _split64((p.float() * (dp - delta.float()[..., None])).float())
        dq += _three(ds_hi, ds_lo, kt_hi[:, :, c].transpose(-1, -2),
                     kt_lo[:, :, c].transpose(-1, -2))
    # dK/dV: rows are keys, tiles of queries
    qt = tflash.bwd_f32_tile_queries(d)
    ks_hi, ks_lo = _split64(k)
    vs_hi, vs_lo = _split64(v)
    dk = torch.zeros(b, h, sk, d, dtype=torch.float64)
    dv = torch.zeros(b, h, sk, d, dtype=torch.float64)
    for j in range(0, q_hi.shape[2], qt):
        c = slice(j, j + qt)
        st = _three(ks_hi, ks_lo, q_hi[:, :, c], q_lo[:, :, c]).float()
        dpt = _three(vs_hi, vs_lo, do_hi[:, :, c], do_lo[:, :, c]).float()
        pt = probs(st, (lse_t[:, :, c].float() * np.float32(log2e))[..., None, :])
        dst = (pt.float() * (dpt - delta_t[:, :, c].float()[..., None, :])).float()
        p_hi, p_lo = _split64(pt)
        ds_hi, ds_lo = _split64(dst)
        dv += _three(p_hi, p_lo, dot_hi[:, :, c].transpose(-1, -2),
                     dot_lo[:, :, c].transpose(-1, -2))
        dk += _three(ds_hi, ds_lo, qt_hi[:, :, c].transpose(-1, -2),
                     qt_lo[:, :, c].transpose(-1, -2))
    return (dq * scale).float(), (dk * scale).float(), dv.float()


def _plain64(q, k, v, do):
    """float64 (O, LSE) and (dQ, dK, dV) of the plain versions."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    out, lse = tflash.flash_attention_reference(q, k, v, q.shape[-1] ** -0.5)
    return out, lse, tflash.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                          q.shape[-1] ** -0.5)


@pytest.mark.parametrize("b,h,sq,sk,d", [(1, 2, 256, 256, 40), (1, 2, 192, 160, 80),
                                         (1, 1, 70, 77, 40), (1, 1, 100, 50, 128)])
def test_3xtf32_bwd_emulation_within_f32_tolerance(b, h, sq, sk, d):
    """The emulated 3xTF32 backward (the chosen tiles, one accumulator per
    output, positions past the edges masked) is within chip_smoke's
    F32_BWD_RTOL of float64 gradients; one TF32 product each misses it."""
    q, k, v, do = _inputs(d + sk, b, h, sq, sk, d)
    scale = d ** -0.5
    out, lse, want = _plain64(q, k, v, do)
    delta = (do.double() * out).sum(-1).float()
    got = emulate_bwd(q, k, v, do, lse.float(), delta, scale)
    for g, w in zip(got, want):
        assert rel_err(g.double(), w) <= chip_smoke.F32_BWD_RTOL
    # one TF32 product each (what plain TF32 would give) misses it
    t = [_tf32(x).double() for x in (q, k, v, do)]
    p = torch.exp(t[0] @ t[1].transpose(-1, -2) * scale - lse[..., None])
    ds = p * (t[3] @ t[2].transpose(-1, -2) - delta.double()[..., None])
    dq1 = _tf32(ds.float()).double() @ t[1] * scale
    assert rel_err(dq1, want[0]) > chip_smoke.F32_BWD_RTOL


def test_3xtf32_bwd_emulation_matches_pallas_interpret():
    """The emulated 3xTF32 backward against the JAX package's
    _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (jax.vjp of its
    flash_attention in interpret mode) on the same f32 inputs."""
    q, k, v, do = _inputs(12, 1, 2, 256, 256, 40)
    scale = 40 ** -0.5
    out, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, scale, block_q=128, block_k=128,
                                                  bwd_block_q=128, bwd_block_k=128,
                                                  interpret=True),
                       *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    o, lse = tflash.flash_attention_reference(q, k, v, scale)
    delta = (do * o).sum(-1)
    got = emulate_bwd(q, k, v, do, lse, delta, scale)
    for g, w in zip(got, want):
        assert rel_err(g.double(), torch.from_numpy(np.array(w)).double()) <= (
            chip_smoke.F32_BWD_RTOL)


def _smem(kernel, rows, d):
    """The kernels' dynamic shared memory, as the C side's Cfg computes it:
    each warpgroup's own rows (two inputs, hi and lo), two stages of the
    split tiles, 4 mbarriers, 128 bytes of alignment."""
    if kernel == "dq":
        stage = 6 * tflash.bwd_f32_tile_keys(d) * d * 4
    else:
        t = tflash.bwd_f32_tile_queries(d)
        stage = 8 * t * d * 4 + 2 * t * 4
    return 4 * rows * d * 4 + 2 * stage + 32 + 128


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_f32_bwd_tiles_fit(d):
    """The other side's tile depends on d alone (a row's sums must not
    depend on the batch or the rows per CTA), a multiple of 8 that every
    wgmma width covers, and every instantiation the rules can pick fits in
    an H100 block's shared memory; two warpgroups stop where they would not."""
    for kernel in ("dq", "dkv"):
        t = tflash.bwd_f32_tile_keys(d) if kernel == "dq" else tflash.bwd_f32_tile_queries(d)
        assert t in (8, 16, 32, 64)
        rows = {tflash.bwd_f32_tile_rows(kernel, bh, s, d, H100_SMS)
                for bh in (8, 16, 64, 128) for s in (77, 1024, 4096)}
        assert rows <= ({64, 128} if d <= tflash.F32_BWD_WIDE_TILE_MAX_D[kernel] else {64})
        for r in rows:
            assert _smem(kernel, r, d) <= SMEM_LIMIT
    if d == 48:  # past the dQ kernel's limit, two warpgroups' rows do not fit
        assert _smem("dq", 128, d) > SMEM_LIMIT


@pytest.mark.parametrize("kernel,bh,s,d,rows", [
    ("dq", 8, 4096, 40, 128),   # 1-row 64^2: 256 CTAs of 128 rows in two waves, 512 of 64 in four
    ("dkv", 8, 4096, 40, 128),
    ("dq", 8, 1024, 40, 64),    # 128 CTAs of 64 rows fill the card, 64 of 128 rows half of it
    ("dkv", 16, 1024, 48, 128),  # 128 CTAs of 128 rows in one wave, 256 of 64 in two
    ("dq", 16, 1024, 48, 64),   # past the dQ kernel's limit
    ("dkv", 8, 1024, 80, 64),   # the f32 null-text 32^2 site
    ("dq", 8, 1024, 80, 64),
])
def test_f32_bwd_tile_rule(kernel, bh, s, d, rows):
    """The f32 backward's rows per CTA: by waves as the forward's up to
    F32_BWD_WIDE_TILE_MAX_D, 64 past it."""
    assert tflash.bwd_f32_tile_rows(kernel, bh, s, d, H100_SMS) == rows


def test_split_wrapper_takes_lse_and_delta_together():
    """The dK/dV kernel's split needs both LSE and delta; one alone raises
    before anything runs, on any device."""
    x, y = _inputs(3, 1, 1, 40, 40, 16)[:2]
    with pytest.raises(ValueError, match="lse and delta"):
        tflash.flash_attention_bwd_f32_split(x, y, torch.zeros(1, 1, 40))
