"""The f32 flash forward's 3xTF32 design, checked on the CPU: the split
pass's plain version (TF32 halves, tiles, V^T's key order), an emulation of
the kernel's products from the split operands against float64 attention and
the JAX package's Pallas kernel, the register mapping that lets P's
accumulator feed the PV product unshuffled, and the tile rules. The kernel
itself runs only on the card (tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import rel_err  # also caps torch's CPU threads
from pnpinversion_tpu.ops.flash_attention import flash_attention as jax_flash
from pnpinversion_tpu_torch.ops import flash_attention as tflash

H100_SMS = 132
SMEM_LIMIT = 232448  # an H100 block's dynamic shared memory


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk)]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """What TF32 reads of an f32 operand: its top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _from_core_matrices(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """(..., R * K) in the f32 forward's core-matrix order (8x4 blocks, row
    groups outermost) -> (..., R, K)."""
    lead = x.shape[:-1]
    x = x.reshape(*lead, r // 8, c // 4, 8, 4).transpose(-3, -2)
    return x.reshape(*lead, r, c)


def _unsplit(kv: torch.Tensor, d: int):
    """(K hi, K lo, V hi, V lo), each (B*H, Sk, D), from the split pass's
    output, undoing the core-matrix order, the tiles and V^T's key order."""
    bh, n, _, _ = kv.shape
    kt = tflash.fwd_f32_tile_keys(d)
    inv = [tflash.F32_KEY_PERM.index(j) for j in range(8)]
    out = []
    for i in range(4):
        if i < 2:
            x = _from_core_matrices(kv[:, :, i], kt, d)
        else:
            x = _from_core_matrices(kv[:, :, i], d, kt).transpose(-1, -2)
            x = x.reshape(bh, n, kt // 8, 8, d)[:, :, :, inv].reshape(bh, n, kt, d)
        out.append(x.reshape(bh, n * kt, d))
    return out


@pytest.mark.parametrize("sk,d", [(200, 40), (1024, 80), (77, 128), (64, 16)])
def test_split_reference_halves_and_layout(sk, d):
    """hi has its low 13 mantissa bits zero and hi + lo == x exactly; the
    tiles, the core-matrix order and V^T's key order invert to K and V, and
    the keys past Sk are zero."""
    k, v = (torch.from_numpy(x) for x in _qkv(sk + d, 2, 3, 1, sk, d)[1:])
    kv = tflash.flash_attention_fwd_f32_split(k, v)
    kt = tflash.fwd_f32_tile_keys(d)
    n = -(-sk // kt)
    assert kv.shape == (6, n, 4, kt * d) and kv.dtype == torch.float32
    k_hi, k_lo, v_hi, v_lo = _unsplit(kv, d)
    for hi, lo, x in ((k_hi, k_lo, k), (v_hi, v_lo, v)):
        assert not (hi.view(torch.int32) & 0x1FFF).any()
        assert torch.equal(hi[:, :sk] + lo[:, :sk], x.reshape(6, sk, d))
        assert not hi[:, sk:].any() and not lo[:, sk:].any()
        assert (lo[:, :sk].abs() <= x.reshape(6, sk, d).abs() * 2.0 ** -11).all()


def test_split_reference_rounds_to_nearest_ties_away():
    """hi is cvt.rna.tf32.f32's rounding: to nearest, ties away from zero."""
    one_ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2.0 ** -23,
                      1 + 3 * one_ulp / 2], dtype=torch.float32)
    hi, lo = tflash.tf32_split(x)
    assert hi.tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp]
    assert torch.equal(hi + lo, x)


def _a_fragment_tile(p: torch.Tensor) -> torch.Tensor:
    """The 64 x KT A operand, in V^T's slot order, that the PV wgmmas read
    when each thread passes its P accumulator registers c0..c3 of a key group
    as a0..a3 = c0, c2, c1, c3. Accumulator: c0, c1 are (row g, keys 2t,
    2t + 1), c2, c3 (row g + 8, the same keys); TF32 A fragment: a0 (row g,
    slot t), a1 (row g + 8, slot t), a2 (row g, slot t + 4), a3 (row g + 8,
    slot t + 4); warp w holds rows 16 w .. 16 w + 15."""
    a = torch.full_like(p, float("nan"))
    for w in range(4):
        for g in range(8):
            for t in range(4):
                r0, r1 = 16 * w + g, 16 * w + g + 8
                for c in range(p.shape[1] // 8):
                    acc = [p[r0, 8 * c + 2 * t], p[r0, 8 * c + 2 * t + 1],
                           p[r1, 8 * c + 2 * t], p[r1, 8 * c + 2 * t + 1]]
                    frag = (acc[0], acc[2], acc[1], acc[3])
                    for (row, slot), val in zip(((r0, t), (r1, t), (r0, t + 4), (r1, t + 4)),
                                                frag):
                        a[row, 8 * c + slot] = val
    return a


@pytest.mark.parametrize("perm,same", [(tflash.F32_KEY_PERM, True),
                                       (tuple(range(8)), False)])
def test_key_permutation_feeds_accumulator_as_a_fragment(perm, same):
    """P's accumulator registers, passed unshuffled as the A fragment, times
    V^T with each group's keys in F32_KEY_PERM order (the split pass's
    layout) give P V; with the keys in their own order they do not."""
    rng = np.random.RandomState(3)
    kt, d = 64, 40
    p = torch.from_numpy(rng.rand(64, kt))
    v = torch.from_numpy(rng.randn(kt, d))
    a = _a_fragment_tile(p)
    assert not torch.isnan(a).any()
    v_slots = v.reshape(kt // 8, 8, d)[:, list(perm)].reshape(kt, d)
    got = a @ v_slots
    assert torch.allclose(got, p @ v, rtol=0, atol=1e-12) == same
    if same:  # and the split pass's plain version stores V^T in that order
        vt = tflash.flash_attention_fwd_f32_split(
            torch.zeros(1, 1, kt, d, dtype=torch.float32), v.float()[None, None])
        hi = _from_core_matrices(vt[0, 0, 2], d, kt).double()
        assert torch.equal(hi.T, tflash.tf32_split(v_slots.float())[0].double())


def emulate_3xtf32(q, k, v, scale):
    """The kernel's arithmetic in float64 from its split operands: S from
    Q_hi K_lo + Q_lo K_hi + Q_hi K_hi (lo read as TF32 reads it, lo lo
    dropped), online softmax by tiles of ``fwd_f32_tile_keys(d)`` keys, each
    tile's P split into hi and lo and P V taken the same way from zero, added
    to the running O (two-level accumulation). (O, LSE) in f32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kt = tflash.fwd_f32_tile_keys(d)
    k_hi, k_lo, v_hi, v_lo = (x.double().reshape(b, h, -1, d)
                              for x in _unsplit(tflash.flash_attention_fwd_f32_split(k, v), d))
    q_hi, q_lo = tflash.tf32_split(q)
    q_hi, q_lo = q_hi.double(), _tf32(q_lo).double()
    k_lo, v_lo = _tf32(k_lo.float()).double(), _tf32(v_lo.float()).double()
    m = torch.full((b, h, sq, 1), -torch.inf, dtype=torch.float64)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float64)
    o = torch.zeros((b, h, sq, d), dtype=torch.float64)
    for j in range(0, sk, kt):
        cols = slice(j, min(j + kt, sk))
        s = (q_hi @ k_lo[:, :, cols].transpose(-1, -2) + q_lo @ k_hi[:, :, cols].transpose(-1, -2)
             + q_hi @ k_hi[:, :, cols].transpose(-1, -2)).float().double() * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new).float()
        p_hi, p_lo = tflash.tf32_split(p)
        p_hi, p_lo = p_hi.double(), _tf32(p_lo).double()
        tile = (p_hi @ v_lo[:, :, cols] + p_lo @ v_hi[:, :, cols]
                + p_hi @ v_hi[:, :, cols]).float().double()
        o = o * alpha + tile
        l = l * alpha + p.double().sum(-1, keepdim=True)
        m = m_new
    return (o / l).float(), (m + torch.log(l))[..., 0].float()


@pytest.mark.parametrize("b,h,sq,sk,d", [(1, 2, 256, 256, 40), (1, 2, 192, 300, 80),
                                         (1, 1, 70, 77, 40)])
def test_3xtf32_emulation_within_f32_tolerances(b, h, sq, sk, d):
    """The emulated 3xTF32 forward is within chip_smoke's f32 tolerances
    (O relative to max |O|, LSE absolute) of float64 attention."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(d + sk, b, h, sq, sk, d))
    scale = d ** -0.5
    o, lse = emulate_3xtf32(q, k, v, scale)
    o64, lse64 = tflash.flash_attention_reference(q.double(), k.double(), v.double(), scale)
    assert rel_err(o.double(), o64) <= chip_smoke.F32_O_RTOL
    assert (lse.double() - lse64).abs().max().item() <= chip_smoke.F32_LSE_ATOL
    # one TF32 product each (what plain TF32 would give) misses them
    s1 = (_tf32(q).double() @ _tf32(k).double().transpose(-1, -2)) * scale
    o1 = torch.softmax(s1, -1).float()
    o1 = _tf32(o1).double() @ _tf32(v).double()
    assert rel_err(o1, o64) > chip_smoke.F32_O_RTOL


def test_3xtf32_emulation_matches_pallas_interpret():
    """The emulated 3xTF32 forward against the JAX package's _flash_kernel in
    interpret mode on the same f32 inputs."""
    q, k, v = _qkv(11, 1, 2, 256, 256, 40)
    scale = 40 ** -0.5
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                block_q=128, block_k=128, interpret=True))
    o, _ = emulate_3xtf32(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    np.testing.assert_allclose(o.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("bh,sq,d,rows", [
    (8, 4096, 40, 128),   # 1-row 64^2: 256 CTAs of 128 rows in two waves, 512 of 64 in four
    (8, 1024, 40, 64),    # 128 CTAs of 64 rows fill the card, 64 of 128 rows half of it
    (16, 1024, 56, 128),  # 128 CTAs of 128 rows in one wave, 256 of 64 in two
    (16, 1024, 64, 64),   # past F32_WIDE_TILE_MAX_D: 64 rows whatever the waves
    (8, 1024, 80, 64),    # d = 80: a 128-row Q tile and two stages do not fit
    (64, 1024, 80, 64),
    (128, 4096, 128, 64),
])
def test_f32_forward_tile_rule(bh, sq, d, rows):
    """The f32 forward's query rows per CTA: by waves as the bf16 forward's
    up to F32_WIDE_TILE_MAX_D, 64 past it."""
    assert tflash.fwd_f32_tile_rows(bh, sq, d, H100_SMS) == rows


def _smem(rows, d):
    """The main kernel's dynamic shared memory, as Cfg computes it: Q hi/lo
    per warpgroup, two stages of K hi/lo and V^T hi/lo, 4 mbarriers, 128
    bytes of alignment."""
    kt = tflash.fwd_f32_tile_keys(d)
    return 2 * rows * d * 4 + 2 * 4 * kt * d * 4 + 32 + 128


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_f32_forward_tiles_fit(d):
    """Keys per stage depend on d alone (a row's sums must not depend on the
    rows per CTA), and every tile the rules can pick fits in an H100 block's
    shared memory; d = 40 at 64 rows leaves room for two CTAs an SM."""
    kt = tflash.fwd_f32_tile_keys(d)
    assert kt in (32, 64) and kt % 8 == 0
    rows = {tflash.fwd_f32_tile_rows(bh, s, d, H100_SMS)
            for bh in (8, 16, 64, 128) for s in (1024, 4096)}
    for r in rows:
        assert _smem(r, d) <= SMEM_LIMIT
    if d <= 40:
        assert 2 * (_smem(64, d) + 1024) <= 233472
