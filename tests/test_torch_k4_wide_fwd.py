"""K4's forward kernels at head dims 80, 128 and 192
(``csrc/flash_attention.cu``), their schedules emulated in numpy and torch.

The kernels run only on a card (``chip_smoke.py: flash_cases`` holds them
against the plain twin there).  Here the same schedules are emulated on
the CPU and held against the JAX package:

* the f32 kernel (``fa_fwd_wide``): a block of 64 q rows walks the key
  range its rows see (all T when one of them sees none) in tiles of 64
  keys (D = 80, 128) or 48 (D = 192); the pair of warps that shares 16 rows
  computes S over its two halves of each tile in split TF32
  (``_tf32_matmul(..., "kernel")`` of ``tests/test_torch_kernel_bwd.py``),
  takes the common row max, forms P on each half and puts the halves
  together; each warp runs P.V over its half of the output columns, the
  tile's product summed from zero and then added in f32; ``l`` is
  summed per half and the halves added in the epilogue.  Held against
  the Pallas kernel in interpret mode through the GQA wrapper (``out``)
  and the plain twin's log-sum-exp (``lse``) at ``FA_TOL["float32"]``;
* the bf16 kernel (``flash_attention_tc_kernel``): the walk in tiles of
  128 keys (D = 80, 128) or 96 (D = 192) through ``_tc_emulation`` of
  ``tests/test_torch_attention.py``, against the JAX reference
  (``flash_attention_ref``) at ``FA_TOL["bfloat16"]``.

Both kernels launch one block a (q tile, head, batch).
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import gqa_flash_attention as ref_gqa
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _module("chip_smoke_for_k4_wide_fwd", ROOT / "chip_smoke.py")
_tf32_matmul = _module("k4_bwd_tests_for_k4_wide_fwd",
                       ROOT / "tests/test_torch_kernel_bwd.py")._tf32_matmul
_tc_emulation = _module("k4_tc_tests_for_k4_wide_fwd",
                        ROOT / "tests/test_torch_attention.py")._tc_emulation

BLOCK = 64            # q rows a block of the f32 kernel


def f32_keys(d):
    """Keys a K/V tile of the f32 kernel above D = 64 (``fa_keys``)."""
    return 64 if d <= 128 else 48


def tc_keys(d):
    """Keys a K/V tile of the bf16 kernel (``Layout::KEYS``)."""
    return 128 if d <= 128 else 96


def band(p, t, causal, window):
    """The keys absolute position p sees: [lo, hi) (``fa_band``)."""
    lo = max(0, p - window + 1) if window > 0 else 0
    hi = min(t, p + 1) if causal else t
    return lo, hi


def block_tiles(q0, s, t, causal, window, q_offset, bk):
    """First keys of the tiles a block of rows [q0, q0 + 64) walks
    (``fa_block_range``): the union of its rows' bands, or all T when
    one of its rows sees none, from its first key rounded down."""
    lo_all, hi_all, empty = t, 0, False
    for r in range(q0, min(q0 + BLOCK, s)):
        lo, hi = band(q_offset + r, t, causal, window)
        if hi <= lo:
            empty = True
            break
        lo_all, hi_all = min(lo_all, lo), max(hi_all, hi)
    if empty:
        lo_all, hi_all = 0, t
    start = lo_all // bk * bk
    return list(range(start, hi_all, bk))


def visible(s, t, causal, window, q_offset):
    """(S, T) bool: key j visible to row i."""
    p = np.arange(s)[:, None] + q_offset
    j = np.arange(t)[None, :]
    m = np.ones((s, t), bool)
    if causal:
        m &= j <= p
    if window > 0:
        m &= j > p - window
    return m


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x (f32), zero past its end (the zero-filled
    copy)."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    got = x[r0:r0 + n]
    out[:len(got)] = got
    return out


def _tile_product(a, b, split):
    """One tile's product in split TF32 (or ``split``'s products),
    summed from zero, as f32."""
    return np.float32(_tf32_matmul(a, b, split))


def emulate_f32(q, k, v, *, causal=True, window=0, q_offset=0, visits=None,
                split="kernel"):
    """(out (B,S,H,D), lse (B,H,S)) f32 of the wide f32 kernel's schedule.
    ``visits``: a dict that receives an (H,S,T) count of the (row, key)
    pairs whose S the walk computed, over keys < T.  ``split``: how
    ``_tf32_matmul`` takes each product (``"single"``: one TF32
    product)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep, scale = h // hkv, np.float32(1.0 / math.sqrt(d))
    bk = f32_keys(d)
    half, dh = bk // 2, d // 2
    mask = visible(s, t, causal, window, q_offset)
    out = np.zeros(q.shape, np.float32)
    lse = np.zeros((b, h, s), np.float32)
    if visits is not None:
        visits["f32"] = np.zeros((h, s, t), np.int64)
    for bi in range(b):
        for hh in range(h):
            kh = hh // rep
            for q0 in range(0, s, BLOCK):
                rows = np.arange(q0, q0 + BLOCK)
                qs = _rows(q[bi, :, hh], q0, BLOCK)
                m = np.full(BLOCK, -1e30, np.float32)
                l_half = np.zeros((2, BLOCK), np.float32)
                acc = np.zeros((BLOCK, d), np.float32)
                for t0 in block_tiles(q0, s, t, causal, window, q_offset,
                                      bk):
                    ks, vs = _rows(k[bi, :, kh], t0, bk), \
                        _rows(v[bi, :, kh], t0, bk)
                    sc = np.zeros((BLOCK, bk), np.float32)
                    for hf in range(2):
                        cols = slice(hf * half, (hf + 1) * half)
                        keys = t0 + np.arange(hf * half, (hf + 1) * half)
                        ok_r, ok_k = rows < s, keys < t
                        vis = np.zeros((BLOCK, half), bool)
                        vis[np.ix_(ok_r, ok_k)] = \
                            mask[np.ix_(rows[ok_r], keys[ok_k])]
                        part = _tile_product(qs, ks[cols].T, split)
                        sc[:, cols] = np.where(
                            vis, part * scale,
                            np.where(ok_k, np.float32(-1e30),
                                     np.float32(-np.inf))[None])
                        if visits is not None:
                            rr, kk = np.nonzero(ok_r[:, None]
                                                & ok_k[None, :])
                            np.add.at(visits["f32"],
                                      (hh, rows[rr], keys[kk]), 1)
                    # each half's row max, then the pair's
                    mx = np.maximum(sc[:, :half].max(axis=1),
                                    sc[:, half:].max(axis=1))
                    m_new = np.maximum(m, mx)
                    p = np.exp(sc - m_new[:, None]).astype(np.float32)
                    corr = np.exp(m - m_new).astype(np.float32)
                    for hf in range(2):
                        l_half[hf] = l_half[hf] * corr + p[
                            :, hf * half:(hf + 1) * half].sum(
                                axis=1, dtype=np.float32)
                    for hf in range(2):
                        oc = slice(hf * dh, (hf + 1) * dh)
                        acc[:, oc] = acc[:, oc] * corr[:, None] \
                            + _tile_product(p, vs[:, oc], split)
                    m = m_new
                la = np.maximum(l_half[0] + l_half[1], np.float32(1e-30))
                n = min(BLOCK, s - q0)
                out[bi, q0:q0 + n, hh] = (acc / la[:, None])[:n]
                lse[bi, hh, q0:q0 + n] = (m + np.log(la))[:n]
    return out, lse


def tc_visits(s, t, h, *, causal, window, q_offset, bk):
    """(H,S,T) count of the (row, key) pairs over keys < T whose score
    the bf16 kernel's walk computes (``_tc_emulation``'s loop: a 128-row
    CTA's key range, each 64-row warpgroup's run of tiles)."""
    counts = np.zeros((s, t), np.int64)
    for q0 in range(0, s, 128):
        p_first, p_last = q_offset + q0, q_offset + min(q0 + 128, s) - 1
        blind = window > 0 and p_last - window + 1 >= t
        lo = 0 if blind or window <= 0 else max(0, p_first - window + 1)
        hi = t if blind or not causal else min(t, p_last + 1)
        for w in range(2):
            r0 = q0 + 64 * w
            n = min(64, s - r0)
            if n <= 0:
                continue
            pa = q_offset + r0
            p_end = pa + n - 1
            wg_blind = window > 0 and p_end - window + 1 >= t
            w_lo = max(0, pa - window + 1) if window > 0 else 0
            w_hi = min(t, p_end + 1) if causal else t
            for t0 in range(lo // bk * bk, hi, bk):
                if not wg_blind and (t0 >= w_hi or t0 + bk <= w_lo):
                    continue
                counts[r0:r0 + n, t0:min(t0 + bk, t)] += 1
    return np.broadcast_to(counts, (h, s, t))


# (name, (b, s, t, h, hkv, d), masks): the masks of chip_smoke.py's
# WIDE_HEAD_CASES, WIDE_BWD_EDGE_CASES and FWD_HEAD_EDGE_CASES at CPU sizes
# -- GQA 4 causal, a window over ragged S with a group of 5, q_offset,
# no mask at T over S, rows that see no key beside rows that do, a band
# at nemotron's group of 12, S and T off the 48- and 96-key grids with a
# window edge inside a tile, groups of 3 and 7, MQA, odd H -- and one
# case off every new tile grid (S and T not multiples of 48, 64 or 96);
# each at D = 80 (hubert's MHA among them: the full 40x137 case is a
# non-causal one) as at 128 and 192
CASES = [case for d in (80, 128, 192) for case in (
    (f"d{d}-gqa4-causal-100", (1, 100, 100, 8, 2, d), {}),
    (f"d{d}-gqa5-window30-ragged-77", (2, 77, 77, 5, 1, d),
     dict(window=30)),
    (f"d{d}-q-offset-64-50x114", (1, 50, 114, 4, 1, d), dict(q_offset=64)),
    (f"d{d}-full-40x137-gqa2", (1, 40, 137, 4, 2, d), dict(causal=False)),
    (f"d{d}-some-rows-see-no-key", (1, 64, 128, 4, 2, d),
     dict(causal=False, window=32, q_offset=140)),
    (f"d{d}-gqa12-window40-96", (1, 96, 96, 12, 1, d), dict(window=40)),
    (f"d{d}-window13-inside-a-tile-71x103", (1, 71, 103, 4, 2, d),
     dict(window=13, q_offset=32)),
    (f"d{d}-gqa3-70", (1, 70, 70, 6, 2, d), {}),
    (f"d{d}-gqa7-window20-50", (1, 50, 50, 14, 2, d),
     dict(window=20)),
    (f"d{d}-mqa-odd-h-5-60", (1, 60, 60, 5, 1, d), {}),
    (f"d{d}-off-every-grid-131x203-full-window70", (1, 131, 203, 3, 3, d),
     dict(causal=False, window=70, q_offset=90)),
)]


def _inputs(seed, b, s, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))]


def _kw(kw):
    return {"causal": True, "window": 0, "q_offset": 0, **kw}


def _pallas(q, k, v, **kw):
    """The Pallas kernel in interpret mode through its GQA wrapper:
    blocks of 64 where they divide S and T, else one block."""
    s, t = q.shape[1], k.shape[1]
    return np.asarray(ref_gqa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=BLOCK if s % BLOCK == 0 else s,
        block_k=BLOCK if t % BLOCK == 0 else t, interpret=True, **kw))


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_wide_f32_schedule_matches_the_pallas_kernel(name, shape, kw):
    kw = _kw(kw)
    rtol, atol = SMOKE.FA_TOL["float32"]
    q, k, v = _inputs(sum(shape), *shape)
    out, lse = emulate_f32(q, k, v, **kw)
    np.testing.assert_allclose(out, _pallas(q, k, v, **kw), rtol=rtol,
                               atol=atol, err_msg=name)
    _, want_lse = fa.flash_attention_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(lse, want_lse.numpy(), rtol=rtol, atol=atol,
                               err_msg=name)


def test_wide_f32_schedule_needs_the_split():
    """One TF32 product a product in the same schedule fails the f32
    tolerance: the split is what the check holds the kernel to."""
    name, shape, kw = CASES[0]
    kw = _kw(kw)
    rtol, atol = SMOKE.FA_TOL["float32"]
    q, k, v = _inputs(sum(shape), *shape)
    single, _ = emulate_f32(q, k, v, split="single", **kw)
    assert not np.allclose(single, _pallas(q, k, v, **kw), rtol=rtol,
                           atol=atol)


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_wide_f32_walk_visits_every_pair_of_the_range_once(name, shape, kw):
    """The walk computes S for every visible (row, key) pair of every
    head once and only once, and every key of a row that sees none (the
    mean of v); no visible pair is left out."""
    kw = _kw(kw)
    b, s, t, h, hkv, d = shape
    q, k, v = _inputs(0, 1, s, t, h, hkv, d)
    visits = {}
    emulate_f32(q, k, v, visits=visits, **kw)
    mask = visible(s, t, **kw)
    none = ~mask.any(axis=1)
    got = visits["f32"]
    assert (got <= 1).all()
    assert (got[:, mask] == 1).all()
    assert (got[:, none] == 1).all()


def _bf16_case(shape, kw, seed):
    b, s, t, h, hkv, d = shape
    rng = np.random.default_rng(seed)
    qn, kn, vn = (rng.standard_normal(x).astype(np.float32)
                  .astype(ml_dtypes.bfloat16)
                  for x in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    from repro_torch import bridge
    q, k, v = (bridge.to_torch(a, "cpu") for a in (qn, kn, vn))
    rep = h // hkv

    def fold(a):
        a = np.repeat(a, rep, axis=2) if a.shape[2] != h else a
        return jnp.asarray(np.moveaxis(a, 2, 1).reshape(b * h, -1, d))

    ref = flash_attention_ref(fold(qn), fold(kn), fold(vn), **kw)
    ref = np.moveaxis(np.asarray(ref, np.float32).reshape(b, h, s, d), 1, 2)
    return (q, k, v), ref


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_wide_bf16_walk_matches_the_reference(name, shape, kw):
    kw = _kw(kw)
    rtol, atol = SMOKE.FA_TOL["bfloat16"]
    (q, k, v), ref = _bf16_case(shape, kw, sum(shape))
    got, _ = _tc_emulation(q, k, v, bk=tc_keys(shape[5]), **kw)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_wide_bf16_walk_visits_every_visible_pair_once(name, shape, kw):
    kw = _kw(kw)
    b, s, t, h, hkv, d = shape
    got = tc_visits(s, t, h, bk=tc_keys(d), **kw)
    mask = visible(s, t, **kw)
    none = ~mask.any(axis=1)
    assert (got <= 1).all()
    assert (got[:, mask] == 1).all() and (got[:, none] == 1).all()


def test_tiles_and_blocks_are_the_kernels():
    """The emulations' tiles and blocks are the source's: the f32
    kernel's 64-row blocks of eight warps and its 64- / 48-key tiles,
    one block a (q tile, head, batch); the bf16 kernel's 128- / 96-key
    tiles in 3 / 2 stages on a grid of (q tiles, H, B), at D = 80 in
    blocks of 16 columns (the column blocks of ``fa_hopper.cuh``'s
    ``Tiles<D>``, which the bf16 kernel's ``Layout<D>`` derives from)."""
    src = SOURCE.read_text()
    tiles = (SOURCE.parent / "fa_hopper.cuh").read_text()
    assert "#define FA_BQ 64" in src and "#define FA_STAGES 2" in src
    assert "return D <= 64 ? FA_THREADS : 2 * FA_THREADS;" in src
    assert "{ return D <= 128 ? FA_BK : 48; }" in src
    assert "static constexpr int KEYS = D <= 128 ? BK : 96;" in src
    assert "static constexpr int DEPTH = D == 192 ? 2 : WIDE ? 3 : STAGES;" \
        in src
    assert "(long long)((S + FA_BQ - 1) / FA_BQ) * H * B;" in src
    assert "const dim3 grid((S + BQ - 1) / BQ, H, B);" in src
    assert "struct Layout : Tiles<D> {" in src
    assert "static constexpr int COLS = D < 64 ? D : D % 64 ? 16 : 64;" \
        in tiles
    assert [f32_keys(d) for d in (80, 128, 192)] == [64, 64, 48]
    assert [tc_keys(d) for d in (64, 80, 128, 192)] == [128, 128, 128, 96]
