"""K4's bf16 backward pair on ``wgmma`` (``csrc/flash_attention_bwd_tc.cu``:
``fa_bwd_tc_dq_kernel``, ``fa_bwd_tc_dkdv_kernel``), its schedule and
rounding emulated in numpy.

The kernels run only on a card (``chip_smoke.py: bf16_bwd_checks`` holds
them against autograd of the plain twin there).  Here the same walk and
the same roundings are emulated on the CPU and held against ``jax.grad``
of the JAX package's attention on the upcast bf16 inputs:

* the walk: a dq block of 128 q rows (two consumer warpgroups of 64)
  takes the key tiles of 64 keys that the union of its rows' bands
  covers, and each warpgroup computes the run of those tiles that its
  own rows see; a dkdv block of 128 keys (64 from D = 128) takes the q
  tiles of 64 rows whose rows see one of its keys, then the tiles of
  rows that see no key, each for every q head of the group, in that
  fixed order;
* bf16 q, k, v and dO; each tile's product in f32 from bf16 operands
  (the tensor cores' products are exact, their sums f32);
* P and dS split into two bf16 parts where they enter the second
  products (dS.K in dq, P^T.dO and dS^T.Q in dkdv), hi = bf16(x) and lo
  = bf16(x - hi), each a ``wgmma`` A operand on the same B: x to about
  2^-16, as the forward carries P.  One bf16 part (2^-9) fails the
  tolerance in all three gradients (``test_one_bf16_part_fails``);
* dq, dk and dv summed in f32 over the walk and rounded once to bf16.

The reference is ``jax.grad`` of ``repro.models.attention.attention`` in
f32 on the upcast inputs (k and v repeated after the upcast, inside the
reference), except where rows see no key: the model's additive -1e30
bias passes those rows' softmax gradient on to q and k, where the
kernels follow ``repro.kernels.ref.flash_attention_ref``, whose select
passes none, so that case is held against ``jax.grad`` of that oracle.
Tolerance: ``chip_smoke.BF16_BWD_TOL`` (rtol 8e-3, atol 1e-3) with atol
scaled by max(1, max |want|), as ``_grad_close_bf16`` scales it.
"""

import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from repro.kernels.ref import flash_attention_ref
from repro.models.attention import attention as ref_attention

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu"


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _module("chip_smoke_for_k4_bf16_wgmma_bwd", ROOT / "chip_smoke.py")

WG_ROWS = 64          # stationary rows of a consumer warpgroup
DQ_ROWS = 128         # q rows a dq block: two warpgroups
KEY_TILE = 64         # keys a dq ring stage
ITEM_ROWS = 64        # q rows a dkdv ring stage


def dkdv_keys(d):
    """Keys a dkdv block: two warpgroups of 64, or from D = 128 on one
    64-key tile that both take (one dv, one dk)."""
    return 64 if d >= 128 else 128


def bf16(x):
    """x rounded to bf16 (to nearest even), as f32."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def band(p, t, causal, window):
    """The keys absolute position p sees: [lo, hi)."""
    lo = max(0, p - window + 1) if window > 0 else 0
    hi = min(t, p + 1) if causal else t
    return lo, hi


def seeing_band(r0, r1, s, t, causal, window, q_offset):
    """The keys rows [r0, r1) (those < S that see a key) see: [lo, hi),
    empty as (t, 0).  A row sees no key only under a window, from p =
    T + window - 1 on, and the bands' ends grow with p, so the union is
    [lo(first row), hi(last seeing row))."""
    r1 = min(r1, s)
    if window > 0:
        r1 = min(r1, t + window - 1 - q_offset)
    if r1 <= r0:
        return t, 0
    return (band(q_offset + r0, t, causal, window)[0],
            band(q_offset + r1 - 1, t, causal, window)[1])


def dq_runs(q0, s, t, causal, window, q_offset):
    """The key tiles of a dq block of rows [q0, q0 + 128): (first keys of
    the block's tiles, [(j_a, j_b) of each warpgroup])."""
    lo, hi = seeing_band(q0, q0 + DQ_ROWS, s, t, causal, window, q_offset)
    if hi <= lo:
        return [], [(0, 0), (0, 0)]
    start = lo // KEY_TILE * KEY_TILE
    n = -(-(hi - start) // KEY_TILE)
    runs = []
    for w in range(2):
        a, b = seeing_band(q0 + WG_ROWS * w, q0 + WG_ROWS * (w + 1), s, t,
                           causal, window, q_offset)
        if b <= a:
            runs.append((n, n))
        else:
            runs.append(((a - start) // KEY_TILE,
                         min(n, -(-(b - start) // KEY_TILE))))
    return [start + KEY_TILE * j for j in range(n)], runs


def dkdv_q_tiles(k0, k1, s, t, causal, window, q_offset):
    """The q tiles of 64 rows a dkdv block of keys [k0, k1) walks, in
    order: the rows whose band meets the keys, then the rows that see no
    key."""
    bm = ITEM_ROWS
    n_qt = -(-s // bm)
    pa = k0 if causal else 0
    pb = k1 + window - 1 if window > 0 else q_offset + s
    ra, rb = max(0, pa - q_offset), min(s, pb - q_offset)
    ta0 = ta1 = 0
    if ra < rb:
        ta0, ta1 = ra // bm, (rb - 1) // bm + 1
    te = n_qt
    if window > 0:
        re_ = max(0, t + window - 1 - q_offset)
        if re_ < s:
            te = max(ta1, re_ // bm)
    return list(range(ta0, ta1)) + list(range(te, n_qt))


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
    """Rows [r0, r0 + n) of x (f32), zero past its end (TMA's fill)."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    got = x[r0:r0 + n]
    out[:len(got)] = got
    return out


def _part(x, parts):
    """A second product's A operand as the products see it: bf16(x), and
    with ``parts`` = 2 also bf16 of what that left (two products on one
    B, summed in f32)."""
    hi = bf16(x)
    return hi + bf16(x - hi) if parts == 2 else hi


def forward_rows(q, k, v, do, mask):
    """lse and delta as the kernels receive them: lse of the f32 scores
    (the forward's), delta = rowsum(dO * O) of the f32 output (out +
    out_lo)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    lse = np.zeros((b, h, s), np.float32)
    delta = np.zeros((b, h, s), np.float32)
    for bi in range(b):
        for hh in range(h):
            kh = hh // rep
            sc = np.float64(q[bi, :, hh]) @ np.float64(k[bi, :, kh]).T \
                / math.sqrt(d)
            sc = np.where(mask, sc, -1e30)
            top = sc.max(axis=1, keepdims=True)
            e = np.exp(sc - top)
            lse[bi, hh] = np.log(e.sum(axis=1)) + top[:, 0]
            o = np.float32((e / e.sum(axis=1, keepdims=True))
                           @ np.float64(v[bi, :, kh]))
            delta[bi, hh] = np.float32((np.float64(do[bi, :, hh])
                                        * np.float64(o)).sum(axis=1))
    return lse, delta


def emulate(q, k, v, do, *, causal=True, window=0, q_offset=0, parts=2,
            visits=None):
    """dq, dk, dv (bf16 values as f32) of the kernels' walk and rounding.
    q, do (B,S,H,D), k, v (B,T,Hkv,D) hold bf16 values; ``parts``: the
    bf16 parts of P and dS (the kernels' 2, or 1).  ``visits``: a
    dict that receives, per kernel, an (H,S,T) count of the (row, key)
    pairs each visit computed P for (visible pairs, and in dkdv every key
    of a row that sees no key)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep, scale = h // hkv, np.float32(1.0 / math.sqrt(d))
    mask = visible(s, t, causal, window, q_offset)
    none = ~mask.any(axis=1)
    lse, delta = forward_rows(q, k, v, do, mask)
    dq, dk, dv = (np.zeros(x.shape, np.float32) for x in (q, k, v))
    if visits is not None:
        visits["dq"] = np.zeros((h, s, t), np.int64)
        visits["dkdv"] = np.zeros((h, s, t), np.int64)

    # dq: each warpgroup's 64 rows against its run of the block's tiles
    for bi in range(b):
        for hh in range(h):
            kh = hh // rep
            for q0 in range(0, s, DQ_ROWS):
                tiles, runs = dq_runs(q0, s, t, causal, window, q_offset)
                for w, (ja, jb) in enumerate(runs):
                    r0 = q0 + WG_ROWS * w
                    if r0 >= s:
                        continue
                    rows = np.arange(r0, r0 + WG_ROWS)
                    qs = _rows(q[bi, :, hh], r0, WG_ROWS)
                    dos = _rows(do[bi, :, hh], r0, WG_ROWS)
                    lse_r = _rows(lse[bi, hh], r0, WG_ROWS)[:, None]
                    dl_r = _rows(delta[bi, hh], r0, WG_ROWS)[:, None]
                    acc = np.zeros((WG_ROWS, d), np.float32)
                    for t0 in tiles[ja:jb]:
                        keys = t0 + np.arange(KEY_TILE)
                        ks = _rows(k[bi, :, kh], t0, KEY_TILE)
                        vs = _rows(v[bi, :, kh], t0, KEY_TILE)
                        vis = np.zeros((WG_ROWS, KEY_TILE), bool)
                        ok_r, ok_k = rows < s, keys < t
                        vis[np.ix_(ok_r, ok_k)] = \
                            mask[np.ix_(rows[ok_r], keys[ok_k])]
                        sc = qs @ ks.T
                        p = np.exp(np.where(vis, sc * scale - lse_r,
                                            -np.inf)).astype(np.float32)
                        dp = dos @ vs.T
                        ds = p * (dp - dl_r)
                        acc += _part(ds, parts) @ ks
                        if visits is not None:
                            rr, kk = np.nonzero(vis)
                            np.add.at(visits["dq"],
                                      (hh, rows[rr], keys[kk]), 1)
                    n = min(WG_ROWS, s - r0)
                    dq[bi, r0:r0 + n, hh] = bf16(acc[:n] * scale)

    # dkdv: each warpgroup's keys against every item of the block
    nk = dkdv_keys(d)
    inv_t = np.float32(1.0 / t)
    for bi in range(b):
        for kh in range(hkv):
            for k0 in range(0, t, nk):
                keys = np.arange(k0, k0 + nk)
                ok_k = keys < t
                ks = _rows(k[bi, :, kh], k0, nk)
                vs = _rows(v[bi, :, kh], k0, nk)
                dka = np.zeros((nk, d), np.float32)
                dva = np.zeros((nk, d), np.float32)
                for tile in dkdv_q_tiles(k0, min(t, k0 + nk), s, t, causal,
                                         window, q_offset):
                    for hh in range(kh * rep, (kh + 1) * rep):
                        r0 = tile * ITEM_ROWS
                        rows = r0 + np.arange(ITEM_ROWS)
                        ok_r = rows < s
                        qs = _rows(q[bi, :, hh], r0, ITEM_ROWS)
                        dos = _rows(do[bi, :, hh], r0, ITEM_ROWS)
                        lse_c = _rows(lse[bi, hh], r0, ITEM_ROWS)[None, :]
                        dl_c = _rows(delta[bi, hh], r0, ITEM_ROWS)[None, :]
                        vis = np.zeros((nk, ITEM_ROWS), bool)
                        vis[np.ix_(ok_k, ok_r)] = \
                            mask[np.ix_(rows[ok_r], keys[ok_k])].T
                        empty = np.zeros(ITEM_ROWS, bool)
                        empty[ok_r] = none[rows[ok_r]]
                        sc = ks @ qs.T
                        p = np.exp(np.where(vis, sc * scale - lse_c,
                                            -np.inf)).astype(np.float32)
                        p = np.where(empty[None, :] & ok_k[:, None], inv_t,
                                     p).astype(np.float32)
                        dp = vs @ dos.T
                        ds = np.where(empty[None, :], np.float32(0),
                                      p * (dp - dl_c)).astype(np.float32)
                        dva += _part(p, parts) @ dos
                        dka += _part(ds, parts) @ qs
                        if visits is not None:
                            seen = vis | (empty[None, :] & ok_k[:, None])
                            kk, rr = np.nonzero(seen)
                            np.add.at(visits["dkdv"],
                                      (hh, rows[rr], keys[kk]), 1)
                n = min(nk, t - k0)
                dk[bi, k0:k0 + n, kh] = bf16(dka[:n] * scale)
                dv[bi, k0:k0 + n, kh] = bf16(dva[:n])
    return dq, dk, dv


# chip_smoke.py's BF16_BWD_CASES (all six head dims), and rows of 2048
# keys at every head dim: the longest sums of rounded P and dS
CASES = [(name, shape, kw) for name, shape, kw in SMOKE.BF16_BWD_CASES] + [
    (f"d{d}-long-rows-2048-full", (1, 1024, 2048, 1, 1, d),
     dict(causal=False)) for d in SMOKE.HEAD_DIMS]


def _inputs(seed, b, s, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [bf16(rng.standard_normal(shape))
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d),
                          (b, s, h, d))]


def _jax_grads(q, k, v, do, *, causal, window, q_offset):
    """``jax.grad`` in f32 of the reference attention on the upcast
    inputs (module docstring)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if visible(s, k.shape[1], **kw).any(axis=1).all():
        def attend(q, k, v):
            return ref_attention(q, k, v, **kw)
    else:
        def fold(x):
            return jnp.moveaxis(x, 2, 1).reshape(b * x.shape[2], x.shape[1],
                                                 d)

        def attend(q, k, v):
            kx, vx = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
            o = flash_attention_ref(fold(q), fold(kx), fold(vx), **kw)
            return jnp.moveaxis(o.reshape(b, h, s, d), 1, 2)
    return jax.grad(lambda *a: jnp.sum(attend(*a) * do),
                    argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


def _worst(got, want):
    """The largest |got - want| over the tolerance's allowance, of the
    three gradients (<= 1 passes)."""
    rtol, atol = SMOKE.BF16_BWD_TOL
    worst = 0.0
    for g, w in zip(got, want):
        w = np.asarray(w)
        allow = atol * max(1.0, float(np.abs(w).max())) + rtol * np.abs(w)
        worst = max(worst, float((np.abs(g - w) / allow).max()))
    return worst


def _case(name, shape, kw):
    kw = {"causal": True, "window": 0, "q_offset": 0, **kw}
    q, k, v, do = _inputs(sum(shape), *shape)
    return (q, k, v, do), kw


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_bf16_schedule_matches_jax_grad(name, shape, kw):
    ins, kw = _case(name, shape, kw)
    got = emulate(*ins, **kw)
    want = _jax_grads(*ins, **kw)
    rtol, atol = SMOKE.BF16_BWD_TOL
    for tag, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol * max(1.0, float(np.abs(w).max())),
            err_msg=f"{name}: {tag}")


# one case a gradient where P and dS as one bf16 part miss the tolerance
ONE_PART_FAILS = {"dq": "d80-gqa4-window100-ragged-333",
                  "dk": "d128-off-grid-95x139-gqa4-offset44",
                  "dv": "d192-off-grid-71x105-gqa12-offset34"}


@pytest.mark.parametrize("tag", sorted(ONE_PART_FAILS))
def test_one_bf16_part_fails(tag):
    """Why the kernels split P and dS: with one bf16 part (2^-9) the
    gradient misses the tolerance, with two it stays within half of it."""
    name = ONE_PART_FAILS[tag]
    ins, kw = _case(*next(c for c in CASES if c[0] == name))
    want = _jax_grads(*ins, **kw)
    i = ("dq", "dk", "dv").index(tag)
    one = _worst(emulate(*ins, parts=1, **kw)[i:i + 1], want[i:i + 1])
    two = _worst(emulate(*ins, **kw)[i:i + 1], want[i:i + 1])
    assert one > 1.0 and two < 0.5, (one, two)


@pytest.mark.parametrize("name,shape,kw", CASES[:len(SMOKE.BF16_BWD_CASES)],
                         ids=[c[0] for c in CASES[:len(
                             SMOKE.BF16_BWD_CASES)]])
def test_bf16_walk_visits_every_visible_pair_once(name, shape, kw):
    """Each kernel's walk computes P for every visible (row, key) pair of
    every head once and only once, and for no other pair but the keys
    of rows that see no key (dkdv: 1/T each, once)."""
    kw = {"causal": True, "window": 0, "q_offset": 0, **kw}
    b, s, t, h, hkv, d = shape
    q, k, v, do = _inputs(0, 1, s, t, h, hkv, d)
    visits = {}
    emulate(q, k, v, do, visits=visits, **kw)
    mask = visible(s, t, **kw)
    none = ~mask.any(axis=1)
    assert (visits["dq"] == mask[None].astype(np.int64)).all()
    want = (mask | none[:, None])[None].astype(np.int64)
    assert (visits["dkdv"] == want).all()


def test_emulated_tiles_are_the_kernels():
    """The emulation's blocks and tiles are the source's: 128 q rows a
    dq block in two warpgroups of 64 with key tiles of 64; 128 keys a
    dkdv block (64 from D = 128) with q tiles of 64 rows."""
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["BQ"]) == DQ_ROWS
    assert int(consts["BK"]) == KEY_TILE
    assert int(consts["BM"]) == ITEM_ROWS
    assert "return D >= 128 ? 64 : 128;" in src
    assert [dkdv_keys(d) for d in SMOKE.HEAD_DIMS] == [128] * 4 + [64] * 2
