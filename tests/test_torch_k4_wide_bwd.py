"""K4's f32 backward at head dims 80, 128 and 192 (``csrc/flash_attention_bwd.cu``:
``fb_dq_wide``, ``fb_dkdv_wide``), its schedule emulated in numpy.

The kernels run only on a card (``chip_smoke.py: kernel_bwd_checks``
holds them against autograd of the plain twin there).  Here the same
schedule is emulated on the CPU and held against ``jax.grad`` of the JAX
package's attention:

* the walk: a dq block of 64 q rows takes the key range its rows see,
  in tiles of 64 keys (D = 80, 128) or 32 (D = 192); a dkdv block of 64
  keys takes the q tiles of 64 rows (D = 80), 48 (D = 128) or 32
  (D = 192) whose rows see
  one of its keys, then the tiles of rows that see no key, each for
  every q head of the group;
* the pair of warps that shares 16 stationary rows: each computes S and
  dP for its half of the moving tile's columns, the two halves of P and
  dS are put together, and each warp computes the second products over
  its half of the output columns;
* each tile's product in split TF32 (``_tf32_matmul(..., "kernel")`` of
  ``tests/test_torch_kernel_bwd.py``), summed from zero and then added
  in f32.

The reference is ``jax.grad`` of ``repro.models.attention.attention``
(k and v repeated inside), except where rows see no key: the model's
additive -1e30 bias passes those rows' softmax gradient on to q and k,
where the kernels (and the port's plain twin) follow
``repro.kernels.ref.flash_attention_ref``, whose select passes none, so
that case is held against ``jax.grad`` of that oracle.  Tolerance:
``chip_smoke.BWD_RTOL`` and ``BWD_ATOL`` scaled by max(1, max |want|),
as ``kernel_bwd_checks``.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.ref import flash_attention_ref
from repro.models.attention import attention as ref_attention

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _module("chip_smoke_for_k4_wide_bwd", ROOT / "chip_smoke.py")
_tf32_matmul = _module("k4_bwd_tests_for_k4_wide_bwd",
                       ROOT / "tests/test_torch_kernel_bwd.py")._tf32_matmul

BLOCK = 64            # stationary rows a block: q rows (dq), keys (dkdv)


def moving_rows(d, dkdv):
    """Rows of a moving tile above D = 64 (``fb_mrows``): 64 at D = 80;
    32 at D = 192; at D = 128, 48 in dkdv and 64 in dq."""
    if d == 192:
        return 32
    return 48 if dkdv and d == 128 else 64


def band(p, t, causal, window):
    """The keys absolute position p sees: [lo, hi) (``fb_band``)."""
    lo = max(0, p - window + 1) if window > 0 else 0
    hi = min(t, p + 1) if causal else t
    return lo, hi


def dq_key_tiles(q0, s, t, causal, window, q_offset, bm):
    """First keys of the tiles a dq block of rows [q0, q0 + 64) walks:
    the union of its rows' bands (rows that see no key take none), from
    its first key rounded down to the tile."""
    lo_all, hi_all = t, 0
    for r in range(q0, min(q0 + BLOCK, s)):
        lo, hi = band(q_offset + r, t, causal, window)
        if hi > lo:
            lo_all, hi_all = min(lo_all, lo), max(hi_all, hi)
    start = lo_all // bm * bm
    n = -(-(hi_all - start) // bm) if hi_all > start else 0
    return [start + bm * i for i in range(n)]


def dkdv_q_tiles(k0, k1, s, t, causal, window, q_offset, bm):
    """The q tiles (of bm rows) a dkdv block of keys [k0, k1) walks, in
    order (``fb_walk``): the rows whose band meets the keys, then the
    rows that see no key."""
    n_qt = -(-s // bm)
    pa = k0 if causal else 0
    pb = k1 + window - 1 if window > 0 else q_offset + s
    ra, rb = max(0, pa - q_offset), min(s, pb - q_offset)
    ta0 = ta1 = 0
    if ra < rb:
        ta0, ta1 = ra // bm, (rb - 1) // bm + 1
    te = n_qt
    if window > 0:
        re = max(0, t + window - 1 - q_offset)
        if re < s:
            te = max(ta1, re // bm)
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
    """Rows [r0, r0 + n) of x (f32), zero past its end (the zero-filled
    copy)."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    got = x[r0:r0 + n]
    out[:len(got)] = got
    return out


def _tile_product(a, b):
    """One tile's product in split TF32, summed from zero, as f32."""
    return np.float32(_tf32_matmul(a, b, "kernel"))


def emulate(q, k, v, do, *, causal=True, window=0, q_offset=0, visits=None):
    """dq, dk, dv (f32) of the wide kernels' schedule.  q, do (B,S,H,D),
    k, v (B,T,Hkv,D) f32.  ``visits``: a dict that receives, per kernel,
    an (H,S,T) count of the (row, key) pairs each visit computed P for
    (visible pairs, and every key of a row that sees no key)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep, scale = h // hkv, np.float32(1.0 / math.sqrt(d))
    mask = visible(s, t, causal, window, q_offset)
    none = ~mask.any(axis=1)
    # the forward's lse and output, and delta, as the kernels receive them
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
    dq, dk, dv = (np.zeros(x.shape, np.float32) for x in (q, k, v))
    if visits is not None:
        visits["dq"] = np.zeros((h, s, t), np.int64)
        visits["dkdv"] = np.zeros((h, s, t), np.int64)

    # dq: a block of 64 q rows of one head; the pair of warps splits each
    # key tile's columns, then dq's columns
    bm, half, dh = moving_rows(d, False), moving_rows(d, False) // 2, d // 2
    for bi in range(b):
        for hh in range(h):
            kh = hh // rep
            for q0 in range(0, s, BLOCK):
                rows = np.arange(q0, q0 + BLOCK)
                qs, dos = _rows(q[bi, :, hh], q0, BLOCK), \
                    _rows(do[bi, :, hh], q0, BLOCK)
                lse_r = _rows(lse[bi, hh], q0, BLOCK)[:, None]
                dl_r = _rows(delta[bi, hh], q0, BLOCK)[:, None]
                dqa = np.zeros((BLOCK, d), np.float32)
                for t0 in dq_key_tiles(q0, s, t, causal, window, q_offset,
                                       bm):
                    ks, vs = _rows(k[bi, :, kh], t0, bm), \
                        _rows(v[bi, :, kh], t0, bm)
                    ds = np.zeros((BLOCK, bm), np.float32)
                    for hf in range(2):
                        cols = slice(hf * half, (hf + 1) * half)
                        keys = t0 + np.arange(hf * half, (hf + 1) * half)
                        vis = np.zeros((BLOCK, half), bool)
                        ok_r, ok_k = rows < s, keys < t
                        vis[np.ix_(ok_r, ok_k)] = \
                            mask[np.ix_(rows[ok_r], keys[ok_k])]
                        sc = _tile_product(qs, ks[cols].T)
                        p = np.exp(np.where(vis, sc * scale - lse_r,
                                            -np.inf)).astype(np.float32)
                        dp = _tile_product(dos, vs[cols].T)
                        ds[:, cols] = p * (dp - dl_r)
                        if visits is not None:
                            rr, kk = np.nonzero(vis)
                            np.add.at(visits["dq"],
                                      (hh, rows[rr], keys[kk]), 1)
                    for hf in range(2):
                        oc = slice(hf * dh, (hf + 1) * dh)
                        dqa[:, oc] += _tile_product(ds, ks[:, oc])
                n = min(BLOCK, s - q0)
                dq[bi, q0:q0 + n, hh] = dqa[:n] * scale

    # dkdv: a block of 64 keys of one kv head; items of (q tile of 48 or
    # 32 rows, q head of the group); the pair splits the item's rows,
    # then dk's and dv's columns
    bm, half = moving_rows(d, True), moving_rows(d, True) // 2
    inv_t = np.float32(1.0 / t)
    for bi in range(b):
        for kh in range(hkv):
            for k0 in range(0, t, BLOCK):
                keys = np.arange(k0, k0 + BLOCK)
                ks, vs = _rows(k[bi, :, kh], k0, BLOCK), \
                    _rows(v[bi, :, kh], k0, BLOCK)
                dka = np.zeros((BLOCK, d), np.float32)
                dva = np.zeros((BLOCK, d), np.float32)
                for tile in dkdv_q_tiles(k0, min(t, k0 + BLOCK), s, t,
                                         causal, window, q_offset, bm):
                    for hh in range(kh * rep, (kh + 1) * rep):
                        r0 = tile * bm
                        qs, dos = _rows(q[bi, :, hh], r0, bm), \
                            _rows(do[bi, :, hh], r0, bm)
                        lse_c = _rows(lse[bi, hh], r0, bm)[None, :]
                        dl_c = _rows(delta[bi, hh], r0, bm)[None, :]
                        p_full = np.zeros((BLOCK, bm), np.float32)
                        ds_full = np.zeros((BLOCK, bm), np.float32)
                        for hf in range(2):
                            cols = slice(hf * half, (hf + 1) * half)
                            rows = r0 + np.arange(hf * half, (hf + 1) * half)
                            ok_r, ok_k = rows < s, keys < t
                            vis = np.zeros((BLOCK, half), bool)
                            vis[np.ix_(ok_k, ok_r)] = \
                                mask[np.ix_(rows[ok_r], keys[ok_k])].T
                            empty = np.zeros(half, bool)
                            empty[ok_r] = none[rows[ok_r]]
                            sc = _tile_product(ks, qs[cols].T)
                            p = np.exp(np.where(
                                vis, sc * scale - lse_c[:, cols],
                                -np.inf)).astype(np.float32)
                            p = np.where(empty[None, :] & ok_k[:, None],
                                         inv_t, p)
                            dp = _tile_product(vs, dos[cols].T)
                            p_full[:, cols] = p
                            ds_full[:, cols] = np.where(
                                empty[None, :], np.float32(0),
                                p * (dp - dl_c[:, cols]))
                            if visits is not None:
                                seen = vis | (empty[None, :] & ok_k[:, None])
                                kk, rr = np.nonzero(seen)
                                np.add.at(visits["dkdv"],
                                          (hh, rows[rr], keys[kk]), 1)
                        for hf in range(2):
                            oc = slice(hf * dh, (hf + 1) * dh)
                            dva[:, oc] += _tile_product(p_full, dos[:, oc])
                            dka[:, oc] += _tile_product(ds_full, qs[:, oc])
                n = min(BLOCK, t - k0)
                dk[bi, k0:k0 + n, kh] = dka[:n] * scale
                dv[bi, k0:k0 + n, kh] = dva[:n]
    return dq, dk, dv


# (name, (b, s, t, h, hkv, d), masks): the masks of chip_smoke.py's
# WIDE_HEAD_CASES at CPU sizes -- GQA 4 causal, a window over ragged S
# with a group of 5, q_offset, no mask at T over S, rows that see no key
# beside rows that do, a band at nemotron's group of 12 -- and S and T
# off the 32-row grid with a window edge inside a tile; each at D = 80
# as at 128 and 192
CASES = [case for d in (80, 128, 192) for case in (
    (f"d{d}-gqa4-causal-100", (1, 100, 100, 8, 2, d), {}),
    (f"d{d}-gqa5-window30-ragged-77", (2, 77, 77, 5, 1, d),
     dict(window=30)),
    (f"d{d}-q-offset-64-50x114", (1, 50, 114, 4, 1, d), dict(q_offset=64)),
    (f"d{d}-full-40x137-gqa2", (1, 40, 137, 4, 2, d), dict(causal=False)),
    (f"d{d}-some-rows-see-no-key", (1, 64, 128, 4, 2, d),
     dict(causal=False, window=32, q_offset=140)),
    (f"d{d}-gqa12-window40-96", (1, 96, 96, 12, 1, d), dict(window=40)),
    (f"d{d}-off-grid-71x103-window20-offset32", (1, 71, 103, 4, 2, d),
     dict(window=20, q_offset=32)),
)]


def _inputs(seed, b, s, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d),
                          (b, s, h, d))]


def _jax_grads(q, k, v, do, *, causal, window, q_offset):
    """``jax.grad`` of the reference attention (module docstring)."""
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


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_wide_schedule_matches_jax_grad(name, shape, kw):
    kw = {"causal": True, "window": 0, "q_offset": 0, **kw}
    q, k, v, do = _inputs(sum(shape), *shape)
    got = emulate(q, k, v, do, **kw)
    want = _jax_grads(q, k, v, do, **kw)
    for tag, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        atol = SMOKE.BWD_ATOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=SMOKE.BWD_RTOL, atol=atol,
                                   err_msg=f"{name}: {tag}")


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_wide_walk_visits_every_visible_pair_once(name, shape, kw):
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


def test_no_key_case_is_one_the_model_attention_cannot_hold():
    """Why the rows-that-see-no-key case uses the select oracle: the
    model attention's gradient reaches q there, the kernels' does not."""
    name, shape, kw = next(c for c in CASES if "no-key" in c[0])
    kw = {"causal": True, "window": 0, "q_offset": 0, **kw}
    q, k, v, do = _inputs(sum(shape), *shape)
    model = jax.grad(lambda *a: jnp.sum(ref_attention(*a, **kw) * do),
                     argnums=0)(*(jnp.asarray(x) for x in (q, k, v)))
    none = ~visible(shape[1], shape[2], **kw).any(axis=1)
    assert none.any() and np.abs(np.asarray(model)[:, none]).max() > 1e-3
    dq = emulate(q, k, v, do, **kw)[0]
    assert not dq[:, none].any()


@pytest.mark.parametrize("d", [80, 128, 192])
def test_tile_heights_are_the_kernels(d):
    """The emulation's tile heights are the source's ``fb_mrows`` (64 up
    to D = 80; at D = 128 48 in dkdv and 64 in dq; 32 at D = 192), and
    its blocks the source's 64 stationary rows and eight warps above
    D = 64."""
    src = SOURCE.read_text()
    assert "return D <= 80 ? 64 : D == 128 ? (DKDV ? 48 : 64) : 32;" in src
    assert "#define FB_BQ 64" in src and "#define FB_BK 64" in src
    assert "return D <= 64 ? FB_THREADS : 2 * FB_THREADS;" in src
    assert moving_rows(d, True) == {80: 64, 128: 48, 192: 32}[d]
    assert moving_rows(d, False) == {80: 64, 128: 64, 192: 32}[d]
