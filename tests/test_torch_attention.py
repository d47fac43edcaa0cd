"""The port's attention (kernel K4's plain twin and wrapper,
``models/attention.py``) against the JAX package's, on the same numpy
inputs.

Tolerances are the reference's own tests': 2e-5 (f32) and 2e-2 (bf16)
for the kernel's function (``tests/test_kernels.py``), 2e-5 / 3e-5 for
the attention paths and the ring-cache decode (``tests/test_attention.py``):
f32 softmax sums taken in another order.  On the CPU the kernel wrapper
is its plain twin; that the CUDA branches hand the kernel un-repeated
k/v, the softcap and (non-causal banded) the reference's bands of keys,
and that a softcap with a gradient reaches ``FlashAttentionFn`` with the
cap, is checked here by routing, and
the kernel itself is held against the twin on the card by
``chip_smoke.py``.  The bf16 tensor-core kernel's arithmetic (P split
into two bf16 parts for P.V, exp2, 128-key tiles) is emulated here in
plain torch and held against the twin and the reference at its
tolerance, rtol 8e-3, atol 1e-3.
"""

import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import gqa_flash_attention as ref_gqa
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ref import flash_attention_ref
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn

torch.set_num_threads(1)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(t):
    return t.float().numpy()


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the kernel's function: plain twin and wrapper vs the Pallas kernel
# ---------------------------------------------------------------------------

# the reference's kernel-test shapes; causal with s > t is left out, as
# there
KERNEL_SHAPES = [(128, 128, 64, 64, 64),
                 (256, 256, 32, 128, 128),
                 (64, 256, 64, 64, 64),       # cross-attention shape
                 (256, 128, 16, 64, 128)]     # small head_dim, uneven blocks


@pytest.mark.parametrize("s,t,d,bq,bk,causal", [
    (*shape, causal) for shape in KERNEL_SHAPES for causal in (True, False)
    if not (causal and shape[0] > shape[1])])
def test_flash_attention_plain_matches_pallas_kernel(s, t, d, bq, bk,
                                                     causal):
    rng = np.random.default_rng(s + t + d)
    q, k, v = _randn(rng, 3, s, d), _randn(rng, 3, t, d), _randn(rng, 3, t, d)
    off = t - s if causal else 0
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, q_offset=off, block_q=bq, block_k=bk,
                     interpret=True)
    oracle = flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, q_offset=off)
    got = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   q_offset=off)
    np.testing.assert_allclose(_np(got), np.asarray(want), **_tol("f32"))
    np.testing.assert_allclose(_np(got), np.asarray(oracle), **_tol("f32"))
    # the wrapper takes the model's layout: heads as a (B,S,H,D) axis
    wrapped = fa.flash_attention(torch.from_numpy(q)[:, :, None],
                                 torch.from_numpy(k)[:, :, None],
                                 torch.from_numpy(v)[:, :, None],
                                 causal=causal, q_offset=off)
    np.testing.assert_allclose(_np(wrapped)[:, :, 0], np.asarray(want),
                               **_tol("f32"))


@pytest.mark.parametrize("window", [32, 100, 256])
def test_flash_attention_plain_sliding_window(window):
    rng = np.random.default_rng(window)
    q, k, v = (_randn(rng, 2, 256, 32) for _ in range(3))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=window, block_q=64, block_k=64,
                     interpret=True)
    got = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **_tol("f32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_dtypes(dtype):
    rng = np.random.default_rng(3)
    qkv = [_randn(rng, 2, 128, 64) for _ in range(3)]
    if dtype == "bfloat16":
        qkv = [a.astype(ml_dtypes.bfloat16) for a in qkv]
    want = ref_flash(*(jnp.asarray(a) for a in qkv), block_q=64, block_k=64,
                     interpret=True)
    from repro_torch import bridge
    got = fa.flash_attention_plain(*(bridge.to_torch(a, "cpu") for a in qkv))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("h,hkv,window", [(8, 2, 0), (25, 5, 48),
                                          (32, 8, 0)])
def test_gqa_flash_attention_matches_reference_wrapper(h, hkv, window):
    rng = np.random.default_rng(h)
    q = _randn(rng, 2, 128, h, 32)
    k, v = _randn(rng, 2, 128, hkv, 32), _randn(rng, 2, 128, hkv, 32)
    want = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, window=window, block_q=64, block_k=64,
                   interpret=True)
    got = kernel_ops.gqa_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **_tol("f32"))
    naive = ref_attn.naive_attention(
        jnp.asarray(q), ref_attn.repeat_kv(jnp.asarray(k), h),
        ref_attn.repeat_kv(jnp.asarray(v), h), causal=True, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(naive), **_tol("f32"))


@pytest.mark.parametrize("q_offset", [200, 140])
def test_rows_that_see_no_key_are_the_mean_of_v(q_offset):
    """Non-causal, window 32, 64 rows from ``q_offset`` over 128 keys:
    at 200 no row sees a key; at 140 the later rows see none.  The
    reference gives such a row the mean of v over all T keys."""
    rng = np.random.default_rng(q_offset)
    q, k, v = _randn(rng, 1, 64, 64), _randn(rng, 1, 128, 64), \
        _randn(rng, 1, 128, 64)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, window=32, q_offset=q_offset,
                     block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=False,
                                   window=32, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), np.asarray(want), **_tol("f32"))
    blind = [r for r in range(64) if q_offset + r - 31 > 127]
    assert blind
    np.testing.assert_allclose(_np(got)[0, blind],
                               np.broadcast_to(v[0].mean(0),
                                               (len(blind), 64)),
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 6, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4,
                                                                    16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 3,
                                                                    16))
    assert fa.launches == 0            # the CPU never launches the kernel


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

# the tensor-core kernel's tolerance against the f32 plain twin (both
# outputs in bf16), stated in chip_smoke.py's FA_TOL
TC_TOL = dict(rtol=8e-3, atol=1e-3)
# P rounded to bf16 once, before the split: a second rounding beside
# the output's
TC_TOL_P_SINGLE = dict(rtol=8e-3, atol=3e-3)
TC_BQ, TC_BK = 128, 128
LOG2E = 1.4426950408889634


def _tc_emulation(q, k, v, *, causal, window, q_offset, round_p=True,
                  split_p=True, bk=TC_BK):
    """The arithmetic of ``csrc/flash_attention.cu:
    flash_attention_tc_kernel`` in plain torch, for these tests only.
    q (B,S,H,D), k/v (B,T,Hkv,D) bf16 -> (out bf16, out before its
    rounding, f32).  Per (b, h) and 128-row block: the block's key range
    (the union of its rows' bands, or all T when a row sees no key);
    per 64-row warpgroup, the key tiles (``bk`` keys: 128, and 96 at
    D = 192) of that range it does not skip; scores of the bf16 values
    summed in f32, times scale*log2(e) (f32), masked by select (-1e30, or -inf past T); m, corr and
    p = 2^(s - m) in f32; l summed from the f32 p; P into P.V as two
    bf16 parts, P_hi = bf16(P) and P_lo = bf16(P - P_hi), O += P_hi.V +
    P_lo.V (``split_p``; with ``split_p=False``, P rounded to bf16 once,
    as the kernel did before; with ``round_p=False``, P in f32); O in
    f32, rescaled by corr; O / max(l, 1e-30)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    c = float(np.float32(np.float32(1.0 / np.sqrt(d)) * LOG2E))
    out = torch.zeros((b, s, h, d), dtype=torch.float32)
    for bi in range(b):
        for hi in range(h):
            qh = q[bi, :, hi].float()
            kh, vh = k[bi, :, hi // rep].float(), v[bi, :, hi // rep].float()
            for q0 in range(0, s, TC_BQ):
                p_first = q_offset + q0
                p_last = q_offset + min(q0 + TC_BQ, s) - 1
                blind = window > 0 and p_last - window + 1 >= t
                lo = 0 if blind or window <= 0 \
                    else max(0, p_first - window + 1)
                hi_ = t if blind or not causal else min(t, p_last + 1)
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
                    rows = (pa + torch.arange(n))[:, None]
                    m = torch.full((n,), -1e30)
                    l_run = torch.zeros(n)
                    o = torch.zeros(n, d)
                    for t0 in range(lo // bk * bk, hi_, bk):
                        if not wg_blind and (t0 >= w_hi
                                             or t0 + bk <= w_lo):
                            continue
                        keys = t0 + torch.arange(bk)
                        real = keys < t
                        kt = torch.zeros(bk, d)
                        vt = torch.zeros(bk, d)
                        kt[real], vt[real] = kh[keys[real]], vh[keys[real]]
                        sc = qh[r0:r0 + n] @ kt.T
                        vis = real[None, :].expand(n, bk)
                        if causal:
                            vis = vis & (keys[None, :] <= rows)
                        if window > 0:
                            vis = vis & (keys[None, :] > rows - window)
                        masked = torch.where(real, -1e30, -torch.inf)
                        sc = torch.where(vis, sc * c, masked[None, :]
                                         .expand(n, bk))
                        m_new = torch.maximum(m, sc.max(dim=1).values)
                        corr = torch.exp2(m - m_new)
                        p = torch.exp2(sc - m_new[:, None])
                        l_run = l_run * corr + p.sum(dim=1)
                        pv = p @ vt
                        if round_p:
                            p_hi = p.to(torch.bfloat16).float()
                            pv = p_hi @ vt
                            if split_p:
                                p_lo = (p - p_hi).to(torch.bfloat16).float()
                                pv = pv + p_lo @ vt
                        o = o * corr[:, None] + pv
                        m = m_new
                    out[bi, r0:r0 + n, hi] = \
                        o / torch.clamp(l_run, min=1e-30)[:, None]
    return out.to(torch.bfloat16), out


# (b, s, t, h, hkv, d, causal, window, q_offset): GQA 5:1 and 4:1, D
# 16/32/64, S and T off the 128 tile, q_offset > 0, windows off the
# tile, a block half blind and one wholly blind
TC_CASES = [(1, 200, 200, 5, 1, 64, True, 0, 0),
            (1, 200, 264, 4, 1, 32, True, 0, 64),
            (1, 300, 300, 5, 1, 64, True, 100, 0),
            (1, 260, 260, 4, 1, 64, True, 129, 0),
            (2, 130, 130, 4, 1, 16, False, 0, 0),
            (1, 150, 1000, 4, 2, 32, False, 0, 0),
            (1, 128, 128, 2, 1, 64, False, 32, 100),
            (1, 64, 128, 2, 1, 64, False, 32, 200)]


def _blind_rows(s, t, window, q_offset):
    return [r for r in range(s)
            if window > 0 and q_offset + r - window + 1 >= t]


@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,window,q_offset", TC_CASES)
def test_tc_arithmetic_within_the_bf16_tolerance(b, s, t, h, hkv, d, causal,
                                                 window, q_offset):
    """The tensor-core kernel's bf16 arithmetic (P split into two bf16
    parts, exp2, 128-key tiles) against the f32 plain twin and the JAX
    reference on the same bf16 inputs, at rtol 8e-3, atol 1e-3; rows
    that see no key are the mean of v."""
    rng = np.random.default_rng(s * t + d)
    qn, kn, vn = (_randn(rng, b, n, hh, d).astype(ml_dtypes.bfloat16)
                  for n, hh in ((s, h), (t, hkv), (t, hkv)))
    from repro_torch import bridge
    q, k, v = (bridge.to_torch(a, "cpu") for a in (qn, kn, vn))
    got, got_f32 = _tc_emulation(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    plain = fa.gqa_plain(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)
    assert plain.dtype == got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(plain), **TC_TOL)
    rep = h // hkv

    def fold(a):
        a = np.repeat(a, rep, axis=2) if a.shape[2] != h else a
        return jnp.asarray(np.moveaxis(a, 2, 1).reshape(b * h, -1, d))

    ref = flash_attention_ref(fold(qn), fold(kn), fold(vn), causal=causal,
                              window=window, q_offset=q_offset)
    ref = np.moveaxis(np.asarray(ref, np.float32).reshape(b, h, s, d), 1, 2)
    np.testing.assert_allclose(_np(got), ref, **TC_TOL)
    blind = _blind_rows(s, t, window, q_offset)
    if blind:
        mean_v = torch.repeat_interleave(v.float().mean(dim=1), rep, dim=1)
        torch.testing.assert_close(
            got_f32[:, blind], mean_v[:, None].expand(b, len(blind), h, d),
            rtol=0, atol=1e-6)


def test_tc_cases_cover_the_kernels_edges():
    """The cases above reach what the kernel treats specially: a block
    with a row that sees no key, a warpgroup that skips a tile, tails
    of S and T, all three head sizes."""
    def skips(s, t, causal, window, q_offset):
        for q0 in range(0, s, TC_BQ):
            p_last = q_offset + min(q0 + TC_BQ, s) - 1
            if window > 0 and p_last - window + 1 >= t:
                continue
            lo = max(0, q_offset + q0 - window + 1) if window > 0 else 0
            hi = min(t, p_last + 1) if causal else t
            for w in range(2):
                pa = q_offset + q0 + 64 * w
                n = min(64, s - q0 - 64 * w)
                if n <= 0:
                    continue
                w_lo = max(0, pa - window + 1) if window > 0 else 0
                w_hi = min(t, pa + n) if causal else t
                if any(t0 >= w_hi or t0 + TC_BK <= w_lo
                       for t0 in range(lo // TC_BK * TC_BK, hi, TC_BK)):
                    return True
        return False
    assert {c[5] for c in TC_CASES} == {16, 32, 64}
    assert any(s % TC_BQ and t % TC_BK for _, s, t, *_ in TC_CASES)
    assert any(_blind_rows(s, t, w, off) == list(range(s))
               for _, s, t, _, _, _, _, w, off in TC_CASES)
    assert any(0 < len(_blind_rows(s, t, w, off)) < s
               for _, s, t, _, _, _, _, w, off in TC_CASES)
    assert any(skips(s, t, c, w, off)
               for _, s, t, _, _, _, c, w, off in TC_CASES)


def test_tc_rounding_of_p_is_what_the_tolerance_is_for():
    """P rounded to bf16 once (the kernel before the split) is what
    needed atol 3e-3: on these N(0,1) inputs a few elements break the
    one-rounding bound (rtol 8e-3, atol 1e-3) of the f32 plain twin, and
    all stay within 3e-3; P in f32, and P split in two bf16 parts, stay
    within the one-rounding bound."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 640, 5, 64))
               .to(torch.bfloat16) for _ in range(3))
    k, v = k[:, :, :1], v[:, :, :1]
    plain = _np(fa.gqa_plain(q, k, v, causal=True))
    exact_p, _ = _tc_emulation(q, k, v, causal=True, window=0, q_offset=0,
                               round_p=False)
    np.testing.assert_allclose(_np(exact_p), plain, **TC_TOL)
    split, _ = _tc_emulation(q, k, v, causal=True, window=0, q_offset=0)
    np.testing.assert_allclose(_np(split), plain, **TC_TOL)
    single, _ = _tc_emulation(q, k, v, causal=True, window=0, q_offset=0,
                              split_p=False)
    assert not np.allclose(_np(single), plain, **TC_TOL)
    np.testing.assert_allclose(_np(single), plain, **TC_TOL_P_SINGLE)


@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,window,q_offset", TC_CASES)
def test_tc_split_p_is_f32_p_to_its_residual(b, s, t, h, hkv, d, causal,
                                             window, q_offset):
    """Before the output's rounding, P.V with P split in two bf16 parts
    is P.V with P in f32 to about 2^-16 of the output's scale (the
    residual of the split), where one bf16 rounding of P leaves 2^-9."""
    rng = np.random.default_rng(s + t + d)
    q, k, v = (torch.from_numpy(_randn(rng, b, n, hh, d)).to(torch.bfloat16)
               for n, hh in ((s, h), (t, hkv), (t, hkv)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, exact = _tc_emulation(q, k, v, round_p=False, **kw)
    _, split = _tc_emulation(q, k, v, **kw)
    _, single = _tc_emulation(q, k, v, split_p=False, **kw)
    scale = float(exact.abs().max())
    split_err = float((split - exact).abs().max())
    single_err = float((single - exact).abs().max())
    assert split_err <= 2.0 ** -14 * scale
    assert split_err <= single_err / 16    # equal (0) where P is 1


@pytest.mark.parametrize("view,ok", [
    ("contiguous", True), ("fused-qkv-head-slices", True),
    ("d16-fused-head-slices", True), ("offset-by-one-element", False),
    ("head-stride-72-bytes", False), ("row-stride-100-bytes", False)])
def test_tma_alignment_rule(view, ok):
    """The bf16 kernel's TMA maps need 16-byte addresses and byte
    strides; the wrapper refuses anything else (``tma_misalignment``)."""
    bf = torch.bfloat16
    t = {"contiguous": lambda: torch.zeros(2, 8, 4, 64, dtype=bf),
         "fused-qkv-head-slices":
             lambda: torch.zeros(2, 300, 12, 64, dtype=bf)[:, :, 8:10],
         "d16-fused-head-slices":
             lambda: torch.zeros(2, 10, 12, 16, dtype=bf)[:, :, 10:],
         "offset-by-one-element":
             lambda: torch.zeros(1, 8, 2, 80, dtype=bf)[..., 1:65],
         "head-stride-72-bytes":
             lambda: torch.zeros(1, 8, 2, 36, dtype=bf)[..., :32],
         "row-stride-100-bytes":
             lambda: torch.zeros(1, 8, 50, dtype=bf)[..., :16]
             .unsqueeze(2)}[view]()
    assert t.data_ptr() % 16 == 0 or view == "offset-by-one-element"
    why = fa.tma_misalignment(t)
    assert (why == "") == ok, why


# ---------------------------------------------------------------------------
# the model's attention paths vs the reference's
# ---------------------------------------------------------------------------

def _qkv(seed, b, s, h, d, t=None, hkv=None):
    rng = np.random.default_rng(seed)
    t, hkv = t or s, hkv or h
    return _randn(rng, b, s, h, d), _randn(rng, b, t, hkv, d), \
        _randn(rng, b, t, hkv, d)


def _both(fn_pt, fn_ref, arrays, **kw):
    got = fn_pt(*(torch.from_numpy(a) for a in arrays), **kw)
    want = fn_ref(*(jnp.asarray(a) for a in arrays), **kw)
    return _np(got), np.asarray(want)


@pytest.mark.parametrize("cq,ckv", [(64, 64), (128, 256), (256, 128)])
def test_chunked_matches_reference_causal(cq, ckv):
    got, want = _both(attn.chunked_attention, ref_attn.chunked_attention,
                      _qkv(0, 2, 512, 4, 32), causal=True, chunk_q=cq,
                      chunk_kv=ckv)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_chunked_matches_reference_bidirectional():
    got, want = _both(attn.chunked_attention, ref_attn.chunked_attention,
                      _qkv(1, 2, 256, 2, 16), causal=False, chunk_q=64,
                      chunk_kv=64)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [64, 200, 384])
def test_banded_matches_reference_window(window):
    arrays = _qkv(2, 2, 512, 2, 16)
    got, want = _both(attn.banded_attention, ref_attn.banded_attention,
                      arrays, window=window, chunk_q=128, chunk_kv=128)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    naive = ref_attn.naive_attention(*(jnp.asarray(a) for a in arrays),
                                     causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(naive), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("h,s,d", [(2, 128, 16), (4, 256, 16), (8, 128, 32)])
def test_naive_matches_reference(h, s, d):
    got, want = _both(attn.naive_attention, ref_attn.naive_attention,
                      _qkv(3, 1, s, h, d), causal=True)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_chunked_and_banded_take_unrepeated_kv():
    """GQA k/v with Hkv heads give the reference's result on its
    head-expanded k/v."""
    q, k, v = _qkv(4, 1, 512, 8, 16, hkv=2)
    kx = np.repeat(k, 4, axis=2)
    vx = np.repeat(v, 4, axis=2)
    for fn, ref, kw in ((attn.chunked_attention, ref_attn.chunked_attention,
                         dict(chunk_q=128, chunk_kv=128)),
                        (attn.banded_attention, ref_attn.banded_attention,
                         dict(window=100, chunk_q=128, chunk_kv=128))):
        got = fn(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), **kw)
        want = ref(jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), **kw)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_repeat_kv_matches_reference():
    k = np.arange(2 * 4 * 2 * 3, dtype=np.float32).reshape(2, 4, 2, 3)
    got = attn.repeat_kv(torch.from_numpy(k), 6)
    assert tuple(got.shape) == (2, 4, 6, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_attn.repeat_kv(
                                      jnp.asarray(k), 6)))


@pytest.mark.parametrize("s,t,window,route", [
    (128, 128, 0, "naive"),          # s*t <= 256*256
    (512, 512, 0, "chunked"),
    (512, 512, 64, "banded"),
    (512, 512, 1024, "chunked"),     # window >= t: the full mask
    (384, 384, 0, "naive"),          # chunk_kv 256 does not divide 384
])
def test_attention_dispatch_matches_reference(s, t, window, route,
                                              monkeypatch):
    q, k, v = _qkv(5, 1, s, 4, 16, t=t, hkv=2)
    seen = []
    for name in ("naive", "chunked", "banded"):
        real = getattr(attn, f"{name}_attention")
        monkeypatch.setattr(attn, f"{name}_attention",
                            lambda *a, _n=name, _r=real, **kw:
                            (seen.append(_n), _r(*a, **kw))[1])
    kw = dict(causal=True, window=window, chunk_q=128, chunk_kv=256)
    got = attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), **kw)
    want = ref_attn.attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw)
    assert seen == [route]
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_context_parallel_always_waits_for_the_mesh(monkeypatch):
    """The name is historical: "always" once raised here until a mesh
    existed.  Now, with no mesh, "always" takes the context-parallel
    branch over a model axis of 1, as the reference does (the mesh
    itself is ``tests/test_torch_mesh.py``'s), and "auto" never takes
    it."""
    arrays = _qkv(6, 1, 512, 4, 16)
    seen = []
    real = attn.chunked_attention_cp
    monkeypatch.setattr(attn, "chunked_attention_cp",
                        lambda *a, **kw: (seen.append(1), real(*a, **kw))[1])
    got, want = _both(attn.attention, ref_attn.attention, arrays,
                      context_parallel="always")
    assert seen == [1]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    attn.attention(*(torch.from_numpy(a) for a in arrays),
                   context_parallel="auto")
    assert seen == [1]


# ---------------------------------------------------------------------------
# the CUDA branches, by routing
# ---------------------------------------------------------------------------

def _recording(calls):
    """``gqa_flash_attention`` as the plain twin, each call's shapes and
    keywords recorded."""
    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return fa.gqa_plain(q, k, v, **kw)
    return recording


# (port function, reference function, keywords): every route that can
# reach the kernel, at S = T = 512 with chunks of 128
SOFTCAP_ROUTES = {
    "chunked": (attn.chunked_attention, ref_attn.chunked_attention,
                dict(causal=True)),
    "banded": (attn.banded_attention, ref_attn.banded_attention,
               dict(causal=True, window=64)),
    "banded_non_causal": (attn.banded_attention, ref_attn.banded_attention,
                          dict(causal=False, window=64)),
    "chunked_cp": (attn.chunked_attention_cp, ref_attn.chunked_attention_cp,
                   dict(causal=True)),
    "banded_cp": (attn.banded_attention_cp, ref_attn.banded_attention_cp,
                  dict(causal=True, window=64)),
    "banded_cp_non_causal": (attn.banded_attention_cp,
                             ref_attn.banded_attention_cp,
                             dict(causal=False, window=64))}


@pytest.mark.parametrize("route", sorted(SOFTCAP_ROUTES))
def test_kernel_route_receives_the_softcap(route, monkeypatch):
    """Routed as on a CUDA tensor, every route hands the kernel the
    softcap, and the result equals the reference's with that softcap
    (2e-5, f32); the cap bites here: without it the result moves."""
    fn, ref_fn, kw = SOFTCAP_ROUTES[route]
    kw = dict(kw, chunk_q=128, chunk_kv=128)
    calls = []
    monkeypatch.setattr(attn, "_kernel_route", lambda q: True)
    monkeypatch.setattr(kernel_ops, "gqa_flash_attention",
                        _recording(calls))
    q, k, v = _qkv(31, 1, 512, 4, 16, hkv=2)
    q = 4.0 * q                            # scores of several caps
    got = fn(*(torch.from_numpy(x) for x in (q, k, v)), softcap=5.0, **kw)
    # the reference's branches take k/v repeated to the q heads
    ref_in = (jnp.asarray(q), ref_attn.repeat_kv(jnp.asarray(k), 4),
              ref_attn.repeat_kv(jnp.asarray(v), 4))
    want = np.asarray(ref_fn(*ref_in, softcap=5.0, **kw))
    assert calls and all(c[2]["softcap"] == 5.0 for c in calls)
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)
    uncapped = ref_fn(*ref_in, **kw)
    assert np.abs(np.asarray(uncapped) - want).max() > 100 * 2e-5


def test_softcap_with_a_gradient_raises_before_any_launch(monkeypatch):
    """A softcap with an input that requires grad raises nothing now: on
    the wrapper and through the model's kernel route it reaches
    ``FlashAttentionFn`` with the cap beside the masks (on the CPU its
    plain forward and backward, no library loaded, no launch counted),
    and the gradients are autograd's of the capped twin (1e-4).  Without
    grad the same call is the twin's and no Function runs."""
    def no_library():
        raise AssertionError("the library was asked for")

    applied = []
    real = fa.FlashAttentionFn.apply

    def recording(*a):
        applied.append(a[3:])
        return real(*a)

    monkeypatch.setattr(fa, "_lib", no_library)
    monkeypatch.setattr(fa.FlashAttentionFn, "apply", recording)
    monkeypatch.setattr(attn, "_kernel_route", lambda q: True)
    q, k, v = (torch.from_numpy(x) for x in _qkv(32, 1, 512, 4, 16))
    q = 8.0 * q                              # scores of several caps
    before = fa.launches
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    cot = torch.from_numpy(_qkv(33, 1, 512, 4, 16)[0])
    for out in (fa.flash_attention(*ins, softcap=3.0),
                attn.attention(*ins, softcap=3.0, chunk_q=128,
                               chunk_kv=128)):
        got = torch.autograd.grad(out, ins, cot)
        ref = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        want = torch.autograd.grad(fa.gqa_plain(*ref, softcap=3.0), ref, cot)
        for g, w in zip(got, want):
            torch.testing.assert_close(
                g, w, rtol=1e-4, atol=1e-4 * max(1.0, float(w.abs().max())))
    assert applied == [(True, 0, 0, 3.0)] * 2
    assert fa.launches == before
    with torch.no_grad():
        got = attn.attention(*ins, softcap=30.0, chunk_q=128, chunk_kv=128)
    want = fa.gqa_plain(q, k, v, softcap=30.0)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert len(applied) == 2


@pytest.mark.parametrize("window", [0, 64])
def test_kernel_branches_hand_the_kernel_unrepeated_kv(window, monkeypatch):
    """On the card the chunked and banded branches are one call of
    ``gqa_flash_attention`` on the k/v as they are (Hkv heads)."""
    calls = []

    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return fa.gqa_plain(q, k, v, **kw)

    monkeypatch.setattr(attn, "_kernel_route", lambda q: True)
    monkeypatch.setattr(kernel_ops, "gqa_flash_attention", recording)
    q, k, v = _qkv(7, 1, 512, 25, 16, hkv=5)
    got = attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True, window=window,
                         chunk_q=128, chunk_kv=128)
    assert calls == [((1, 512, 25, 16), (1, 512, 5, 16), (1, 512, 5, 16),
                      dict(causal=True, window=window, q_offset=0,
                           softcap=0.0))]
    want = ref_attn.attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True, window=window,
                              chunk_q=128, chunk_kv=128)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# (s, t, q_offset): the band cuts keys off on both sides, and q rows
# past the start of k
BAND_CASES = [(512, 512, 0), (256, 512, 128)]


@pytest.mark.parametrize("s,t,q_offset", BAND_CASES)
@pytest.mark.parametrize("cp", [False, True])
def test_non_causal_band_route_matches_the_reference(s, t, q_offset, cp,
                                                     monkeypatch):
    """Non-causal banded attention routed as on a CUDA tensor is one
    kernel call a q chunk on that chunk's band of k/v (``first*ckv`` to
    ``(first + nb)*ckv``, un-repeated) at ``q_offset + qs - first*ckv``;
    the output equals the reference's ``banded_attention`` /
    ``banded_attention_cp`` with ``causal=False`` (2e-5) and its
    gradients ``jax.grad`` of it (1e-4, the backward twins' tolerance).
    The band cuts visible keys here: full-window attention differs."""
    fn = attn.banded_attention_cp if cp else attn.banded_attention
    ref_fn = ref_attn.banded_attention_cp if cp else ref_attn.banded_attention
    kw = dict(window=64, causal=False, q_offset=q_offset, chunk_q=128,
              chunk_kv=128)
    q, k, v = _qkv(33 + s, 1, s, 4, 16, t=t, hkv=2)
    w = _randn(np.random.default_rng(5), 1, s, 4, 16)
    calls = []
    monkeypatch.setattr(attn, "_kernel_route", lambda q: True)

    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return fa.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(kernel_ops, "gqa_flash_attention", recording)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ins, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ins)

    nb = min((64 - 1 + 128 + 128 - 1) // 128 + 1, t // 128)
    firsts = [min(max((qs - 63 + q_offset) // 128, 0), t // 128 - nb)
              for qs in range(0, s, 128)]
    assert [c[0] for c in calls] == [(1, 128, 4, 16)] * (s // 128)
    assert [c[1] for c in calls] == [(1, nb * 128, 2, 16)] * (s // 128)
    assert [c[2] for c in calls] == [
        dict(causal=False, window=64, q_offset=q_offset + qs - f * 128,
             softcap=0.0) for qs, f in zip(range(0, s, 128), firsts)]

    def loss(q, k, v):           # the reference's branches repeat k/v
        return (ref_fn(q, ref_attn.repeat_kv(k, 4), ref_attn.repeat_kv(v, 4),
                       **kw) * jnp.asarray(w)).sum()

    jx = [jnp.asarray(x) for x in (q, k, v)]
    want = np.asarray(ref_fn(jx[0], ref_attn.repeat_kv(jx[1], 4),
                             ref_attn.repeat_kv(jx[2], 4), **kw))
    np.testing.assert_allclose(_np(out.detach()), want, rtol=2e-5,
                               atol=2e-5)
    for g, wg in zip(grads, jax.grad(loss, argnums=(0, 1, 2))(*jx)):
        wg = np.asarray(wg)
        np.testing.assert_allclose(_np(g), wg, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(wg).max()))
    full = ref_attn.naive_attention(*(jnp.asarray(x) for x in (
        q, ref_attn.repeat_kv(k, 4), ref_attn.repeat_kv(v, 4))),
        causal=False, window=64, q_offset=q_offset)
    assert np.abs(np.asarray(full) - want).max() > 100 * 2e-5


# ---------------------------------------------------------------------------
# the logit softcap in the twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 192])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0), (False, 24)])
@pytest.mark.parametrize("cap", [5.0, 50.0])
def test_softcap_twins_match_the_reference_naive_attention(d, causal,
                                                           window, cap):
    """``gqa_plain`` / ``flash_attention_plain`` with a softcap against
    the reference's ``naive_attention(softcap=)`` on k/v repeated per
    group (2e-5, f32), q scaled so that the scores reach several caps;
    ``flash_attention_fwd_plain``'s lse is the log-sum-exp of the capped,
    masked scores."""
    q, k, v = _qkv(40 + d, 2, 48, 4, d, t=64, hkv=2)
    q = q * (2.0 * cap / 5.0)
    kw = dict(causal=causal, window=window, q_offset=16)
    want = ref_attn.naive_attention(
        jnp.asarray(q), ref_attn.repeat_kv(jnp.asarray(k), 4),
        ref_attn.repeat_kv(jnp.asarray(v), 4), softcap=cap, **kw)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got = fa.gqa_plain(qt, kt, vt, softcap=cap, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    out, lse = fa.flash_attention_fwd_plain(qt, kt, vt, softcap=cap, **kw)
    assert torch.equal(out, got)
    scores = np.einsum("bshd,bthd->bhst", q, np.repeat(k, 2, axis=2))
    scores = np.tanh(scores / np.sqrt(d) / cap) * cap
    m = np.asarray(fa._mask(48, 64, causal, window, 16, "cpu"))
    scores = np.where(m, scores, -1e30)
    top = scores.max(-1, keepdims=True)
    want_lse = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True)))
    np.testing.assert_allclose(lse.numpy(), want_lse[..., 0], rtol=2e-5,
                               atol=2e-5)
    uncapped = fa.gqa_plain(qt, kt, vt, **kw)
    assert (uncapped - got).abs().max() > 100 * 2e-5


# ---------------------------------------------------------------------------
# decode through the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,hq,hkv,d,w", [(24, 4, 2, 16, 0),
                                          (32, 2, 2, 8, 8)])
def test_decode_ring_cache_matches_reference(s, hq, hkv, d, w):
    """Sequential decode through a ring cache (of size W when windowed,
    so old entries are overwritten) against the reference's, step by
    step, and against full attention."""
    rng = np.random.default_rng(s)
    q, k, v = _randn(rng, 1, s, hq, d), _randn(rng, 1, s, hkv, d), \
        _randn(rng, 1, s, hkv, d)
    cache_len = w or s
    cache = attn.init_kv_cache(1, cache_len, hkv, d, dtype=torch.float32,
                               device="cpu")
    ref_cache = ref_attn.init_kv_cache(1, cache_len, hkv, d,
                                       dtype=jnp.float32)
    outs = []
    for t in range(s):
        cache = attn.update_kv_cache(cache, torch.from_numpy(k[:, t:t + 1]),
                                     torch.from_numpy(v[:, t:t + 1]), t)
        ref_cache = ref_attn.update_kv_cache(
            ref_cache, jnp.asarray(k[:, t:t + 1]),
            jnp.asarray(v[:, t:t + 1]), jnp.asarray(t))
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(ref_cache["pos"]))
        got = attn.decode_attention(torch.from_numpy(q[:, t:t + 1]), cache,
                                    t, window=w)
        want = ref_attn.decode_attention(jnp.asarray(q[:, t:t + 1]),
                                         ref_cache, jnp.asarray(t), window=w)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
        outs.append(_np(got))
    full = ref_attn.naive_attention(
        jnp.asarray(q), ref_attn.repeat_kv(jnp.asarray(k), hq),
        ref_attn.repeat_kv(jnp.asarray(v), hq), causal=True, window=w)
    np.testing.assert_allclose(np.concatenate(outs, 1), np.asarray(full),
                               rtol=2e-5, atol=2e-5)


def test_update_kv_cache_writes_in_place():
    cache = attn.init_kv_cache(2, 4, 1, 8, dtype=torch.float32,
                               device="cpu")
    k_buf = cache["k"]
    out = attn.update_kv_cache(cache, torch.ones(2, 1, 1, 8),
                               torch.ones(2, 1, 1, 8), 5)
    assert out is cache and out["k"] is k_buf
    assert cache["pos"].tolist() == [-1, 5, -1, -1]
    assert float(k_buf[:, 1].sum()) == 16.0


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"
