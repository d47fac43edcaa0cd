"""The capped bf16 kernels' tanh (``csrc/fa_hopper.cuh: softcap_r``): one
``ex2`` and one ``rcp`` without a branch, modelled in torch by
``flash_attention.softcap_log2_model``.

``r = 1 / (1 + 2^(s k2))`` with ``k2 = 2 log2(e) scale / cap`` gives
``tanh(s scale / cap) = 1 - 2r``, so the capped score in the log2 domain
is ``cap_log2 (1 - 2r)`` and the backward's ``1 - tanh^2`` is ``4 r (1 -
r)``.  The model is held against ``cap log2(e) tanh(s scale / cap)`` in
f64 over a sweep of scores (0, subnormals, 1e-3 to 1e4 on both sides,
around the caps of ``chip_smoke.py: SOFTCAP_CAPS``, infinities), with
the special-function results also off by the PTX ISA's bounds of the
approximations (``ex2.approx.ftz.f32`` 2^-22 relative, ``rcp.approx``
one ulp, 2^-23): within 2^-20 x cap_log2, ±inf to ±cap_log2 exactly, NaN
to NaN.  Then the slice: capped attention, its lse and dq built on the
model against the JAX package's capped attention, its log-sum-exp and
``jax.grad`` (1e-4, the f32 twins' tolerance); and a source check that
the three bf16 CAP paths call the helper and the f32 kernels keep
``tanhf``.  The kernels themselves run only on the card
(``chip_smoke.py: softcap_checks``, ``softcap_bwd_checks``)."""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parent / "csrc"
CAPS = (5.0, 50.0)                 # chip_smoke.py: SOFTCAP_CAPS
SCALES = (1 / 8, 1 / math.sqrt(80))
# the approximations' relative errors at the PTX ISA's bounds: (ex2, rcp)
ERRS = [(0.0, 0.0)] + [(a * 2.0 ** -22, b * 2.0 ** -23)
                       for a in (-1, 1) for b in (-1, 1)]
BOUND = 2.0 ** -20                 # of cap_log2, absolute
LOG2E = math.log2(math.e)


def _sweep(scale, cap):
    """Raw scores (before the scale): 0, subnormals, scaled scores from
    1e-3 to 1e4 and around the cap (0.5x to 2x), on both sides."""
    mags = np.concatenate([np.logspace(-3, 4, 400),
                           cap * np.linspace(0.5, 2.0, 151)]) / scale
    x = np.concatenate([[0.0], mags, -mags]).astype(np.float32)
    sub = np.array([1e-45, 1e-40, -1e-45, -1e-40], dtype=np.float32)
    return torch.from_numpy(np.concatenate([x, sub]))


def _exact(s_, scale, cap):
    return cap * LOG2E * torch.tanh(s_.double() * scale / cap)


@pytest.mark.parametrize("errs", ERRS)
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("cap", CAPS)
def test_capped_score_is_within_2_pow_minus_20_of_cap_log2(cap, scale, errs):
    s_ = _sweep(scale, cap)
    got, r = fa.softcap_log2_model(s_, scale, cap, ex2_err=errs[0],
                                   rcp_err=errs[1])
    assert got.dtype == torch.float32 and r.dtype == torch.float32
    err = (got.double() - _exact(s_, scale, cap)).abs().max().item()
    assert err <= BOUND * cap * LOG2E, (err, BOUND * cap * LOG2E)


@pytest.mark.parametrize("errs", ERRS)
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("cap", CAPS)
def test_four_r_one_minus_r_is_one_minus_tanh_squared(cap, scale, errs):
    s_ = _sweep(scale, cap)
    _, r = fa.softcap_log2_model(s_, scale, cap, ex2_err=errs[0],
                                 rcp_err=errs[1])
    got = 4.0 * torch.addcmul(r, r, r, value=-1.0)      # fmaf(-r, r, r)
    want = 1.0 - torch.tanh(s_.double() * scale / cap) ** 2
    err = (got.double() - want).abs().max().item()
    assert err <= BOUND, err


@pytest.mark.parametrize("cap", CAPS)
def test_infinities_saturate_exactly_and_nan_stays_nan(cap):
    cap_log2 = torch.tensor(cap * LOG2E, dtype=torch.float32)
    s_ = torch.tensor([math.inf, -math.inf, math.nan, 1e30, -1e30])
    got, r = fa.softcap_log2_model(s_, 0.125, cap)
    assert got[0] == cap_log2 and got[3] == cap_log2
    assert got[1] == -cap_log2 and got[4] == -cap_log2
    assert torch.equal(r[[0, 1, 3, 4]], torch.tensor([0.0, 1.0, 0.0, 1.0]))
    assert torch.isnan(got[2]) and torch.isnan(r[2])


def test_zero_and_subnormals_give_a_zero_score():
    s_ = torch.tensor([0.0, 1e-45, -1e-45, 1e-40])
    got, r = fa.softcap_log2_model(s_, 0.125, 50.0)
    assert torch.equal(got, torch.zeros(4))
    assert torch.equal(r, torch.full((4,), 0.5))


# -- the slice: capped attention on the model against the JAX package --------

def _inputs(seed, b, s, t, h, hkv, d, cap):
    """q scaled by 2 caps (scores reach several caps), k, v, dO."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
             for _ in "qd")
    k, v = (rng.standard_normal((b, t, hkv, d)).astype(np.float32)
            for _ in "kv")
    return q * np.float32(2 * cap), k, v, do


def _model_attention(q, k, v, do, cap, errs, **kw):
    """The capped bf16 kernels' arithmetic on the model, in f32 (heads
    folded, k/v repeated per group): the capped scores in the log2
    domain, the forward's exponents on the running max (masks at -1e30);
    out, lse (natural units), and the gradients from P = 2^(capped - lse)
    and dS = P (dP - delta) 4 r (1 - r), as dq and dkdv form them: dq,
    and dk, dv summed over each kv head's group of q heads.  Returns
    (out, lse, dq, dk, dv)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.movedim(2, 1) for x in
                       (q, fa.repeat_kv_heads(k, h), fa.repeat_kv_heads(v, h),
                        do))
    raw = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    c, r = fa.softcap_log2_model(raw, scale, cap, ex2_err=errs[0],
                                 rcp_err=errs[1])
    keep = fa._mask(s, t, q_offset=kw.get("q_offset", 0),
                    causal=kw.get("causal", True), window=kw.get("window", 0),
                    device="cpu")
    c = torch.where(keep, c, torch.tensor(fa.NEG))
    m = c.amax(-1, keepdim=True)
    e = torch.exp2(c - m)
    lse2 = m + torch.log2(e.sum(-1, keepdim=True))
    out = torch.einsum("bhst,bhtd->bhsd", e / e.sum(-1, keepdim=True), vf)
    p = torch.where(keep, torch.exp2(c - lse2), torch.zeros(()))
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    delta = (dof * out).sum(-1, keepdim=True)
    ds = p * (dp - delta) * (4.0 * torch.addcmul(r, r, r, value=-1.0))
    dq = scale * torch.einsum("bhst,bhtd->bhsd", ds, kf)
    hkv = k.shape[2]

    def group_sum(x):                      # (b, h, t, d) -> (b, t, hkv, d)
        return x.reshape(b, hkv, h // hkv, t, d).sum(2).movedim(1, 2)
    dk = group_sum(scale * torch.einsum("bhst,bhsd->bhtd", ds, qf))
    dv = group_sum(torch.einsum("bhst,bhsd->bhtd", p, dof))
    return out.movedim(1, 2), lse2[..., 0] / LOG2E, dq.movedim(1, 2), dk, dv


MASKS = {"causal": (1, 24, 40, 4, 2, True, 0, 16),
         "window": (2, 24, 24, 4, 1, True, 8, 0),
         "full-window": (1, 20, 48, 4, 2, False, 12, 20)}


@pytest.mark.parametrize("errs", [ERRS[0], ERRS[-1]])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_model_attention_lse_and_dq_match_the_reference(mask, cap, errs):
    """Out, lse and dq on the model against the reference's capped
    attention, its log-sum-exp of ``_softcap`` scores and ``jax.grad``
    (1e-4)."""
    b, s, t, h, hkv, causal, window, q_offset = MASKS[mask]
    d = 32
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = _inputs(d + int(cap), b, s, t, h, hkv, d, cap)

    def ref(q_):
        return ref_attn.naive_attention(
            q_, ref_attn.repeat_kv(jnp.asarray(k), h),
            ref_attn.repeat_kv(jnp.asarray(v), h), softcap=cap, **kw)

    want = np.asarray(ref(jnp.asarray(q)))
    want_dq = np.asarray(jax.grad(lambda q_: jnp.sum(ref(q_) * do))(
        jnp.asarray(q)))
    kx = ref_attn.repeat_kv(jnp.asarray(k), h)
    sc = ref_attn._softcap(jnp.einsum("bshd,bthd->bhst", jnp.asarray(q), kx)
                           / np.sqrt(d), cap)
    keep = np.asarray(fa._mask(s, t, causal, window, q_offset, "cpu"))
    want_lse = np.asarray(jax.nn.logsumexp(jnp.where(keep, sc, -1e30),
                                           axis=-1))
    out, lse, dq, _, _ = _model_attention(
        *(torch.from_numpy(x) for x in (q, k, v, do)), cap, errs, **kw)
    for got, w in ((out, want), (lse, want_lse), (dq, want_dq)):
        np.testing.assert_allclose(
            got.numpy(), w, rtol=1e-4,
            atol=1e-4 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("errs", [ERRS[0], ERRS[-1]])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_model_dk_and_dv_match_the_reference(mask, cap, errs):
    """dk and dv on the model (P and 4 r (1 - r) of ``softcap_r``, as the
    capped dkdv forms dS^T, summed over each GQA group) against
    ``jax.grad`` of the reference's capped attention with respect to k
    and v (1e-4, as dq)."""
    b, s, t, h, hkv, causal, window, q_offset = MASKS[mask]
    d = 32
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = _inputs(d + int(cap), b, s, t, h, hkv, d, cap)

    def loss(k_, v_):
        o = ref_attn.naive_attention(
            jnp.asarray(q), ref_attn.repeat_kv(k_, h),
            ref_attn.repeat_kv(v_, h), softcap=cap, **kw)
        return jnp.sum(o * do)

    want_dk, want_dv = (np.asarray(g) for g in jax.grad(loss, (0, 1))(
        jnp.asarray(k), jnp.asarray(v)))
    _, _, _, dk, dv = _model_attention(
        *(torch.from_numpy(x) for x in (q, k, v, do)), cap, errs, **kw)
    for got, w in ((dk, want_dk), (dv, want_dv)):
        assert got.shape == w.shape == (b, t, hkv, d)
        np.testing.assert_allclose(
            got.numpy(), w, rtol=1e-4,
            atol=1e-4 * max(1.0, float(np.abs(w).max())))


# -- the sources ---------------------------------------------------------------

def _body(src, start, end):
    i = src.index(start)
    return src[i:src.index(end, i)]


def test_bf16_cap_paths_call_the_helper_and_f32_keeps_tanhf():
    hopper = (CSRC / "fa_hopper.cuh").read_text()
    helper = _body(hopper, "float softcap_r(", "}")
    assert "rcp(1.0f + ex2(s * k2))" in helper
    assert "2.0 * 1.4426950408889634 * (double)scale / softcap" in hopper
    assert 'asm("rcp.approx.ftz.f32 %0, %1;\\n"' in hopper
    fwd = (CSRC / "flash_attention.cu").read_text()
    tile = _body(fwd, "void softmax_tile(", "void rescale(")
    assert tile.count("softcap_r(s[i], k2)") == 2 and "tanhf" not in tile
    assert "softcap_k2(scale, CAP ? softcap : 0.0f)" in fwd
    assert "tanhf(s / cap)" in _body(fwd, "float fa_softcap(", "}")
    bwd_tc = (CSRC / "flash_attention_bwd_tc.cu").read_text()
    assert "tanhf" not in bwd_tc
    dq = _body(bwd_tc, "fa_bwd_tc_dq_kernel(", "// ---- dk, dv")
    assert dq.count("softcap_r(s[i], k2)") == 1
    # CAP tiles and items on the masked path in both kernels
    assert "if (!CAP && t0 + BK <= T && r0 + 64 <= S" in dq
    dkdv = _body(bwd_tc, "fa_bwd_tc_dkdv_kernel(", "// ---- host side")
    # dkdv's CAP items on both paths: the interior one caps without the
    # masks (one helper call each)
    assert dkdv.count("softcap_r(s[e], k2)") == 2
    assert "if (r0 + BM <= S && kw0 + 64 <= T" in dkdv
    assert "if (!CAP && r0 + BM <= S" not in dkdv
    # dkdv's CAP item: P^T and 1 - t^2 = 4 r (1 - r) formed under dP^T's
    # product (no wait for both products first), dS^T from the kept
    # factor; below D = 128 dV issued before dP^T is waited for and dS^T
    # split into a second set of parts
    assert "both products waited on" not in dkdv
    assert dkdv.count("float dtanh[CAP ? 32 : 1];") == 1
    assert dkdv.count("dtanh[e] = none ? 0.0f : fmaf(-r, r, r);") == 1
    assert dkdv.count("if (!SPLIT || w) dtanh[e] = fmaf(-r, r, r);") == 1
    # from D = 128 dS^T / 4 in P^T's place in the dk warpgroup, then the
    # second product as without a cap (one product tail shared)
    assert dkdv.count("s[e] *= (dp[e] - dl_c[col]) * dtanh[e];") == 1
    assert dkdv.count("if constexpr (CAP && !SPLIT) {") == 1
    assert dkdv.count("} else if constexpr (SPLIT) {") == 1
    assert dkdv.count("s[e] *= dtanh[e];") == 1
    # the 4 of 1 - t^2 = 4 r (1 - r) in dk's scale
    assert "const float dk_mul = CAP ? 4.0f * scale : scale;" in dkdv
    masked = dkdv[dkdv.index("const bool none"):]
    assert "blind |=" not in _body(masked, "if constexpr (CAP) {",
                                   "} else {")
    for i in (0, 1):
        at = dkdv.index("softcap_r(s[e], k2)")
        at = dkdv.index("softcap_r(s[e], k2)", at + 1) if i else at
        cap_loop = _body(dkdv[at:], "softcap_r(s[e], k2)", "} else {")
        assert "dp[e]" not in cap_loop and "wgmma_wait" not in cap_loop
    early = _body(dkdv, "wgmma_parts<D, BM>(acc_v, hi, lo, s_do);\n",
                  "wgmma_parts<D, BM>(acc, ds_hi, ds_lo, s_q);")
    assert "wgmma_wait<1>();" in early
    assert "split_frags(dp, ds_hi, ds_lo);" in early
    assert bwd_tc.count("softcap_k2(scale, softcap)") == 2
    for name in ("flash_attention_softcap.cu",
                 "flash_attention_bwd_tc_softcap.cu"):
        assert "tanhf(" not in (CSRC / name).read_text()
    # the f32 pair keeps the accurate tanh
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    assert re.search(r"th = tanhf\(s / cap\);", bwd)
    assert "softcap_r(" not in bwd


def test_design_floor_counts_three_sfu_operations_a_visible_pair():
    """``roofline/cost.py: sfu_floor_ms``, the capped bf16 kernels'
    floor that ``chip_smoke.py`` prints beside their bounds: three SFU
    operations (the tanh's ex2 and rcp, the exp) a visible pair, 1.5x
    the bound's two, at llama's serving layer."""
    from repro_torch.roofline import cost
    qs, ks = (2, 4096, 32, 64), (2, 4096, 8, 64)
    pairs = 2 * 32 * cost.visible_pairs(4096, 4096, True, 0, 0)
    floor = cost.sfu_floor_ms(qs, ks, cost.SOFTCAP_TC_SFU_PER_PAIR)
    assert cost.SOFTCAP_TC_SFU_PER_PAIR == 3
    assert floor == pytest.approx(3 * pairs / cost.SFU_EXP_PER_S * 1e3)
    bound = cost.flash_softcap_bound_ms(qs, ks, 2, True, 0, 0)
    assert bound[2] == "exps"
    assert floor == pytest.approx(1.5 * bound[0])
