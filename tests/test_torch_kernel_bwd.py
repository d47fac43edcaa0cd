"""The backward of kernels K4 (``flash_attention``) and K5 (``ssm_scan``)
on the CPU: the plain versions of the backward kernels
(``flash_attention_bwd_plain``, ``ssm_scan_bwd_plain``) against autograd
of the port's plain forwards and against ``jax.grad`` of the JAX
package's oracles (``repro.kernels.ref.flash_attention_ref``,
``ssm_scan_ref``, and ``repro.models.ssm.ssm_core`` where a starting
state is carried), on the same numpy inputs; the two
``torch.autograd.Function``s (``FlashAttentionFn``, ``SSMScanFn``),
which on CPU tensors run the plain forward and backward, against
autograd of the plain forward; and the model's kernel branches, routed
to the wrappers on the CPU, giving the gradients of the plain branches.
The kernels themselves are held against autograd of the plain twins on
the card by ``chip_smoke.py`` (``kernel_bwd_checks``).

Tolerances: 1e-5 against autograd of the port's plain forward (f32, the
same sums in another order: P from the saved log-sum-exp instead of a
softmax, a reverse recurrence instead of autograd's); 1e-4 against
``jax.grad`` and for ``dA_log`` (sums over every step), as the forward
tests' f32 tolerance for the scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref, ssm_scan_ref
from repro.models import ssm as ref_ssm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ss

torch.set_num_threads(1)

# (b, s, t, h, hkv, d, causal, window, q_offset): GQA groups 1, 2 and 5,
# causal, window, q_offset, non-causal, and rows that see no key (all of
# them, or some beside rows that see keys)
FA_CASES = [
    (2, 37, 37, 4, 4, 16, True, 0, 0),
    (1, 40, 40, 4, 2, 32, True, 8, 0),
    (2, 24, 24, 5, 1, 16, True, 0, 0),
    (1, 20, 50, 2, 1, 16, True, 0, 30),
    (1, 30, 45, 4, 2, 16, False, 0, 0),
    (1, 16, 40, 2, 1, 16, False, 6, 50),
    (1, 20, 50, 5, 1, 32, False, 8, 40),
]


def _fa_inputs(seed, b, s, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d),
                          (b, s, h, d))]


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), rtol=tol, atol=tol)


def _fa_plain_grads(q, k, v, do, **kw):
    ins = _leaves([q, k, v])
    out = fa.gqa_plain(*ins, **kw)
    return out, torch.autograd.grad(out, ins, torch.from_numpy(do))


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_bwd_plain_matches_autograd(case):
    b, s, t, h, hkv, d, causal, window, q_offset = case
    q, k, v, do = _fa_inputs(1, b, s, t, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, want = _fa_plain_grads(q, k, v, do, **kw)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, **kw)
    assert torch.equal(o, out.detach())
    got = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse,
                                       torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-5)


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_bwd_plain_matches_jax_grad(case):
    """Against ``jax.grad`` of the reference oracle on k/v repeated per
    group, heads folded into the batch (the reference's
    ``gqa_flash_attention``); dk and dv summed back over each group."""
    b, s, t, h, hkv, d, causal, window, q_offset = case
    q, k, v, do = _fa_inputs(2, b, s, t, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rep = h // hkv

    def fold(x):
        return jnp.moveaxis(x, 2, 1).reshape(b * x.shape[2], x.shape[1], d)

    def loss(q, k, v):
        kx, vx = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        o = flash_attention_ref(fold(q), fold(kx), fold(vx), **kw)
        o = jnp.moveaxis(o.reshape(b, h, s, d), 1, 2)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                              for x in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, **kw)
    got = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse,
                                       torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_rows_that_see_no_key_pass_dv_only():
    """Every row blind: out is the mean of v, dq = dk = 0 and dv = the
    sum of dO over the group's rows, / T on every key."""
    b, s, t, h, hkv, d = 1, 8, 20, 4, 2, 16
    q, k, v, do = _fa_inputs(3, b, s, t, h, hkv, d)
    kw = dict(causal=False, window=4, q_offset=30)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, **kw)
    dq, dk, dv = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, **kw)
    assert not dq.any() and not dk.any()
    want = dot.reshape(b, s, hkv, h // hkv, d).sum(dim=(1, 3)) / t
    _close(dv, want[:, None].expand(b, t, hkv, d).numpy(), 1e-6)


@pytest.mark.parametrize("case", FA_CASES[:4] + FA_CASES[-1:])
def test_flash_attention_fn_on_the_cpu_matches_autograd(case):
    b, s, t, h, hkv, d, causal, window, q_offset = case
    q, k, v, do = _fa_inputs(4, b, s, t, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, want = _fa_plain_grads(q, k, v, do, **kw)
    ins = _leaves([q, k, v])
    got_out = fa.flash_attention(*ins, **kw)
    assert got_out.grad_fn is not None \
        and "FlashAttentionFn" in type(got_out.grad_fn).__name__
    assert torch.equal(got_out.detach(), out.detach())
    got = torch.autograd.grad(got_out, ins, torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-5)


def test_flash_attention_without_grad_skips_the_function():
    q, k, v, _ = _fa_inputs(5, 1, 16, 16, 2, 1, 16)
    out = fa.flash_attention(*_leaves([q, k, v])[:1],
                             torch.from_numpy(k), torch.from_numpy(v))
    assert out.grad_fn is not None
    with torch.no_grad():
        out = fa.flash_attention(*_leaves([q, k, v]))
    assert out.grad_fn is None


def test_bf16_without_grad_stays_the_plain_forward():
    """bf16 without grad on the CPU is the plain forward (no Function, the
    plain twin's bits); bf16 with grad is ``tests/test_torch_bf16_train.py``'s."""
    q, k, v, _ = _fa_inputs(6, 1, 16, 16, 2, 1, 16)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    with torch.no_grad():
        out = fa.flash_attention(qb.requires_grad_(True), kb, vb)
    assert out.dtype == torch.bfloat16 and out.grad_fn is None
    assert torch.equal(out, fa.gqa_plain(qb.detach(), kb, vb))
    x, dt, bi, co, al = _ssm_inputs(6, 1, 8, 4, 4)
    xb, dtb, bib, cob = (torch.from_numpy(a).to(torch.bfloat16)
                         for a in (x, dt, bi, co))
    with torch.no_grad():
        y, h_end = ss.ssm_scan(xb.requires_grad_(True), dtb, bib, cob,
                               torch.from_numpy(al))
    want_y, want_h = ss.ssm_scan_plain(xb.detach(), dtb, bib, cob,
                                       torch.from_numpy(al))
    assert y.dtype == torch.bfloat16 and y.grad_fn is None
    assert torch.equal(y, want_y) and torch.equal(h_end, want_h)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def _ssm_inputs(seed, b, s, d, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, d)) - 1.0,
                      0.0).astype(np.float32)
    b_in = rng.standard_normal((b, s, n)).astype(np.float32)
    c_out = rng.standard_normal((b, s, n)).astype(np.float32)
    a_log = (np.repeat(np.log(np.arange(1, n + 1, dtype=np.float32))[None],
                       d, 0) + 0.1 * rng.standard_normal((d, n))
             ).astype(np.float32)
    return x, dt, b_in, c_out, a_log


# (b, s, d, n, with h0, with an incoming h_end gradient)
SS_CASES = [
    (2, 9, 5, 4, False, False),
    (1, 13, 6, 8, True, True),
    (2, 33, 7, 16, True, False),
    (1, 20, 3, 8, False, True),
]


def _ssm_plain_grads(x, dt, bc, a_log, h0, dy, dhe, n):
    leaves = _leaves([x, dt, bc, a_log] + ([h0] if h0 is not None else []))
    h0t = leaves[4] if h0 is not None else None
    y, h_end = ss.ssm_scan_plain(leaves[0], leaves[1], leaves[2][..., :n],
                                 leaves[2][..., n:], leaves[3], h0t)
    outs, cots = [y], [torch.from_numpy(dy)]
    if dhe is not None:
        outs.append(h_end)
        cots.append(torch.from_numpy(dhe))
    return torch.autograd.grad(outs, leaves, cots)


def _ssm_case(seed, b, s, d, n, with_h0, with_dhe):
    x, dt, bi, co, al = _ssm_inputs(seed, b, s, d, n)
    rng = np.random.default_rng(seed + 100)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32) if with_h0 \
        else None
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    dhe = rng.standard_normal((b, d, n)).astype(np.float32) if with_dhe \
        else None
    return x, dt, np.concatenate([bi, co], -1), al, h0, dy, dhe


def _bwd_plain(x, dt, bc, al, h0, dy, dhe, n):
    t = torch.from_numpy
    dx, ddt, db, dc, da_log, dh0 = ss.ssm_scan_bwd_plain(
        t(x), t(dt), t(bc)[..., :n], t(bc)[..., n:], t(al),
        None if h0 is None else t(h0), t(dy),
        None if dhe is None else t(dhe))
    return dx, ddt, torch.cat([db, dc], -1), da_log, dh0


@pytest.mark.parametrize("case", SS_CASES)
def test_ssm_scan_bwd_plain_matches_autograd(case):
    b, s, d, n, with_h0, with_dhe = case
    x, dt, bc, al, h0, dy, dhe = _ssm_case(7, *case)
    want = _ssm_plain_grads(x, dt, bc, al, h0, dy, dhe, n)
    got = _bwd_plain(x, dt, bc, al, h0, dy, dhe, n)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w.numpy(), 1e-4 if i == 3 else 1e-5)


@pytest.mark.parametrize("case", SS_CASES)
def test_ssm_scan_bwd_plain_matches_jax_grad(case):
    """Against ``jax.grad`` of ``ssm_scan_ref`` (no state) or, with a
    starting state or an h_end gradient, of the reference model's
    ``ssm_core`` (h0 in, h_end out)."""
    b, s, d, n, with_h0, with_dhe = case
    x, dt, bc, al, h0, dy, dhe = _ssm_case(8, *case)
    if with_h0 or with_dhe:
        def loss(x, dt, bc, al, h0):
            y, h_end = ref_ssm.ssm_core({"A_log": al}, x, dt, bc, h0, n,
                                        chunk=s)
            out = jnp.sum(y * dy)
            return out + (jnp.sum(h_end * dhe) if dhe is not None else 0.0)
        h0j = jnp.asarray(h0 if h0 is not None
                          else np.zeros((b, d, n), np.float32))
        want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (x, dt, bc, al)), h0j)
    else:
        def loss(x, dt, bc, al):
            return jnp.sum(ssm_scan_ref(x, dt, bc[..., :n], bc[..., n:], al)
                           * dy)
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (x, dt, bc, al)))
    got = _bwd_plain(x, dt, bc, al, h0, dy, dhe, n)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("case", SS_CASES)
def test_ssm_scan_fn_on_the_cpu_matches_autograd(case):
    b, s, d, n, with_h0, with_dhe = case
    x, dt, bc, al, h0, dy, dhe = _ssm_case(9, *case)
    want = _ssm_plain_grads(x, dt, bc, al, h0, dy, dhe, n)
    leaves = _leaves([x, dt, bc, al] + ([h0] if h0 is not None else []))
    y, h_end = ss.ssm_scan(leaves[0], leaves[1], leaves[2][..., :n],
                           leaves[2][..., n:], leaves[3],
                           leaves[4] if h0 is not None else None)
    assert "SSMScanFn" in type(y.grad_fn).__name__
    outs, cots = [y], [torch.from_numpy(dy)]
    if dhe is not None:
        outs.append(h_end)
        cots.append(torch.from_numpy(dhe))
    got = torch.autograd.grad(outs, leaves, cots)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w.numpy(), 1e-4 if i == 3 else 1e-5)


# ---------------------------------------------------------------------------
# The model's kernel branches, routed to the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_model_kernel_branches_carry_the_gradient(monkeypatch):
    """Reduced hymba at S=512 (banded attention, window 64; the SSM
    scan) with both kernel routes forced: the attention and the scan go
    through ``FlashAttentionFn`` and ``SSMScanFn`` (plain forward and
    backward on the CPU), and every parameter's gradient is the plain
    branches' within 1e-4 (f32 sums in another order) -- no gradient
    skips an attention or SSM branch."""
    from repro_torch.config import get_arch
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import init_model, lm_loss
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.tree import tree_flatten, tree_unflatten
    cfg = get_arch("hymba-1.5b").reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 512)))

    def grads():
        leaves, treedef = tree_flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        loss, _ = lm_loss(cfg, tree_unflatten(treedef, leaves),
                          {"tokens": tokens}, chunk_q=64, chunk_kv=64)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    want_loss, want = grads()
    fns = []
    real_fa, real_ss = fa.FlashAttentionFn.apply, ss.SSMScanFn.apply

    def rec_fa(*a):
        fns.append("fa")
        return real_fa(*a)

    def rec_ss(*a):
        fns.append("ss")
        return real_ss(*a)

    monkeypatch.setattr(attn_lib, "_kernel_route", lambda q: True)
    monkeypatch.setattr(ssm_lib, "_kernel_route", lambda x: True)
    monkeypatch.setattr(fa.FlashAttentionFn, "apply", rec_fa)
    monkeypatch.setattr(ss.SSMScanFn, "apply", rec_ss)
    got_loss, got = grads()
    assert fns.count("fa") == cfg.num_layers
    assert fns.count("ss") == cfg.num_layers
    _close(got_loss, want_loss.numpy(), 1e-5)
    for g, w in zip(got, want):
        assert g.abs().sum() > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("s,t,window,q_offset", [
    (100, 100, 0, 0), (100, 100, 30, 0), (37, 90, 20, 53)])
def test_chip_smoke_bounds_k4_backward_by_its_dots(s, t, window, q_offset):
    """chip_smoke.py bounds K4's backward by 2*D flops a D-long dot: three
    dots a visible pair for dq, four for dkdv, five for the pair's
    function (10*D), and one exp a visible pair, counted as the masks
    leave them; on the tensor-core route each flop is three TF32 flops
    (split TF32) at 494.7 TFLOP/s, on the CUDA cores one at 67, and the
    bound is the lesser route's."""
    smoke = _chip_smoke()
    assert {name: dots for name, dots, _, _ in smoke.FA_BWD_WORK} == \
        {"dq": 3, "dkdv": 4, "pair": 5}
    b, h, hkv, d = 2, 4, 2, 16
    p = np.arange(q_offset, q_offset + s)[:, None]
    j = np.arange(t)[None, :]
    visible = (j <= p) & ((j > p - window) if window else True)
    pairs = b * h * int(visible.sum())
    for name, dots, reads, writes in smoke.FA_BWD_WORK:
        got = smoke.flash_bwd_bound_ms(
            (b, s, h, d), (b, t, hkv, d), dots, reads, writes,
            q_offset=q_offset, window=window)
        flops = 2 * d * dots * pairs
        assert got["exps"] == pairs
        assert got["flops"] == flops
        assert got["tf32_flops"] == 3 * flops
        exps_ms = pairs / smoke.SFU_EXP_PER_S * 1e3
        cuda_ops = max(flops / 67e12 * 1e3, exps_ms)
        tensor_ops = max(3 * flops / 494.7e12 * 1e3, exps_ms)
        assert got["cuda_core_ms"] == pytest.approx(
            max(cuda_ops, got["bytes_ms"]), rel=1e-12)
        assert got["tensor_ms"] == pytest.approx(
            max(tensor_ops, got["bytes_ms"]), rel=1e-12)
        assert got["ms"] == min(got["cuda_core_ms"], got["tensor_ms"])
        assert got["route"] == ("tensor cores, split TF32"
                                if tensor_ops < cuda_ops
                                else "CUDA cores, f32")


def test_chip_smoke_bounds_the_f32_forward_by_two_dots():
    """The f32 forward with lse that training launches: two dots a
    visible pair (4*D flops), q, k, v read and the output and lse
    written; at hymba's layer the tensor-core route binds."""
    smoke = _chip_smoke()
    _, qs, ks, window = smoke.FA_BWD_SHAPES[0]
    dots, reads, writes = smoke.FA_FWD_WORK
    got = smoke.flash_bwd_bound_ms(qs, ks, dots, reads, writes,
                                   window=window)
    b, s, h, d = qs
    pairs = b * h * smoke.visible_pairs(s, ks[1], True, window, 0)
    assert dots == 2 and got["flops"] == 4 * d * pairs
    nbytes = 4 * (2 * b * s * h * d + 2 * b * ks[1] * ks[2] * d + b * h * s)
    assert got["bytes_ms"] == pytest.approx(
        nbytes / smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert got["route"] == "tensor cores, split TF32"


# -- split TF32, emulated: why three products a product ---------------------

def _tf32_rna(x):
    """``cvt.rna.tf32.f32`` in numpy (finite inputs): keep 10 mantissa
    bits, round half away from zero."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x):
    """The 19 top bits of an f32: what a TF32 product reads of it."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, split):
    """``a @ b`` of f32 matrices as the tensor cores take it: each TF32
    product exact, summed in float64.  ``rna``: hi = rna(x), lo =
    rna(x - hi), lo.hi + hi.lo + hi.hi; ``kernel``: the f32 kernels'
    split (``split_tf32_plain``: the integer add and mask of
    ``csrc/tf32_split.cuh``, rounding hi and lo to nearest), the same
    three products; ``single``: one product, rna(a) . rna(b)."""
    a, b = np.float32(a), np.float32(b)
    if split == "single":
        return np.float64(_tf32_rna(a)) @ np.float64(_tf32_rna(b))
    if split == "rna":
        ah, bh = _tf32_rna(a), _tf32_rna(b)
        al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    else:
        (ah, al), (bh, bl) = (
            (x.numpy() for x in fa.split_tf32_plain(torch.from_numpy(m)))
            for m in (a, b))
    ah, al, bh, bl = (np.float64(x) for x in (ah, al, bh, bl))
    return al @ bh + ah @ bl + ah @ bh


def _backward_products(q, k, v, do, mask, matmul):
    """dq, dk, dv (float64) with the backward's five products through
    ``matmul`` (S = q.k^T, dP = dO.v^T, dS.k, dS^T.q, P^T.dO; P and dS
    between them in float64), lse and delta exact."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    rep, scale = h // hkv, 1.0 / np.sqrt(d)
    dq, dk, dv = np.zeros(q.shape), np.zeros(k.shape), np.zeros(k.shape)
    for bi in range(b):
        for hh in range(h):
            kh = hh // rep
            qh, kk, vv, dh = (np.float64(x[bi, :, i]) for x, i in
                              ((q, hh), (k, kh), (v, kh), (do, hh)))
            exact = np.where(mask, qh @ kk.T * scale, -np.inf)
            top = exact.max(axis=1, keepdims=True)
            lse = np.log(np.exp(exact - top).sum(axis=1)) + top[:, 0]
            o = np.where(mask, np.exp(exact - lse[:, None]), 0.0) @ vv
            delta = (dh * o).sum(axis=1)
            sc = matmul(q[bi, :, hh], k[bi, :, kh].T)
            p = np.where(mask, np.exp(sc * scale - lse[:, None]), 0.0)
            ds = p * (matmul(do[bi, :, hh], v[bi, :, kh].T) - delta[:, None])
            dq[bi, :, hh] = matmul(ds, k[bi, :, kh]) * scale
            dk[bi, :, kh] += matmul(ds.T, q[bi, :, hh]) * scale
            dv[bi, :, kh] += matmul(p.T, do[bi, :, hh])
    return dq, dk, dv


def _tf32_excess(split, seed):
    """The largest |got - want| / (atol * max(1, max|want|) + rtol *
    |want|) over dq, dk, dv of one seeded case (D = 64, GQA 4, causal
    with a window of 24), ``split`` against float64, at chip_smoke.py's
    ``BWD_RTOL`` / ``BWD_ATOL``: above 1 fails ``kernel_bwd_checks``."""
    smoke = _chip_smoke()
    q, k, v, do = _fa_inputs(seed, 1, 96, 96, 8, 2, 64)
    pos = np.arange(96)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 24)
    got = _backward_products(q, k, v, do, mask,
                             lambda a, b: _tf32_matmul(a, b, split))
    want = _backward_products(q, k, v, do, mask,
                              lambda a, b: np.float64(a) @ np.float64(b))
    excess = 0.0
    for g, w in zip(got, want):
        tol = smoke.BWD_ATOL * max(1.0, np.abs(w).max()) \
            + smoke.BWD_RTOL * np.abs(w)
        excess = max(excess, float((np.abs(g - w) / tol).max()))
    return excess


def test_tf32_emulation_rounds_as_cvt_rna():
    x = np.float32([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                    -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -10 - 2.0 ** -23])
    assert list(_tf32_rna(x)) == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -9),
                                  1.0 + 2.0 ** -10]
    assert list(_tf32_trunc(x)) == [1.0, 1.0, -(1.0 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("split", ["rna", "kernel"])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_meets_the_backward_tolerance(split, seed):
    """Three TF32 products a product (either split) keep the backward
    within a few hundredths of ``kernel_bwd_checks``' tolerance."""
    assert _tf32_excess(split, seed) < 0.05


@pytest.mark.parametrize("seed", [0, 1])
def test_one_tf32_product_misses_the_backward_tolerance(seed):
    """One TF32 product a product (the ``fa_tf32_single`` mutant) fails
    the same tolerance: the split's two correction terms are needed."""
    assert _tf32_excess("single", seed) > 1.0


def test_backward_rejects_misaligned_inputs_by_name():
    """The backward kernels' 16-byte copies: a contiguous view one float
    into its buffer raises ``ValueError`` naming it, before the kernels'
    library is asked for (so on the CPU too)."""
    b, s, h, d = 1, 8, 2, 16
    buf = torch.zeros(1 + 5 * b * s * h * d)
    q, k, v, o, do = (buf[i * b * s * h * d:(i + 1) * b * s * h * d]
                      .view(b, s, h, d) for i in range(5))
    lse = torch.zeros(b, h, s)
    shifted = buf[1:1 + b * s * h * d].view(b, s, h, d)
    assert q.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match=r"\(cp.async\): do address"):
        fa._kernel_backward(q, k, v, o, lse, shifted, True, 0, 0)
    with pytest.raises(ValueError, match=r"\(cp.async\): q address"):
        fa._kernel_backward(shifted, k, v, o, lse, do, True, 0, 0)


def test_block_grad_mutants_patch_the_committed_sources():
    """tools/block_grad_mutants.py's planted faults still apply: each
    anchor occurs once in its kernel source or header, and the patch
    changes it."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "block_grad_mutants", root / "tools" / "block_grad_mutants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.patched_source("sound") is None
    for name, (source, old, new) in (
            (n, m) for n, m in tool.MUTANTS.items() if m is not None):
        got_source, text = tool.patched_source(name)
        orig = (root / "src/repro_torch/kernels/csrc" /
                tool.source_file(source)).read_text()
        assert got_source == source and text != orig
        assert text.count(new) == 1 and old not in text


# -- K4's f32 forward in split TF32, emulated -------------------------------

from repro.kernels import gqa_flash_attention as ref_gqa  # noqa: E402

FA_F32_TILE = 64      # q rows a block and keys a tile of fa_fwd_f32_kernel


def _fa_f32_emulation(q, k, v, *, causal, window, q_offset, split):
    """The arithmetic of ``csrc/flash_attention.cu: fa_fwd_f32_kernel``
    in numpy, for these tests only.  q (B,S,H,D), k/v (B,T,Hkv,D) f32 ->
    (out (B,S,H,D), lse (B,H,S)), f32.  Per (b, h) and block of 64 rows:
    the block's key range (the union of its rows' bands, or all T when a
    row sees none), in tiles of 64 keys (zeros past T); each tile's two
    products through ``_tf32_matmul(.., split)`` (each summed from zero),
    the scores times scale in f32 and masked by select (-1e30, or -inf
    past T), m, corr and p = exp(s - m) in f32, l summed from p, O =
    O * corr + P.V in f32; out = O / max(l, 1e-30), lse = m +
    log(max(l, 1e-30))."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = np.float32(1.0 / np.sqrt(d))
    out = np.zeros((b, s, h, d), np.float32)
    lse = np.zeros((b, h, s), np.float32)
    for bi in range(b):
        for hi in range(h):
            kh, vh = k[bi, :, hi // rep], v[bi, :, hi // rep]
            for q0 in range(0, s, FA_F32_TILE):
                rows = np.arange(q0, min(q0 + FA_F32_TILE, s))
                pos = q_offset + rows
                lo_r = np.maximum(0, pos - window + 1) if window > 0 \
                    else np.zeros_like(pos)
                hi_r = np.minimum(t, pos + 1) if causal \
                    else np.full_like(pos, t)
                blind = bool((hi_r <= lo_r).any())
                lo = 0 if blind else int(lo_r.min())
                hi_ = t if blind else int(hi_r.max())
                n = len(rows)
                m = np.full(n, -1e30, np.float32)
                l_run = np.zeros(n, np.float32)
                acc = np.zeros((n, d), np.float32)
                for t0 in range(lo // FA_F32_TILE * FA_F32_TILE, hi_,
                                FA_F32_TILE):
                    keys = t0 + np.arange(FA_F32_TILE)
                    real = keys < t
                    kt = np.zeros((FA_F32_TILE, d), np.float32)
                    vt = np.zeros((FA_F32_TILE, d), np.float32)
                    kt[real], vt[real] = kh[keys[real]], vh[keys[real]]
                    sc = np.float32(_tf32_matmul(q[bi, rows, hi], kt.T,
                                                 split))
                    vis = (keys[None] >= lo_r[:, None]) \
                        & (keys[None] < hi_r[:, None])
                    masked = np.where(real, np.float32(-1e30),
                                      np.float32(-np.inf))
                    sc = np.where(vis, sc * scale, masked[None])
                    m_new = np.maximum(m, sc.max(axis=1))
                    p = np.exp(sc - m_new[:, None])
                    corr = np.exp(m - m_new)
                    l_run = l_run * corr + p.sum(axis=1, dtype=np.float32)
                    acc = acc * corr[:, None] \
                        + np.float32(_tf32_matmul(p, vt, split))
                    m = m_new
                la = np.maximum(l_run, np.float32(1e-30))
                out[bi, rows, hi] = acc / la[:, None]
                lse[bi, hi, rows] = m + np.log(la)
    return out, lse


# (b, s, t, h, hkv, d, causal, window, q_offset): GQA 4 and 5, causal,
# window, q_offset, S and T off the 64 tile, T under one tile, rows that
# see no key (all of them, or some beside rows that see keys), D 16 / 32
# / 64
FA_F32_CASES = [
    (1, 128, 128, 4, 1, 64, True, 0, 0),
    (1, 100, 100, 5, 1, 64, True, 48, 0),
    (1, 91, 157, 4, 2, 16, True, 40, 66),
    (1, 130, 99, 4, 1, 32, False, 50, 20),
    (2, 70, 10, 2, 2, 32, False, 0, 0),
    (1, 64, 128, 2, 1, 64, False, 32, 140),
    (1, 64, 128, 2, 1, 64, False, 32, 200),
]


def _pallas_f32(q, k, v, *, causal, window, q_offset):
    """The JAX package's Pallas kernel in interpret mode through its GQA
    wrapper: blocks of 64 where they divide S and T, else one block."""
    s, t = q.shape[1], k.shape[1]
    return np.asarray(ref_gqa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset,
        block_q=FA_F32_TILE if s % FA_F32_TILE == 0 else s,
        block_k=FA_F32_TILE if t % FA_F32_TILE == 0 else t,
        interpret=True))


@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,window,q_offset",
                         FA_F32_CASES)
def test_f32_forward_in_split_tf32_matches_the_pallas_kernel(
        b, s, t, h, hkv, d, causal, window, q_offset):
    """K4's f32 forward kernel's arithmetic (three TF32 products a
    product, each tile summed from zero, the online softmax over 64-key
    tiles) against the JAX Pallas kernel run in interpret mode, at
    chip_smoke.py's ``FA_TOL`` f32; its lse against the plain twin's."""
    rtol, atol = _chip_smoke().FA_TOL["float32"]
    q, k, v, _ = _fa_inputs(s * t + d, b, s, t, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got, lse = _fa_f32_emulation(q, k, v, split="kernel", **kw)
    np.testing.assert_allclose(got, _pallas_f32(q, k, v, **kw), rtol=rtol,
                               atol=atol)
    _, want_lse = fa.flash_attention_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(lse, want_lse.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", [0, 1])
def test_one_tf32_product_misses_the_forward_tolerance(case):
    """The same arithmetic with one TF32 product a product fails
    ``FA_TOL`` f32: the split's two correction terms are needed."""
    rtol, atol = _chip_smoke().FA_TOL["float32"]
    b, s, t, h, hkv, d, causal, window, q_offset = FA_F32_CASES[case]
    q, k, v, _ = _fa_inputs(s * t + d, b, s, t, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    single, _ = _fa_f32_emulation(q, k, v, split="single", **kw)
    assert not np.allclose(single, _pallas_f32(q, k, v, **kw), rtol=rtol,
                           atol=atol)


# -- K5's f32 backward split over time, emulated ----------------------------

K5_LOG2E = np.float32(1.4426950408889634)


def _k5_bwd_emulation(x, dt, bc, a_log, h0, dy, dhe, n, *, split, blk=8,
                      half=4):
    """The arithmetic order of ``csrc/ssm_scan_bwd.cu`` in plain torch,
    f32, for these tests only -> (dx, ddt, dB|dC, dA_log, dh0).  The
    forward's split, ``split`` = (warps, seg_max, tb) as
    ``test_torch_ssm.py``'s forward emulation takes it (S = 1: one step,
    one chunk).  The forward's chunk carries come from its own pass 1
    and folds; then chunks last to first: each segment scanned forward
    (local end state, sum dt) and g backward (carry out of its first
    step) from zero; each segment's state folded from the chunk's
    carry over the earlier segments and g's carry from the later
    chunk's over the later ones, c = exp2(a2 sum dt) c + c_local; the
    chunk's carry out over segment 0 too (dh0 for the first chunk);
    then per segment checkpoints every ``blk`` steps from its state, and
    the blocks last to first, each in two halves of ``half`` steps, the
    later half's states replayed from the block's checkpoint, walked
    back: dx, ddt, dB, dC of each step, dA_log summed."""
    t_ = torch.from_numpy
    x, dt, bc, a_log, dy = (t_(a) for a in (x, dt, bc, a_log, dy))
    bsz, s, d = x.shape
    bm, cm = bc[..., :n], bc[..., n:]
    A = -torch.exp(a_log)                                       # (D,N)
    a2 = A * t_(np.array(K5_LOG2E))

    def step(h, t):
        dv = dt[:, t, :, None]
        return torch.exp2(dv * a2) * h + (dv * x[:, t, :, None]) \
            * bm[:, t, None, :]

    warps, seg_max, tb = split
    if s == 1:
        seg = 1
    else:
        seg = min(seg_max, -(-(-(-s // warps)) // tb) * tb)
    chunk = warps * seg
    chunks = -(-s // chunk)
    spans = [[(k0 + w * seg, min(k0 + (w + 1) * seg, s))
              for w in range(warps)] for k0 in range(0, chunks * chunk,
                                                      chunk)]

    def local_fwd(t0, t1):
        h = torch.zeros((bsz, d, n))
        sdt = torch.zeros((bsz, d))
        for t in range(t0, t1):
            h = step(h, t)
            sdt = sdt + dt[:, t]
        return h, sdt

    def fold(c, sdt, c_local):
        return torch.exp2(a2 * sdt[..., None]) * c + c_local

    zero = torch.zeros((bsz, d, n))
    starts, carry = [], zero if h0 is None else t_(h0)   # chunk starts
    for sp in spans:
        starts.append(carry)
        local = [local_fwd(*span) for span in sp]
        for hl, sdt in local:
            carry = fold(carry, sdt, hl)
    dx, ddt = torch.zeros((bsz, s, d)), torch.zeros((bsz, s, d))
    dbc = torch.zeros((bsz, s, 2 * n))
    dacc = torch.zeros((bsz, d, n))
    g_carry = zero if dhe is None else t_(dhe)
    for k in range(chunks - 1, -1, -1):
        local = [local_fwd(*span) for span in spans[k]]
        g_local = []
        for t0, t1 in spans[k]:
            c = zero
            for t in range(t1 - 1, t0 - 1, -1):
                a = torch.exp2(dt[:, t, :, None] * a2)
                c = a * (cm[:, t, None, :] * dy[:, t, :, None] + c)
            g_local.append(c)
        new_carry = None
        for w, (t0, t1) in enumerate(spans[k]):
            h = starts[k]
            for v in range(w):
                h = fold(h, local[v][1], local[v][0])
            g = g_carry
            for v in range(warps - 1, w, -1):
                g = fold(g, local[v][1], g_local[v])
            if w == 0:
                new_carry = fold(g, local[0][1], g_local[0])
            ck = []
            for j in range(t0, t1, blk):
                ck.append(h)
                for t in range(j, min(j + blk, t1)):
                    h = step(h, t)
            for j in range(len(ck) - 1, -1, -1):
                s0 = t0 + j * blk
                s1 = min(s0 + blk, t1)
                for hf in (1, 0):
                    a0 = s0 + hf * half
                    if a0 >= s1:
                        continue
                    hs = [ck[j]]
                    for t in range(s0, a0):
                        hs[0] = step(hs[0], t)
                    for t in range(a0, min(a0 + half, s1)):
                        hs.append(step(hs[-1], t))
                    for i in range(len(hs) - 2, -1, -1):
                        t = a0 + i
                        dv, xv = dt[:, t, :, None], x[:, t, :, None]
                        dyv = dy[:, t, :, None]
                        a = torch.exp2(dv * a2)
                        g = cm[:, t, None, :] * dyv + g
                        bn = bm[:, t, None, :]
                        dbc[:, t, :n] = (g * (dv * xv)).sum(dim=1)
                        dbc[:, t, n:] = (hs[i + 1] * dyv).sum(dim=1)
                        dx[:, t] = dv[..., 0] * (g * bn).sum(dim=-1)
                        ddt[:, t] = (g * (xv * bn + (hs[i] * A) * a)).sum(
                            dim=-1)
                        dacc = dacc + g * (hs[i] * a) * dv
                        g = g * a
        g_carry = new_carry
    return dx, ddt, dbc, A * dacc.sum(dim=0), g_carry


# (b, s, d, n, h0, dh_end, split): one segment; a ragged last segment
# and empty ones; several chunks, one ragged; halves of 1-3 steps; S = 1
K5_BWD_CASES = [
    (2, 9, 5, 4, False, False, (8, 64, 4)),
    (1, 13, 6, 8, True, True, (4, 8, 4)),
    (2, 33, 7, 16, True, False, (2, 8, 4)),
    (1, 45, 3, 8, False, True, (3, 8, 2)),
    (1, 70, 4, 4, True, True, (4, 8, 4)),
    (2, 1, 5, 16, True, True, (8, 64, 4)),
]


@pytest.mark.parametrize("case", K5_BWD_CASES)
def test_k5_backward_time_split_matches_jax_grad(case):
    """K5's backward kernel's order (the forward's split, carries folded
    in reverse, register halves replayed from checkpoints) against
    ``jax.grad`` of the reference and against ``ssm_scan_bwd_plain``, at
    1e-4."""
    b, s, d, n, with_h0, with_dhe, split = case
    x, dt, bc, al, h0, dy, dhe = _ssm_case(10, b, s, d, n, with_h0,
                                           with_dhe)
    got = _k5_bwd_emulation(x, dt, bc, al, h0, dy, dhe, n, split=split)
    for g, w in zip(got, _bwd_plain(x, dt, bc, al, h0, dy, dhe, n)):
        _close(g, w.numpy(), 1e-4)

    def loss(x, dt, bc, al, h0):
        y, h_end = ref_ssm.ssm_core({"A_log": al}, x, dt, bc, h0, n,
                                    chunk=s)
        out = jnp.sum(y * dy)
        return out + (jnp.sum(h_end * dhe) if dhe is not None else 0.0)
    h0j = jnp.asarray(h0 if h0 is not None
                      else np.zeros((b, d, n), np.float32))
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, bc, al)), h0j)
    for g, w in zip(got, want):
        _close(g, np.asarray(w), 1e-4)


def test_k5_backward_emulation_cases_reach_every_edge_of_the_split():
    """The cases above reach more than one chunk, a ragged last chunk,
    segments with no steps, a later half shorter than its block's half
    and a block with no later half, h0 and dh_end each present and
    absent, and a single step."""
    def edges(s, split):
        warps, seg_max, tb = split
        seg = 1 if s == 1 else min(seg_max, -(-(-(-s // warps)) // tb) * tb)
        chunk = warps * seg
        lens = [max(0, min(t0 + seg, s) - t0)
                for t0 in range(0, -(-s // chunk) * chunk, seg)]
        blocks = [min(8, ln - j) for ln in lens for j in range(0, ln, 8)]
        return {"chunks": -(-s // chunk) > 1, "ragged": s % chunk != 0,
                "empty": 0 in lens, "short_half": any(4 < bl < 8
                                                      for bl in blocks),
                "no_half": any(bl <= 4 for bl in blocks)}
    seen = {}
    for _, s, _, _, _, _, split in K5_BWD_CASES:
        for key, val in edges(s, split).items():
            seen[key] = seen.get(key, False) or val
    assert all(seen.values()), seen
    assert {c[4] for c in K5_BWD_CASES} == {True, False}
    assert {c[5] for c in K5_BWD_CASES} == {True, False}
    assert any(c[1] == 1 for c in K5_BWD_CASES)


def test_f32_forward_rejects_misaligned_k_and_v_by_name():
    """The f32 forward kernel's 16-byte copies of k and v: a view one
    float off a 16-byte address, or with strides of 65 floats, raises
    ``ValueError`` naming it before the kernel's library is asked for
    (so on the CPU too)."""
    q = torch.zeros(1, 8, 2, 64)
    wide = torch.zeros(1, 8, 2, 65)
    k = torch.zeros(1, 8, 1, 64)
    for bad in (wide[:, :, :1, 1:], wide[:, :, :1, :64]):
        assert fa.tma_misalignment(bad)
        with pytest.raises(ValueError, match=r"f32 kernel \(cp.async\): k "):
            fa._kernel_forward(q, bad, k, True, 0, 0, with_lse=True)
        with pytest.raises(ValueError, match=r"f32 kernel \(cp.async\): v "):
            fa._kernel_forward(q, k, bad, True, 0, 0, with_lse=False)
