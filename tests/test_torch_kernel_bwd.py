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


def test_bf16_with_grad_raises_naming_the_roadmap_item():
    q, k, v, _ = _fa_inputs(6, 1, 16, 16, 2, 1, 16)
    qb = torch.from_numpy(q).to(torch.bfloat16).requires_grad_(True)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="tensor-core backward"):
        fa.flash_attention(qb, kb, kb)
    x, dt, bi, co, al = _ssm_inputs(6, 1, 8, 4, 4)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="bf16 backward"):
        ss.ssm_scan(xb, *(torch.from_numpy(a).to(torch.bfloat16)
                          for a in (dt, bi, co)), torch.from_numpy(al))
    # without grad, bf16 stays the plain forward on the CPU
    with torch.no_grad():
        assert fa.flash_attention(qb, kb, kb).dtype == torch.bfloat16


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

    monkeypatch.setattr(attn_lib, "_kernel_route", lambda q, sc: True)
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
    leave them."""
    smoke = _chip_smoke()
    assert {name: dots for name, dots, _, _ in smoke.FA_BWD_WORK} == \
        {"dq": 3, "dkdv": 4, "pair": 5}
    b, h, hkv, d = 2, 4, 2, 16
    p = np.arange(q_offset, q_offset + s)[:, None]
    j = np.arange(t)[None, :]
    visible = (j <= p) & ((j > p - window) if window else True)
    pairs = b * h * int(visible.sum())
    for name, dots, reads, writes in smoke.FA_BWD_WORK:
        _, _, flops, exps = smoke.flash_bwd_bound_ms(
            (b, s, h, d), (b, t, hkv, d), dots, reads, writes,
            q_offset=q_offset, window=window)
        assert exps == pairs
        assert flops == 2 * d * dots * pairs


def test_block_grad_mutants_patch_the_committed_sources():
    """tools/block_grad_mutants.py's planted faults still apply: each
    anchor occurs once in its backward source, and the patch changes
    it."""
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
                f"{source}.cu").read_text()
        assert got_source == source and text != orig
        assert text.count(new) == 1 and old not in text
