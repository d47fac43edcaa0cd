"""Training with a logit softcap on the port's attention (kernel K4's
wrapper and plain twins), against the JAX package on the same numpy
inputs.

The reference caps the scaled scores with ``_softcap`` (``cap *
tanh(s / cap)``, ``repro/models/attention.py``) in every attention
branch and lets ``jax.grad`` differentiate it.  The port's
``flash_attention`` with an input that requires grad goes through
``FlashAttentionFn`` with the cap: on CUDA tensors the capped forward
with lse and the capped backward pair (``chip_smoke.py:
softcap_bwd_checks`` holds them against these twins on the card), on
CPU tensors ``flash_attention_fwd_plain`` and
``flash_attention_bwd_plain`` with ``softcap=``, the same math in
PyTorch: P of the capped score, dS times ``1 - tanh^2``.

Tolerances: 1e-4 (f32; atol scaled by max(1, max |want|)) against
``jax.grad``, as ``tests/test_torch_kernel_bwd.py``; the bf16 Function
at 2e-2, the bf16 tolerance of ``tests/test_torch_attention.py``; 2e-5
for the forward's lse.  Each case also checks that the cap bites: the
reference's gradients without it are more than 100x the tolerance away.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.models import attention as ref_attn
from repro.models import init_model as ref_init_model
from repro.models import lm_loss as ref_lm_loss
from repro_torch import bridge
from repro_torch.config import get_arch
from repro_torch.distributed.hostdevices import ENV_VAR
from repro_torch.distributed.mesh import make_mesh
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps
from repro_torch.models import attention as attn
from repro_torch.models import lm_loss
from repro_torch.sharding.hints import set_mesh
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

HEAD_DIMS = (16, 32, 64, 80, 128, 192)
CAPS = (5.0, 50.0)
# (b, s, t, h, hkv, causal, window, q_offset): causal with q_offset;
# causal under a window; non-causal under a window past T's start (rows
# that see few keys)
MASKS = {"causal": (1, 24, 40, 4, 2, True, 0, 16),
         "window": (2, 24, 24, 4, 1, True, 8, 0),
         "full-window": (1, 20, 48, 4, 2, False, 12, 20)}


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    yield
    set_mesh(None)


def _inputs(seed, b, s, t, h, hkv, d, cap):
    """q scaled by 2 caps (scores reach several caps), k, v, dO."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
             for _ in "qd")
    k, v = (rng.standard_normal((b, t, hkv, d)).astype(np.float32)
            for _ in "kv")
    return (q * np.float32(2 * cap)), k, v, do


def _ref_grads(q, k, v, do, cap, **kw):
    """``jax.grad`` of the reference's naive attention with the cap on
    k/v repeated per group (dk, dv summed back over each group)."""
    h = q.shape[2]

    def loss(q, k, v):
        o = ref_attn.naive_attention(q, ref_attn.repeat_kv(k, h),
                                     ref_attn.repeat_kv(v, h), softcap=cap,
                                     **kw)
        return jnp.sum(o * do)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))]


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=rtol,
        atol=rtol * max(1.0, float(np.abs(want).max())))


def _bites(with_cap, without, rtol=1e-4):
    """The cap moves every gradient by more than 100x the tolerance."""
    for a, b in zip(with_cap, without):
        assert np.abs(a - b).max() > 100 * rtol * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_capped_backward_twin_and_function_match_jax_grad(d, mask, cap):
    """``flash_attention_bwd_plain(softcap=)`` on the capped forward's
    lse, and ``FlashAttentionFn`` through ``flash_attention(softcap=)``
    with grad (the CPU's plain forward and backward), against
    ``jax.grad`` of the reference's capped attention (1e-4)."""
    b, s, t, h, hkv, causal, window, q_offset = MASKS[mask]
    q, k, v, do = _inputs(d + int(cap), b, s, t, h, hkv, d, cap)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _ref_grads(q, k, v, do, cap, **kw)
    _bites(want, _ref_grads(q, k, v, do, 0.0, **kw))
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, softcap=cap, **kw)
    got = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot,
                                       softcap=cap, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    ins = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    out = fa.flash_attention(*ins, softcap=cap, **kw)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), o)
    for g, w in zip(torch.autograd.grad(out, ins, dot), want):
        _close(g, w)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_capped_lse_is_the_reference_logsumexp_of_capped_scores(d, cap):
    """The forward's lse under every mask of ``MASKS``: the log-sum-exp
    of the reference's ``_softcap`` scores, masked at -1e30 (2e-5)."""
    for b, s, t, h, hkv, causal, window, q_offset in MASKS.values():
        q, k, v, _ = _inputs(d, b, s, t, h, hkv, d, cap)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        _, lse = fa.flash_attention_fwd_plain(
            *(torch.from_numpy(x) for x in (q, k, v)), softcap=cap, **kw)
        kx = jnp.repeat(jnp.asarray(k), h // hkv, axis=2)
        sc = jnp.einsum("bshd,bthd->bhst", jnp.asarray(q), kx) / np.sqrt(d)
        sc = ref_attn._softcap(sc, cap)
        m = np.asarray(fa._mask(s, t, causal, window, q_offset, "cpu"))
        want = jax.nn.logsumexp(jnp.where(m, sc, -1e30), axis=-1)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_function_with_a_cap_matches_jax_grad(d, cap):
    """The bf16 Function on the CPU (the plain forward in f32 rounded to
    bf16 with the rest of its rounding kept, as the kernel's ``out_lo``;
    the plain backward in f32) against ``jax.grad`` in f32 on the same
    bf16 values (2e-2)."""
    b, s, t, h, hkv, causal, window, q_offset = MASKS["causal"]
    q, k, v, do = (x.astype(np.float32) for x in (
        torch.from_numpy(y).to(torch.bfloat16).float().numpy()
        for y in _inputs(7, b, s, t, h, hkv, d, cap)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _ref_grads(q, k, v, do, cap, **kw)
    ins = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
           for x in (q, k, v)]
    out = fa.flash_attention(*ins, softcap=cap, **kw)
    got = torch.autograd.grad(out, ins,
                              torch.from_numpy(do).to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, w in zip(got, want):
        _close(g, w, rtol=2e-2)


def test_kernel_entries_refuse_a_cap_that_is_not_finite_and_positive():
    """The kernel forward and backward check the cap before the library
    is loaded: a negative, infinite or NaN cap raises ``ValueError``."""
    q = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    for cap in (-1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="softcap"):
            fa._kernel_forward(q, q, q, True, 0, 0, with_lse=True,
                               softcap=cap)
        with pytest.raises(ValueError, match="softcap"):
            fa._kernel_backward(q, q, q, q, lse, q, True, 0, 0, softcap=cap)


# ---------------------------------------------------------------------------
# the model's routes, as on a CUDA tensor
# ---------------------------------------------------------------------------

def _recording_apply(monkeypatch):
    """``FlashAttentionFn.apply`` recording its masks and cap."""
    applied = []
    real = fa.FlashAttentionFn.apply

    def recording(*a):
        applied.append(a[3:])
        return real(*a)

    monkeypatch.setattr(fa.FlashAttentionFn, "apply", recording)
    return applied


def test_reduced_llama_lm_loss_grads_with_a_cap_match_reference(monkeypatch):
    """Reduced llama3.2-1b with ``attn_logit_softcap`` set, through the
    kernel route forced on the CPU (each layer's attention one
    ``FlashAttentionFn`` with the cap): loss and every gradient against
    ``jax.value_and_grad`` of the reference's ``lm_loss`` on bridged
    parameters (1e-5 loss, 1e-4 gradients); the cap bites."""
    cap = 0.5
    ref_cfg = ref_get_arch("llama3.2-1b").reduced()
    ref_p = ref_init_model(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    pt_p = bridge.from_reference(jax.device_get(ref_p), "cpu")
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              attn_logit_softcap=cap)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 512))

    def ref_grads(c):
        return jax.value_and_grad(
            lambda p: ref_lm_loss(dataclasses.replace(
                ref_cfg, attn_logit_softcap=c), p,
                {"tokens": jnp.asarray(tokens)}), has_aux=True)(ref_p)

    (ref_loss, _), want = ref_grads(cap)
    _, without = ref_grads(0.0)
    applied = _recording_apply(monkeypatch)
    monkeypatch.setattr(attn, "_kernel_route", lambda q: True)
    loss, _, grads = steps.loss_and_grads(
        lambda p: lm_loss(cfg, p, {"tokens": torch.from_numpy(tokens)},
                          chunk_q=128, chunk_kv=128), pt_p)
    assert applied == [(True, 0, 0, cap)] * cfg.num_layers
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    got = tree_leaves(grads)
    want, without = (jax.tree_util.tree_leaves(x) for x in (want, without))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    moved = max(np.abs(np.asarray(w) - np.asarray(u)).max()
                / max(1.0, np.abs(np.asarray(w)).max())
                for w, u in zip(want, without))
    assert moved > 100 * 1e-4


# (port function, reference function, keywords, model shards)
ROUTES = {
    "chunked_cp": (attn.chunked_attention_cp, ref_attn.chunked_attention_cp,
                   dict(causal=True), 4),
    "banded_cp_non_causal": (attn.banded_attention_cp,
                             ref_attn.banded_attention_cp,
                             dict(causal=False, window=64), 4),
    "banded_non_causal": (attn.banded_attention, ref_attn.banded_attention,
                          dict(causal=False, window=64), 1)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cp_and_band_routes_carry_the_cap_under_grad(route, monkeypatch):
    """Routed as on a CUDA tensor: the context-parallel route (one launch
    a model shard of a (1, 4) mesh of virtual CPU shards; non-causal
    banded CP, one launch a q chunk) and the non-causal band route (one
    launch a q chunk on its band) hand every
    launch's ``FlashAttentionFn`` the cap, and the gradients, autograd's
    sum over the launches, equal ``jax.grad`` of the reference's branch
    with the cap (1e-4)."""
    fn, ref_fn, kw, shards = ROUTES[route]
    kw = dict(kw, chunk_q=128, chunk_kv=128)
    cap = 5.0
    q, k, v, do = _inputs(50, 1, 512, 512, 4, 2, 16, cap)

    def ref_loss(q, k, v):
        o = ref_fn(q, ref_attn.repeat_kv(k, 4), ref_attn.repeat_kv(v, 4),
                   softcap=cap, **kw)
        return jnp.sum(o * do)

    want = [np.asarray(g) for g in jax.grad(ref_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))]
    if shards > 1:
        set_mesh(make_mesh((1, shards), ("data", "model"),
                           devices=["cpu"] * shards))
    applied = _recording_apply(monkeypatch)
    monkeypatch.setattr(attn, "_kernel_route", lambda q: True)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ins, softcap=cap, **kw)
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    # four launches: the four model shards, or the four q chunks of 128
    assert len(applied) == 4
    assert all(a[3] == cap and a[0] == kw["causal"] for a in applied)
    for g, w in zip(got, want):
        _close(g, w)
