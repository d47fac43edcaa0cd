"""bf16 training on the port against the JAX package, on the CPU.

``FlashAttentionFn`` and ``SSMScanFn`` on bf16 CPU tensors (their plain
forward and ``flash_attention_bwd_plain`` / ``ssm_scan_bwd_plain``, the
math of the bf16 kernels: f32 inside, the gradients rounded once to
bf16) against ``jax.grad`` of the JAX oracles
(``repro.kernels.ref.flash_attention_ref``, ``ssm_scan_ref``, and
``repro.models.ssm.ssm_core`` where a starting state or an h_end
gradient is carried) on the same bf16 (``ml_dtypes``) inputs, and
against autograd of the port's plain forwards run in f32 on the upcast
inputs; the model's kernel branches routed to the wrappers on the CPU in
bf16 giving the plain branches' gradients; and ``make_train_step`` with
``TrainConfig(dtype="bfloat16")`` (AdamW, clip 1.0, remat "full") on
reduced ``llama3.2-1b`` and ``hymba-1.5b`` against the reference's bf16
step from the reference's bf16 ``init_model`` parameters carried across
with ``bridge.from_reference``.  The bf16 kernels themselves are held
against the plain twins on the card by ``chip_smoke.py``
(``bf16_bwd_checks``, ``lm_bf16_train_path``).

Tolerances:

* The Functions' gradients, against either reference: ``|got - want| <=
  1e-3 * max(1, max |want|) + 8e-3 * |want|``, the bf16 tolerance of
  ``chip_smoke.py`` (``FA_TOL["bfloat16"]`` scaled as its ``_grad_close``
  scales).  Both sides round a gradient to bf16 once (2^-9 relative);
  K4's backward takes delta = rowsum(dO * O) of the forward's output in
  two bf16 parts (``out_lo``), the f32 output to about 2^-16, as JAX's
  softmax gradient takes it (of the rounded output alone dq and dk
  miss this tolerance by up to 5e-3).
* The model's gradients with the kernel routes forced against the plain
  branches, each leaf within 2e-2 of its largest |gradient|: the two
  routes give the same attention and scan outputs up to f32 sums in
  another order, whose bf16 rounding flips an ulp (2^-8) here and there,
  and the bf16 model carries those flips through two layers.
* The bf16 step against the reference's: loss and grad norm within 1e-3
  relative (the two sides read up to 3.4e-4 apart); Adam's moments m
  and sqrt(v) (f32, of the bf16 gradients), each leaf within 5e-2 of
  its largest entry (they read up to 3.0e-2: the two frameworks round
  the bf16 activations at different places, and a leaf's gradient is a
  sum over tokens whose terms cancel); each parameter within the step
  bound plus one bf16 ulp of its value, the step bound being two
  updates' worth, 2 * lr * (1 + weight_decay * |p|): Adam's first
  update is +-lr (plus the decay) whatever the gradient's size, so a
  near-zero gradient whose sign the bf16 noise flips moves the two
  sides 2 lr apart (0.3-0.5 % of the elements), and both sides round
  ``p + u`` to bf16; and the mean difference below 0.05 lr (it reads
  0.007-0.012 lr).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_get_arch
from repro.config.base import TrainConfig as RefTrainConfig
from repro.kernels.ref import flash_attention_ref, ssm_scan_ref
from repro.launch import steps as ref_steps
from repro.models import init_model as ref_init_model
from repro.models import ssm as ref_ssm
from repro_torch import bridge
from repro_torch.config import get_arch
from repro_torch.config.base import TrainConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.launch import steps
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

torch.set_num_threads(1)

BF16 = torch.bfloat16
RTOL, ATOL = 8e-3, 1e-3          # chip_smoke.py: FA_TOL["bfloat16"]
MODEL_TOL = 2e-2
STEP_TOL = 1e-3
MOMENT_TOL = 5e-2

# (b, s, t, h, hkv, causal, window, q_offset), head dim apart: GQA
# groups 1, 2 and 5, causal, window, q_offset, non-causal, and rows that
# see no key (all of them, or some beside rows that see keys) -- the
# cases of tests/test_torch_kernel_bwd.py
FA_CASES = [
    (2, 37, 37, 4, 4, True, 0, 0),
    (1, 40, 40, 4, 2, True, 8, 0),
    (2, 24, 24, 5, 1, True, 0, 0),
    (1, 20, 50, 2, 1, True, 0, 30),
    (1, 30, 45, 4, 2, False, 0, 0),
    (1, 16, 40, 2, 1, False, 6, 50),
    (1, 20, 50, 5, 1, False, 8, 40),
]
HEAD_DIMS = (64, 80, 128)

# (b, s, d, n, with h0, with an incoming h_end gradient)
SS_CASES = [
    (2, 9, 5, 4, False, False),
    (1, 13, 6, 8, True, True),
    (2, 33, 7, 16, True, False),
    (1, 20, 3, 8, False, True),
]


def _bf16(a):
    """An f32 numpy array rounded to bf16: (torch bf16, ml_dtypes bf16)
    of the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(BF16)
    return t, t.float().numpy().astype(ml_dtypes.bfloat16)


def _assert_bf16_close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())))


def _leaf_close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def _fa_case(seed, b, s, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [_bf16(rng.standard_normal(shape))
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d),
                          (b, s, h, d))]


def _fa_fn_grads(q, k, v, do, **kw):
    """The bf16 gradients through ``flash_attention`` with grad on the
    CPU: ``FlashAttentionFn``."""
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*ins, **kw)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    assert out.dtype == BF16
    got = torch.autograd.grad(out, ins, do)
    assert all(g.dtype == BF16 for g in got)
    return out, got


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_fn_bf16_matches_jax_grad(case, d):
    """Against ``jax.grad`` of ``flash_attention_ref`` on k/v repeated
    per group, heads folded into the batch (the reference's
    ``gqa_flash_attention``), the same bf16 inputs and cotangent.  k and
    v are repeated after their upcast to f32, so that the transpose of
    the repeat sums each group's dk and dv in f32 and rounds once, as
    the port does (``jnp.repeat`` of the bf16 arrays would sum in bf16,
    one rounding an add: 4e-3 off a cancelling sum of 3.5e-2)."""
    b, s, t, h, hkv, causal, window, q_offset = case
    (q, qn), (k, kn), (v, vn), (do, don) = _fa_case(11, b, s, t, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rep = h // hkv

    def fold(x):
        return jnp.moveaxis(x, 2, 1).reshape(b * x.shape[2], x.shape[1], d)

    def loss(q, k, v):
        kx, vx = (jnp.repeat(x.astype(jnp.float32), rep, axis=2)
                  for x in (k, v))
        o = flash_attention_ref(fold(q), fold(kx), fold(vx), **kw)
        assert o.dtype == jnp.bfloat16
        o = jnp.moveaxis(o.reshape(b, h, s, d), 1, 2)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(don, jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                              for x in (qn, kn, vn)))
    assert all(w.dtype == jnp.bfloat16 for w in want)
    _, got = _fa_fn_grads(q, k, v, do, **kw)
    for g, w in zip(got, want):
        _assert_bf16_close(g, np.asarray(w, np.float32))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_fn_bf16_matches_f32_autograd(case, d):
    """Against autograd of ``gqa_plain`` in f32 on the upcast inputs (the
    comparison ``chip_smoke.py`` makes for the kernels); the forward is
    the plain forward in bf16 bit for bit."""
    b, s, t, h, hkv, causal, window, q_offset = case
    (q, _), (k, _), (v, _), (do, _) = _fa_case(12, b, s, t, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(fa.gqa_plain(*ref, **kw), ref, do.float())
    out, got = _fa_fn_grads(q, k, v, do, **kw)
    assert torch.equal(out.detach(), fa.gqa_plain(q, k, v, **kw))
    for g, w in zip(got, want):
        _assert_bf16_close(g, w.numpy())


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def _ssm_case(seed, b, s, d, n, with_h0, with_dhe):
    """bf16 x, dt, bc (B,S,2N) and dy; f32 a_log, h0 and dh_end; each as
    (torch, numpy) of the same values."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((b, s, d)))
    dt = _bf16(np.logaddexp(rng.standard_normal((b, s, d)) - 1.0, 0.0))
    bc = _bf16(rng.standard_normal((b, s, 2 * n)))
    al = (np.repeat(np.log(np.arange(1, n + 1, dtype=np.float32))[None],
                    d, 0) + 0.1 * rng.standard_normal((d, n))
          ).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32) if with_h0 \
        else None
    dy = _bf16(rng.standard_normal((b, s, d)))
    dhe = rng.standard_normal((b, d, n)).astype(np.float32) if with_dhe \
        else None
    return x, dt, bc, al, h0, dy, dhe


def _ssm_fn_grads(x, dt, bc, al, h0, dy, dhe, n, fn=ss.ssm_scan,
                  upcast=False):
    """Gradients of (x, dt, bc, a_log[, h0]) through ``fn`` (bf16 inputs,
    or upcast to f32), dy and dh_end as the cotangents."""
    ins = [x, dt, bc]
    leaves = [(t.float() if upcast else t).clone().requires_grad_(True)
              for t in ins]
    leaves.append(torch.from_numpy(al).requires_grad_(True))
    if h0 is not None:
        leaves.append(torch.from_numpy(h0).requires_grad_(True))
    y, h_end = fn(leaves[0], leaves[1], leaves[2][..., :n],
                  leaves[2][..., n:], leaves[3],
                  leaves[4] if h0 is not None else None)
    outs, cots = [y], [dy.float() if upcast else dy]
    if dhe is not None:
        outs.append(h_end)
        cots.append(torch.from_numpy(dhe))
    return y, torch.autograd.grad(outs, leaves, cots)


@pytest.mark.parametrize("case", SS_CASES)
def test_ssm_scan_fn_bf16_matches_jax_grad(case):
    """Against ``jax.grad`` of ``ssm_scan_ref`` (no state) or, with a
    starting state or an h_end gradient, of the reference model's
    ``ssm_core``, on the same bf16 x, dt, B, C and cotangent dy."""
    b, s, d, n, with_h0, with_dhe = case
    (x, xn), (dt, dtn), (bc, bcn), al, h0, (dy, dyn), dhe = \
        _ssm_case(13, *case)
    dyf = jnp.asarray(dyn, jnp.float32)
    if with_h0 or with_dhe:
        def loss(x, dt, bc, al, h0):
            y, h_end = ref_ssm.ssm_core({"A_log": al}, x, dt, bc, h0, n,
                                        chunk=s)
            out = jnp.sum(y.astype(jnp.float32) * dyf)
            return out + (jnp.sum(h_end * dhe) if dhe is not None else 0.0)
        h0j = jnp.asarray(h0 if h0 is not None
                          else np.zeros((b, d, n), np.float32))
        want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (xn, dtn, bcn, al)), h0j)
        if h0 is None:
            want = want[:4]
    else:
        def loss(x, dt, bc, al):
            y = ssm_scan_ref(x, dt, bc[..., :n], bc[..., n:], al)
            return jnp.sum(y.astype(jnp.float32) * dyf)
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (xn, dtn, bcn, al)))
    y, got = _ssm_fn_grads(x, dt, bc, al, h0, dy, dhe, n)
    assert "SSMScanFn" in type(y.grad_fn).__name__ and y.dtype == BF16
    assert [g.dtype for g in got[:3]] == [BF16] * 3
    for g, w in zip(got, want):
        _assert_bf16_close(g, np.asarray(w, np.float32))


@pytest.mark.parametrize("case", SS_CASES)
def test_ssm_scan_fn_bf16_matches_f32_autograd(case):
    """Against autograd of ``ssm_scan_plain`` in f32 on the upcast
    inputs (``chip_smoke.py``'s comparison for the kernel)."""
    b, s, d, n, with_h0, with_dhe = case
    (x, _), (dt, _), (bc, _), al, h0, (dy, _), dhe = _ssm_case(14, *case)
    _, want = _ssm_fn_grads(x, dt, bc, al, h0, dy, dhe, n,
                            fn=ss.ssm_scan_plain, upcast=True)
    _, got = _ssm_fn_grads(x, dt, bc, al, h0, dy, dhe, n)
    for g, w in zip(got, want):
        _assert_bf16_close(g, w.numpy())


# ---------------------------------------------------------------------------
# The model's kernel branches in bf16, routed to the wrappers on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["hymba-1.5b", "llama3.2-1b"])
def test_model_kernel_branches_bf16_carry_the_gradient(arch, monkeypatch):
    """Reduced hymba (banded attention, window 64; the SSM scan) and llama
    (chunked causal attention) at S=512 with bf16 parameters and both
    kernel routes forced: the attention and the scan go through
    ``FlashAttentionFn`` and ``SSMScanFn`` on bf16 tensors, and every
    parameter's gradient is the plain branches' within ``MODEL_TOL``."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import init_model, lm_loss
    from repro_torch.models import ssm as ssm_lib
    cfg = get_arch(arch).reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0), dtype=BF16)
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

    def rec_fa(q, *a):
        fns.append(("fa", q.dtype))
        return real_fa(q, *a)

    def rec_ss(x, *a):
        fns.append(("ss", x.dtype))
        return real_ss(x, *a)

    monkeypatch.setattr(attn_lib, "_kernel_route", lambda q: True)
    monkeypatch.setattr(ssm_lib, "_kernel_route", lambda x: True)
    monkeypatch.setattr(fa.FlashAttentionFn, "apply", rec_fa)
    monkeypatch.setattr(ss.SSMScanFn, "apply", rec_ss)
    got_loss, got = grads()
    assert fns.count(("fa", BF16)) == cfg.num_layers
    assert fns.count(("ss", BF16)) == (cfg.num_layers
                                       if cfg.family == "hybrid" else 0)
    assert len(fns) == fns.count(("fa", BF16)) + fns.count(("ss", BF16))
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=STEP_TOL)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and float(g.float().abs().sum()) > 0
        _leaf_close(g, w.float().numpy(), MODEL_TOL)


# ---------------------------------------------------------------------------
# The bf16 train step against the reference's
# ---------------------------------------------------------------------------

_TCFG = dict(dtype="bfloat16", remat=True, attn_chunk_q=128,
             attn_chunk_kv=128)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float32))
    e = np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b"])
def test_bf16_train_step_matches_reference(arch):
    """One AdamW step (clip 1.0, remat "full") of each side's
    ``make_train_step`` with ``dtype="bfloat16"`` from the same bf16
    parameters (the reference's ``init_model``, bridged) on the same
    tokens: loss and grad norm, the moments, and every parameter within
    the step bound plus one bf16 ulp, their mean difference far below
    it; the parameters keep their dtypes and are updated in place."""
    ref_cfg = ref_get_arch(arch).reduced()
    ref_p = ref_init_model(ref_cfg, jax.random.PRNGKey(0),
                           dtype=jnp.bfloat16)
    pt_p = bridge.from_reference(jax.device_get(ref_p), "cpu")
    dtypes = {l.dtype for l in tree_leaves(pt_p)}
    assert BF16 in dtypes
    tokens = np.random.default_rng(5).integers(0, ref_cfg.vocab_size,
                                               (2, 128))
    ref_step, ref_opt = ref_steps.make_train_step(ref_cfg,
                                                  RefTrainConfig(**_TCFG))
    ref_new, ref_state, ref_m = ref_step(ref_p, ref_opt.init(ref_p),
                                         {"tokens": jnp.asarray(tokens)})
    step, opt = steps.make_train_step(get_arch(arch).reduced(),
                                      TrainConfig(**_TCFG))
    state = opt.init(pt_p)
    before = [l.dtype for l in tree_leaves(pt_p)]
    new, state, m = step(pt_p, state, {"tokens": torch.from_numpy(tokens)})
    assert new is pt_p                      # updated in place
    assert [l.dtype for l in tree_leaves(new)] == before
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=STEP_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=STEP_TOL)
    assert int(state["t"]) == int(ref_state["t"]) == 1
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(state[key]),
                        jax.tree_util.tree_leaves(ref_state[key])):
            assert a.dtype == torch.float32
            a, b = a.numpy(), np.asarray(b)
            if key == "v":
                a, b = np.sqrt(a), np.sqrt(b)
            _leaf_close(torch.from_numpy(a), b, MOMENT_TOL)
    tcfg = TrainConfig(**_TCFG)
    lr, wd = tcfg.lr, tcfg.weight_decay
    diffs = []
    for a, b, p0 in zip(tree_leaves(new), jax.tree_util.tree_leaves(ref_new),
                        jax.tree_util.tree_leaves(ref_p)):
        b = np.asarray(b, np.float32)
        p0 = np.abs(np.asarray(p0, np.float32))
        diff = np.abs(a.float().numpy() - b)
        bound = 2 * lr * (1 + wd * p0) * 1.001 \
            + _bf16_ulp(np.maximum(np.abs(b), p0))
        assert (diff <= bound).all(), float((diff - bound).max())
        diffs.append(diff.ravel())
    assert float(np.mean(np.concatenate(diffs))) < 0.05 * lr
