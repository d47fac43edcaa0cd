"""K4 at head dims 80 (hubert), 128 (mixtral, arctic, phi4-mini, granite,
chameleon) and 192 (nemotron): the port's plain twins (``flash_attention_plain``,
``gqa_plain``, ``flash_attention_fwd_plain``,
``flash_attention_bwd_plain``) against the JAX package's Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` runs it, its GQA
wrapper, and ``jax.grad`` of its jnp attention oracle.  The CUDA
kernels' instantiations at these widths are held against the same twins
on the card by ``chip_smoke.py`` (``WIDE_HEAD_CASES``).

Tolerances: 2e-5 for the forward (f32 softmax sums in another order, the
reference's own kernel-test tolerance), 1e-4 for the gradients and the
row log-sum-exp (``tests/test_torch_kernel_bwd.py``'s).  A head dim
outside ``HEAD_DIMS`` still raises before any launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gqa_flash_attention as ref_gqa
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

FWD_TOL = 2e-5
BWD_TOL = 1e-4

# (s, t, causal, window, q_offset), multiples of the Pallas kernel's
# 32-row blocks: causal, causal with a window and q_offset, full
# attention at T over S, and rows that see no key beside rows that do
# (non-causal, window 32)
SHAPES = [(128, 128, True, 0, 0), (96, 160, True, 24, 64),
          (64, 192, False, 0, 0), (64, 128, False, 32, 140)]


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("d", [80, 128, 192])
@pytest.mark.parametrize("s,t,causal,window,q_offset", SHAPES)
def test_plain_twin_matches_pallas_kernel(d, s, t, causal, window,
                                          q_offset):
    rng = np.random.default_rng(d + s + t)
    q, k, v = _randn(rng, 2, s, d), _randn(rng, 2, t, d), \
        _randn(rng, 2, t, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=32, block_k=32, interpret=True, **kw)
    got = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("d,h,hkv,window", [(128, 8, 2, 0), (128, 4, 1, 40),
                                            (192, 12, 1, 0),
                                            (192, 6, 2, 40),
                                            (80, 16, 16, 0),
                                            (80, 8, 2, 40)])
def test_gqa_plain_matches_reference_wrapper(d, h, hkv, window):
    """GQA groups of 4 (mixtral), 12 (nemotron), 3 and 4 with a window,
    and hubert's MHA (a group of 1): the model layout against the
    reference's Pallas GQA wrapper."""
    rng = np.random.default_rng(d * h)
    q = _randn(rng, 1, 96, h, d)
    k, v = _randn(rng, 1, 96, hkv, d), _randn(rng, 1, 96, hkv, d)
    want = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, window=window, block_q=32, block_k=32,
                   interpret=True)
    got = fa.gqa_plain(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    # the wrapper on CPU tensors is that twin
    wrapped = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=window)
    assert torch.equal(wrapped, got)


def _gqa_case(seed, b, s, t, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [_randn(rng, *shape) for shape in ((b, s, h, d), (b, t, hkv, d),
                                             (b, t, hkv, d), (b, s, h, d))]


# (b, s, t, h, hkv, d, causal, window, q_offset)
GRAD_CASES = [(1, 40, 40, 4, 1, 128, True, 0, 0),
              (1, 33, 57, 4, 2, 128, True, 12, 24),
              (1, 24, 48, 6, 2, 192, False, 0, 0),
              (1, 20, 50, 3, 1, 192, False, 8, 40),
              (1, 36, 36, 4, 4, 80, False, 0, 0),
              (1, 30, 52, 4, 2, 80, True, 10, 22)]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_fwd_and_bwd_plain_match_jax_grad(case):
    """The forward with lse and the backward twin against the reference's
    jnp oracle on k/v repeated per group, heads folded into the batch:
    out, the rows' log-sum-exp, and ``jax.grad`` for dq, dk and dv (dk,
    dv summed back over each group)."""
    b, s, t, h, hkv, d, causal, window, q_offset = case
    q, k, v, do = _gqa_case(sum(case), b, s, t, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rep = h // hkv

    def fold(x):
        return jnp.moveaxis(x, 2, 1).reshape(b * x.shape[2], x.shape[1], d)

    def attend(q, k, v):
        kx, vx = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        o = flash_attention_ref(fold(q), fold(kx), fold(vx), **kw)
        return jnp.moveaxis(o.reshape(b, h, s, d), 1, 2)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want_out = attend(jq, jk, jv)
    want = jax.grad(lambda *a: jnp.sum(attend(*a) * do),
                    argnums=(0, 1, 2))(jq, jk, jv)
    # the rows' log-sum-exp of the masked, scaled scores
    pos = np.arange(s) + q_offset
    keys = np.arange(t)
    vis = np.ones((s, t), bool)
    if causal:
        vis &= keys[None] <= pos[:, None]
    if window > 0:
        vis &= keys[None] > pos[:, None] - window
    scores = jnp.einsum("bshd,bthd->bhst", jq, jnp.repeat(jk, rep, axis=2)) \
        / np.sqrt(d)
    want_lse = jax.nn.logsumexp(jnp.where(vis, scores, -1e30), axis=-1)

    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_out),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=BWD_TOL, atol=BWD_TOL)
    got = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse,
                                       torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BWD_TOL,
                                   atol=BWD_TOL)
    # the autograd Function on CPU tensors carries the same gradients
    ins = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    out = fa.flash_attention(*ins, **kw)
    for g, w in zip(torch.autograd.grad(out, ins, torch.from_numpy(do)),
                    got):
        assert torch.equal(g, w)


def test_head_dims_have_kernels_and_others_raise():
    """80, 128 and 192 are instantiated; any other head dim is refused
    with ``ValueError`` before a library is loaded or a kernel
    launched."""
    assert {80, 128, 192} <= set(fa.HEAD_DIMS)
    for d in (8, 72, 96, 256):
        q = torch.zeros(1, 4, 2, d)
        k = torch.zeros(1, 4, 1, d)
        before = fa.launches
        with pytest.raises(ValueError, match="instantiated"):
            fa._kernel_forward(q, k, k, True, 0, 0, False)
        assert fa.launches == before
