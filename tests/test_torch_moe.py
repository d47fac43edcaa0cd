"""The port's MoE (``repro_torch/models/moe.py``) against the JAX
package's ``models/moe.py``: every case of ``tests/test_moe.py``
restated on the port (no-drop dense oracle, dense residual, capacity
drops, ``capacity_for`` bounds, finite outputs at any shape, the decode
single-group fallback), and the port on bridged reference parameters
and the same numpy inputs against the reference itself: outputs and aux
within 1e-5 (f32), the dispatch indices exactly, ties included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as ref_moe
from repro_torch import bridge
from repro_torch.models import moe
from repro_torch.models.layers import mlp
from repro_torch.tree import tree_flatten

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
TOL = 1e-5           # f32: the port against the reference, same inputs


def _params(d, ff, e, activation="swiglu", dense_residual=False,
            dense_ff=0, key=KEY):
    """(reference params, the port's bridged copy)."""
    ref = ref_moe.init_moe(key, d, ff, e, activation,
                           dense_residual=dense_residual, dense_ff=dense_ff)
    return ref, bridge.from_reference(jax.device_get(ref), "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _naive(p, x, top_k, activation="swiglu", dense_residual=False):
    """The dense oracle of ``tests/test_moe.py`` in torch: every expert
    on every token, weighted by the renormalised top-k gates."""
    e = p["router"].shape[1]
    probs = torch.softmax(x.float() @ p["router"], -1)
    gv, ei = torch.sort(probs, dim=-1, descending=True, stable=True)
    gv, ei = gv[..., :top_k], ei[..., :top_k]
    gv = gv / gv.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for ex in range(e):
        if activation == "swiglu":
            h = F.silu(x @ p["w_gate"][ex]) * (x @ p["w_up"][ex])
        else:
            h = F.gelu(x @ p["w_up"][ex], approximate="tanh")
        fe = h @ p["w_down"][ex]
        w = ((ei == ex) * gv).sum(-1)
        y = y + fe * w[..., None]
    if dense_residual:
        y = y + mlp(p["dense_mlp"], x, activation)
    return y


def _both(ref_p, p, x, **kw):
    """(port y, port aux, reference y, reference aux) as numpy."""
    y, aux = moe.moe_ffn(p, torch.from_numpy(x), **kw)
    ry, raux = ref_moe.moe_ffn(ref_p, jnp.asarray(x), **kw)
    return y.numpy(), float(aux), np.asarray(ry), float(raux)


# -- the cases of tests/test_moe.py, on the port ------------------------

@pytest.mark.parametrize("e,k,g", [(4, 2, 8), (8, 2, 16), (4, 1, 8)])
def test_moe_matches_dense_oracle_no_drops(e, k, g):
    d, ff = 16, 32
    _, p = _params(d, ff, e)
    x = torch.from_numpy(_x((2, g, d)))
    y, aux = moe.moe_ffn(p, x, top_k=k, activation="swiglu",
                         capacity_factor=float(e))   # no drops possible
    np.testing.assert_allclose(y.numpy(), _naive(p, x, k).numpy(),
                               rtol=2e-5, atol=2e-5)
    assert 0.5 <= float(aux) <= float(e)


def test_moe_dense_residual():
    d, ff, e, k = 16, 32, 4, 2
    _, p = _params(d, ff, e, dense_residual=True, dense_ff=24)
    x = torch.from_numpy(_x((1, 8, d)))
    y, _ = moe.moe_ffn(p, x, top_k=k, activation="swiglu",
                       capacity_factor=4.0, dense_residual=True)
    np.testing.assert_allclose(
        y.numpy(), _naive(p, x, k, dense_residual=True).numpy(),
        rtol=2e-5, atol=2e-5)


def test_capacity_drops_reduce_output_norm():
    """With capacity 1 slot/expert, overflow tokens pass through as zero
    MoE output: norms shrink against no-drop routing."""
    d, ff, e, k = 8, 16, 2, 1
    _, p = _params(d, ff, e, "gelu")
    x = torch.from_numpy(_x((1, 16, d)))
    y_full, _ = moe.moe_ffn(p, x, top_k=k, activation="gelu",
                            capacity_factor=float(e * 16))
    y_tight, _ = moe.moe_ffn(p, x, top_k=k, activation="gelu",
                             capacity_factor=0.1)
    assert float(torch.linalg.norm(y_tight)) < \
        float(torch.linalg.norm(y_full))


def test_capacity_for_bounds():
    assert moe.capacity_for(16, 2, 4, 1.25) == 10
    assert moe.capacity_for(1, 2, 8, 1.25) == 1
    assert moe.capacity_for(100, 2, 4, 100.0) == 200   # clamped to S*k
    for g in (1, 7, 16, 4096):
        for k in (1, 2):
            for e in (2, 8, 128):
                for f in (0.1, 1.0, 1.25, float(e)):
                    assert moe.capacity_for(g, k, e, f) == \
                        ref_moe.capacity_for(g, k, e, f)


@pytest.mark.parametrize("e_log,k,g", [
    (2, 2, 7), (3, 1, 16), (2, 1, 4), (3, 2, 9), (4, 2, 32), (5, 1, 12),
    (4, 1, 21), (5, 2, 5)])
def test_moe_output_finite_any_shape(e_log, k, g):
    e = 2 ** e_log
    k = min(k, e)
    d, ff = 8, 16
    ref_p, p = _params(d, ff, e)
    x = _x((1, g, d))
    y, aux, ry, raux = _both(ref_p, p, x, top_k=k, activation="swiglu",
                             capacity_factor=1.25)
    assert y.shape == x.shape
    assert np.isfinite(y).all()
    assert aux >= 0.99  # load-balance loss lower bound is ~1
    np.testing.assert_allclose(y, ry, rtol=TOL, atol=TOL)
    assert abs(aux - raux) <= TOL * max(1.0, abs(raux))


def test_decode_single_token_group_fallback():
    d, ff, e, k = 8, 16, 4, 2
    ref_p, p = _params(d, ff, e)
    x = _x((8, 1, d))                                  # decode layout
    y, _ = moe.moe_ffn(p, torch.from_numpy(x), top_k=k,
                       activation="swiglu", capacity_factor=2.0)
    np.testing.assert_allclose(
        y.numpy(), _naive(p, torch.from_numpy(x), k).numpy(), rtol=2e-5,
        atol=2e-5)
    ry, _ = ref_moe.moe_ffn(ref_p, jnp.asarray(x), top_k=k,
                            activation="swiglu", capacity_factor=2.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=TOL,
                               atol=TOL)


# -- the port against the reference on the same inputs -----------------

@pytest.mark.parametrize("act,dense,e,k,b,s,group,factor", [
    ("swiglu", False, 4, 2, 2, 16, 0, 1.25),      # drops, a group a row
    ("swiglu", False, 8, 2, 2, 24, 16, 1.0),      # groups over rows, drops
    ("swiglu", True, 4, 2, 1, 12, 5, 1.25),       # 12 % 5: one group
    ("gelu", False, 4, 1, 3, 10, 0, 0.5),         # tight capacity
    ("squared_relu", True, 8, 2, 2, 9, 6, 2.0),   # dense residual, groups
    ("swiglu", False, 8, 2, 4, 1, 0, 1.25),       # decode: groups of one
])
def test_moe_ffn_matches_reference(act, dense, e, k, b, s, group, factor):
    d, ff = 16, 24
    ref_p, p = _params(d, ff, e, act, dense_residual=dense, dense_ff=20)
    x = _x((b, s, d), seed=3)
    y, aux, ry, raux = _both(ref_p, p, x, top_k=k, activation=act,
                             capacity_factor=factor, group_size=group,
                             dense_residual=dense)
    np.testing.assert_allclose(y, ry, rtol=TOL, atol=TOL)
    assert abs(aux - raux) <= TOL * max(1.0, abs(raux))


def _route_both(x, router, k, cap):
    got = moe._route_group(torch.from_numpy(x), torch.from_numpy(router),
                           k, cap)
    want = jax.vmap(lambda xx: ref_moe._route_group(
        xx, jnp.asarray(router), k, cap))(jnp.asarray(x))
    return [t.numpy() for t in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("g,s,e,k,cap", [(2, 16, 4, 2, 5), (3, 9, 8, 2, 1),
                                         (1, 20, 8, 1, 20)])
def test_route_group_matches_reference(g, s, e, k, cap):
    """Every dispatch output of a batch of groups: the indices and masks
    exactly, the gates and probabilities within 1e-6."""
    rng = np.random.default_rng(g * 100 + s)
    x = rng.standard_normal((g, s, 8)).astype(np.float32)
    router = rng.standard_normal((8, e)).astype(np.float32)
    got, want = _route_both(x, router, k, cap)
    for name, a, w in zip(("src_token", "slot_valid", "tok_slot",
                           "tok_keep"), got[:4], want[:4]):
        np.testing.assert_array_equal(a, w, err_msg=name)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[5], want[5], rtol=1e-6, atol=1e-6)


def test_equal_router_probabilities_pick_the_reference_experts():
    """A zero router: every probability is 1/E, and the top k are the k
    lowest expert ids (``jax.lax.top_k``'s order on a tie), so every
    token takes experts 0..k-1 and the capacity drops fall on the same
    tokens; the first maximum of the aux loss is expert 0."""
    d, ff, e, k = 8, 16, 8, 2
    ref_p, p = _params(d, ff, e)
    ref_p = dict(ref_p, router=jnp.zeros_like(ref_p["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _x((2, 12, d), seed=5)
    got, want = _route_both(x.reshape(2, 12, d), np.zeros((d, e),
                                                          np.float32), k, 4)
    for a, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, w)
    assert (got[2] // 4 == np.arange(k)).all()          # experts 0 and 1
    y, aux, ry, raux = _both(ref_p, p, x, top_k=k, activation="swiglu",
                             capacity_factor=1.0)
    np.testing.assert_allclose(y, ry, rtol=TOL, atol=TOL)
    assert abs(aux - raux) <= TOL and abs(aux - 1.0) <= TOL


def test_init_moe_keys_shapes_and_leaf_order_match_the_reference():
    for act, dense in (("swiglu", True), ("gelu", False)):
        ref = ref_moe.init_moe(KEY, 16, 24, 4, act, dense_residual=dense,
                               dense_ff=20)
        mine = moe.init_moe(torch.Generator().manual_seed(0), 16, 24, 4,
                            act, dense_residual=dense, dense_ff=20)
        leaves, treedef = tree_flatten(mine)
        ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
        assert treedef == tree_flatten(
            bridge.from_reference(jax.device_get(ref), "cpu"))[1]
        assert [tuple(t.shape) for t in leaves] == \
            [tuple(r.shape) for r in ref_leaves]
        assert [str(t.dtype).removeprefix("torch.") for t in leaves] == \
            [str(r.dtype) for r in ref_leaves]
