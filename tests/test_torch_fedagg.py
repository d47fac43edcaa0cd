"""The port's aggregation (plain fedagg, tree path, per-leaf path) and
the client mesh's per-shard partial sum (plain ``fedagg_partial``)
against the reference's Pallas kernels in interpret mode and their jnp
oracles.  Tolerance rtol=1e-5, atol=1e-6: f32 row sums in another
order."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.kernels import fedagg_op as ref_fedagg_op
from repro.kernels import fedagg_partial_op as ref_fedagg_partial_op
from repro.kernels import ops as ref_ops
from repro.kernels.ref import fedagg_partial_ref, fedagg_ref
from repro_torch import bridge
from repro_torch.core import aggregation as pt_agg
from repro_torch.kernels import fedagg as fedagg_mod
from repro_torch.kernels import (fedagg_op, fedagg_partial_op,
                                 fedagg_pytree, ops)
from repro_torch.kernels.fedagg import fedagg_partial_plain, fedagg_plain
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _case(name):
    rng = np.random.default_rng(len(name))
    n, p = {"odd-p": (5, 1237), "tiny": (1, 3), "wide": (9, 4096)}.get(
        name, (6, 515))
    u = rng.normal(size=(n, p)).astype(np.float32)
    w = rng.uniform(1, 50, n).astype(np.float32)
    a = None
    if name == "alphas":
        a = rng.uniform(0, 1, n).astype(np.float32)
        a[1] = 0.0
    if name == "masked-inf-nan":
        u[0], u[3] = np.inf, np.nan
        w[0], w[3] = 0.0, 0.0
    if name == "negative-and-nan-weights":
        w[2], w[4] = -3.0, np.nan
        u[4] = np.inf
    if name == "all-zero":
        w[:] = 0.0
    return u, w, a


CASES = ["odd-p", "tiny", "wide", "alphas", "masked-inf-nan",
         "negative-and-nan-weights", "all-zero"]


@pytest.mark.parametrize("name", CASES)
def test_fedagg_plain_matches_reference_kernel_and_oracle(name):
    u, w, a = _case(name)
    ja = None if a is None else jnp.asarray(a)
    kernel = np.asarray(ref_fedagg_op(jnp.asarray(u), jnp.asarray(w),
                                      alphas=ja, interpret=True))
    oracle = np.asarray(fedagg_ref(jnp.asarray(u), jnp.asarray(w), ja))
    before = fedagg_mod.launches
    got = fedagg_op(torch.from_numpy(u), torch.from_numpy(w),
                    alphas=None if a is None else torch.from_numpy(a))
    assert fedagg_mod.launches == before      # CPU tensor: no launch
    assert got.dtype == torch.float32 and got.shape == (u.shape[1],)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)
    if name == "all-zero":
        assert not got.numpy().any()


def test_fedagg_plain_keeps_the_row_dtype_and_accumulates_in_f32():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(7, 33)).astype(ml_dtypes.bfloat16)
    w = rng.uniform(1, 9, 7).astype(np.float32)
    want = np.asarray(fedagg_ref(jnp.asarray(u), jnp.asarray(w)))
    got = fedagg_plain(bridge.to_torch(u, "cpu"), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               want.astype(np.float32), rtol=1e-2, atol=1e-2)


def test_padding_rows_of_weight_zero_change_nothing():
    u, w, _ = _case("odd-p")
    base = fedagg_plain(torch.from_numpy(u), torch.from_numpy(w))
    u2 = np.concatenate([u, np.repeat(u[-1:], 3, 0)])
    w2 = np.concatenate([w, np.zeros(3, np.float32)])
    padded = fedagg_plain(torch.from_numpy(u2), torch.from_numpy(w2))
    np.testing.assert_allclose(padded.numpy(), base.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_wrapper_rejects_wrong_shapes():
    u = torch.zeros(3, 5)
    with pytest.raises(ValueError):
        fedagg_op(u, torch.ones(4))
    with pytest.raises(ValueError):
        fedagg_op(u[0], torch.ones(3))
    with pytest.raises(ValueError):
        fedagg_op(u, torch.ones(3), alphas=torch.ones(2))


def _mixed_tree(n=5, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)
    return {"convs": [{"w": f32(3, 3, 1, 4), "b": f32(4)},
                      {"w": f32(3, 3, 4, 2), "b": f32(2)}],
            "head": {"w": f32(7, 3).astype(ml_dtypes.bfloat16),
                     "s": f32()},
            "aux": (f32(2), f32(1, 2))}


def test_flatten_updates_has_the_reference_leaf_order():
    tree = _mixed_tree()
    buf_ref, _, spec_ref = ref_ops.flatten_updates(
        jax.tree_util.tree_map(jnp.asarray, tree))
    buf, _, spec = ops.flatten_updates(bridge.from_reference(tree, "cpu"))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(buf_ref))
    assert [(o, s, tuple(sh)) for o, s, sh, _ in spec] == \
        [(o, s, tuple(sh)) for o, s, sh, _ in spec_ref]
    row = jax.tree_util.tree_map(lambda a: a[0], tree)
    np.testing.assert_array_equal(
        ops.flatten_params_row(bridge.from_reference(row, "cpu")).numpy(),
        np.asarray(ref_ops.flatten_params_row(
            jax.tree_util.tree_map(jnp.asarray, row))))
    _, spec1, total = ops.tree_spec(bridge.from_reference(row, "cpu"))
    _, spec1_ref, total_ref = ref_ops.tree_spec(
        jax.tree_util.tree_map(jnp.asarray, row))
    assert total == total_ref == buf.shape[1]
    assert [(o, s, sh) for o, s, sh, _ in spec1] == \
        [(o, s, sh) for o, s, sh, _ in spec1_ref]


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    got_leaves = tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        if g.dtype == torch.bfloat16:       # one bf16 ulp at these sizes
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32),
                                       rtol=1e-2, atol=1e-2)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("weights,alphas", [
    ([3.0, 1.0, 4.0, 1.0, 5.0], None),
    ([3.0, 0.0, 4.0, 0.0, 5.0], None),
    ([3.0, 1.0, 4.0, 1.0, 5.0], [1.0, 0.5, 0.0, 0.25, 1.0]),
    ([0.0, 0.0, 0.0, 0.0, 0.0], None),
])
def test_weighted_average_stacked_matches_reference(use_kernel, weights,
                                                    alphas):
    tree = _mixed_tree()
    if weights[1] == 0.0:                    # garbage in the masked rows
        tree["convs"][0]["w"][1] = np.nan
        tree["aux"][0][3] = np.inf
    want = ref_agg.weighted_average_stacked(
        jax.tree_util.tree_map(jnp.asarray, tree), np.asarray(weights),
        alphas=alphas, use_kernel=use_kernel, interpret=True)
    got = pt_agg.weighted_average_stacked(
        bridge.from_reference(tree, "cpu"), weights, alphas=alphas,
        use_kernel=use_kernel)
    _assert_trees_close(got, want)
    if use_kernel:
        again = fedagg_pytree(
            bridge.from_reference(tree, "cpu"), torch.tensor(weights),
            alphas=None if alphas is None else torch.tensor(alphas))
        for a, b in zip(tree_leaves(again), tree_leaves(got)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("weights", [[2.0, 0.0, 1.0, 0.0, 7.0],
                                     [0.0, 0.0, 0.0, 0.0, 0.0]])
def test_aggregate_or_keep_matches_reference(use_kernel, weights):
    tree = _mixed_tree(seed=1)
    params = jax.tree_util.tree_map(lambda a: a[0] * 0 + 0.5, tree)
    want = ref_agg.aggregate_or_keep(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, tree), np.asarray(weights),
        use_kernel=use_kernel, interpret=True)
    p_pt = bridge.from_reference(params, "cpu")
    got = pt_agg.aggregate_or_keep(p_pt, bridge.from_reference(tree, "cpu"),
                                   weights, use_kernel=use_kernel)
    _assert_trees_close(got, want)
    if not any(weights):
        for a, b in zip(tree_leaves(got), tree_leaves(p_pt)):
            assert torch.equal(a, b)


def test_weighted_average_list_form_and_empty_list():
    tree = _mixed_tree(n=3, seed=2)
    rows = [jax.tree_util.tree_map(lambda a: a[i], tree) for i in range(3)]
    want = ref_agg.weighted_average(
        [jax.tree_util.tree_map(jnp.asarray, r) for r in rows], [1, 2, 3])
    got = pt_agg.weighted_average(
        [bridge.from_reference(r, "cpu") for r in rows], [1, 2, 3])
    _assert_trees_close(got, want)
    with pytest.raises(ValueError):
        pt_agg.weighted_average([], [])


# ---------------------------------------------------------------------------
# fedagg_partial: one client-mesh shard's unnormalised masked row sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_fedagg_partial_plain_matches_reference_kernel_and_oracle(name):
    u, w, a = _case(name)
    coef = w if a is None else w * a
    # coefficients of the size a shard sees in the staleness merge
    # (sum <= 1), so the stated f32 tolerance bounds reassociation of
    # sums of order one; masked entries (0, negative, NaN) stay as made
    total = np.where(coef > 0, coef, 0.0).sum()
    if total > 0:
        coef = np.where(coef > 0, coef / total, coef)
    coef = coef.astype(np.float32)
    kernel = np.asarray(ref_fedagg_partial_op(
        jnp.asarray(u), jnp.asarray(coef), block_p=128, interpret=True))
    oracle = np.asarray(fedagg_partial_ref(jnp.asarray(u), jnp.asarray(coef)))
    before = fedagg_mod.partial_launches
    got = fedagg_partial_op(torch.from_numpy(u), torch.from_numpy(coef))
    assert fedagg_mod.partial_launches == before  # CPU tensor: no launch
    assert got.dtype == torch.float32 and got.shape == (u.shape[1],)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, fedagg_partial_plain(torch.from_numpy(u),
                                                 coef))
    if name == "all-zero":
        assert not got.numpy().any()


def test_fedagg_partial_is_unnormalised_and_masked():
    u = torch.tensor([[2.0, 4.0], [np.nan, np.nan], [1.0, 1.0]])
    got = fedagg_partial_op(u, [0.5, 0.0, 2.0])
    assert got.tolist() == [3.0, 4.0]
    got = fedagg_partial_op(u, [0.5, float("nan"), -1.0])
    assert got.tolist() == [1.0, 2.0]


@pytest.mark.parametrize("k", [3, 5, 7])
def test_fedagg_partial_appended_zero_rows_are_bitwise(k):
    """The plan's zero rows with zero coefficients (here: 8 - k of them,
    holding garbage) leave every output bit unchanged."""
    rng = np.random.default_rng(k)
    u = rng.normal(size=(k, 515)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, k).astype(np.float32)
    c[1] = 0.0
    base = fedagg_partial_plain(torch.from_numpy(u), c)
    pad = np.full((8 - k, 515), np.nan, np.float32)
    padded = fedagg_partial_plain(
        torch.from_numpy(np.concatenate([u, pad])),
        np.concatenate([c, np.zeros(8 - k, np.float32)]))
    assert torch.equal(base, padded)


def test_fedagg_partial_plain_keeps_the_row_dtype():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(5, 33)).astype(ml_dtypes.bfloat16)
    c = rng.uniform(0.1, 2.0, 5).astype(np.float32)
    want = np.asarray(fedagg_partial_ref(jnp.asarray(u), jnp.asarray(c)))
    got = fedagg_partial_plain(bridge.to_torch(u, "cpu"), torch.from_numpy(c))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               want.astype(np.float32), rtol=1e-2, atol=1e-2)


def test_fedagg_partial_wrapper_rejects_wrong_shapes():
    u = torch.zeros(3, 5)
    with pytest.raises(ValueError):
        fedagg_partial_op(u, torch.ones(4))
    with pytest.raises(ValueError):
        fedagg_partial_op(u[0], torch.ones(3))
