"""The port's client-state store (``ClientStateStore``, f32 rows + int32
sidecar) and the engine's window step, against the JAX package's store
on the same numpy templates, and against the port's own dict path bit
for bit.  Round trips are exact in both packages; merges agree with the
reference within rtol=atol=1e-6 (f32 row sums in another order; bf16
leaves to one ulp)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.core.state import ClientStateStore as RefStore
from repro.core.state import wire_bytes as ref_wire_bytes
from repro_torch import bridge
from repro_torch.core.aggregation import (staleness_merge_coefficients,
                                          staleness_weighted_merge)
from repro_torch.core.engine import make_engine
from repro_torch.core.state import ClientStateStore, wire_bytes
from repro_torch.fl.testing import SyntheticCohortTrainer
from repro_torch.tree import tree_leaves, tree_map, tree_stack

torch.set_num_threads(1)


def _template_np(seed=0):
    """Mixed-dtype model tree: 2-d f32, bf16 vector, f16 vector, scalar
    — every leaf round-trips exactly through f32 rows."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32).astype(
                ml_dtypes.bfloat16),
            "h": rng.normal(size=(3,)).astype(np.float16),
            "s": np.asarray(rng.normal(), np.float32)}


def _int_template_np(seed=0):
    """Every non-float leaf dtype the int32 sidecar must carry exactly."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 2)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32).astype(
                ml_dtypes.bfloat16),
            "step": np.asarray(rng.integers(0, 1000), np.int32),
            "mask": rng.integers(0, 2, size=(5,)).astype(bool),
            "i8": rng.integers(-128, 128, size=(3,)).astype(np.int8),
            "u16": rng.integers(0, 2 ** 16, size=(2,)).astype(np.uint16),
            "u32": np.asarray([2 ** 31 + 5, 3], np.uint32)}  # > int32 max


def _pt(tree_np):
    return bridge.from_reference(tree_np, "cpu")


def _jx(tree_np):
    return jax.tree_util.tree_map(jnp.asarray, tree_np)


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _close_to_reference(got, want, tol=1e-6):
    """Port tree vs reference tree: same dtypes, values within tol (one
    ulp for bf16/f16 leaves)."""
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        if g.dtype.is_floating_point:
            t = 1e-2 if g.dtype in (torch.bfloat16, torch.float16) else tol
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32), rtol=t, atol=t)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def _row(tree, i):
    return tree_map(lambda l: l[i], tree)


# ---------------------------------------------------------------------------
# flat row <-> tree round trips
# ---------------------------------------------------------------------------

def test_flatten_unflatten_roundtrip_exact_mixed_dtypes():
    t_np = _template_np(1)
    store, ref = ClientStateStore(_pt(t_np), 4), RefStore(_jx(t_np), 4)
    flat = store.flatten(_pt(t_np))
    assert flat.dtype == torch.float32 and flat.shape == (store.p,)
    assert store.p == ref.p and store.pi == ref.pi == 0
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ref.flatten(_jx(t_np))))
    _tree_equal(store.unflatten(flat), _pt(t_np))


def test_store_initializes_every_row_to_template():
    t = _pt(_template_np(2))
    store = ClientStateStore(t, 5)
    assert store.buffer.shape == (5, store.p)
    for c in (0, 2, 4):
        _tree_equal(store.gather_one(c), t)
    stacked = store.gather([1, 3])
    for i in range(2):
        _tree_equal(_row(stacked, i), t)


@pytest.mark.parametrize("leaf", [
    torch.zeros(2, dtype=torch.complex64), torch.zeros(2, dtype=torch.int64),
    torch.zeros(2, dtype=torch.float64), torch.zeros(2, dtype=torch.uint64)])
def test_store_rejects_leaves_without_exact_carrier(leaf):
    with pytest.raises(TypeError):
        ClientStateStore({"w": torch.zeros(3), "x": leaf}, 2)


def test_store_rejects_zero_clients_and_later_slice_row_formats():
    with pytest.raises(ValueError):
        ClientStateStore(_pt(_template_np()), 0)
    # int8 rows are ported: a float template builds a quantized store,
    # a template with no float leaf has nothing to quantize
    assert ClientStateStore(_pt(_template_np()), 2,
                            quant_bits=8).quant_bits == 8
    with pytest.raises(ValueError):
        ClientStateStore({"step": torch.zeros((), dtype=torch.int32)}, 2,
                         quant_bits=8)
    with pytest.raises(ValueError):
        ClientStateStore(_pt(_template_np()), 2, quant_bits=16)


def test_store_int_bool_leaves_roundtrip_exactly():
    t_np, t2_np = _int_template_np(40), _int_template_np(41)
    t, t2 = _pt(t_np), _pt(t2_np)
    assert t["u32"].dtype == torch.uint32
    store, ref = ClientStateStore(t, 4), RefStore(_jx(t_np), 4)
    assert store.pi == ref.pi > 0 and store.p == ref.p
    _tree_equal(store.gather_one(1), t)
    frow, irow = store.flatten(t)
    assert frow.dtype == torch.float32 and frow.shape == (store.p,)
    assert irow.dtype == torch.int32 and irow.shape == (store.pi,)
    rf, ri = ref.flatten(_jx(t_np))
    np.testing.assert_array_equal(frow.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(irow.numpy(), np.asarray(ri))
    _tree_equal(store.unflatten((frow, irow)), t)
    store.scatter_params([0, 2], t2)
    _tree_equal(store.gather_one(2), t2)
    _tree_equal(store.gather_one(3), t)
    stacked = store.gather([2, 3])
    _tree_equal(_row(stacked, 0), t2)
    _tree_equal(_row(stacked, 1), t)


def test_scatter_params_targets_only_given_rows():
    t0, t1 = _pt(_template_np(3)), _pt(_template_np(4))
    store = ClientStateStore(t0, 6)
    row = store.scatter_params([1, 4], t1)
    assert row.shape == (store.p,)
    for c, t in ((1, t1), (4, t1), (0, t0), (5, t0)):
        _tree_equal(store.gather_one(c), t)


def test_gather_duplicate_and_padded_ids():
    t0, t1 = _pt(_template_np(5)), _pt(_template_np(6))
    store = ClientStateStore(t0, 4)
    store.scatter_params([2], t1)
    stacked = store.gather([2, 2, 0, 2])       # duplicates = pad slots
    for i, t in enumerate((t1, t1, t0, t1)):
        _tree_equal(_row(stacked, i), t)


def test_scatter_flat_row_with_duplicate_ids():
    t0, t1 = _pt(_template_np(7)), _pt(_template_np(8))
    store = ClientStateStore(t0, 4)
    store.scatter([3, 3, 1], store.flatten(t1))
    for c, t in ((3, t1), (1, t1), (0, t0)):
        _tree_equal(store.gather_one(c), t)


def test_gathered_rows_are_copies_not_views_of_the_buffer():
    """The window scatters into the very rows it gathered: a view would
    silently change the cohort's start params."""
    t0, t1 = _pt(_template_np(9)), _pt(_template_np(10))
    store = ClientStateStore(t0, 4)
    stacked = store.gather([1, 2])
    one = store.gather_one(1)
    store.scatter_params([1, 2], t1)
    _tree_equal(_row(stacked, 0), t0)
    _tree_equal(_row(stacked, 1), t0)
    _tree_equal(one, t0)
    _tree_equal(store.gather_one(1), t1)


def test_byte_accounting_matches_reference():
    for t_np in (_template_np(11), _int_template_np(12)):
        store, ref = ClientStateStore(_pt(t_np), 6), RefStore(_jx(t_np), 6)
        assert store.wire_bytes_per_update == ref.wire_bytes_per_update
        assert store.bytes_by_tier() == ref.bytes_by_tier()
        for q in (32, 8):
            assert wire_bytes(_pt(t_np), q) == ref_wire_bytes(_jx(t_np), q)


# ---------------------------------------------------------------------------
# merge + scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("template", [_template_np, _int_template_np])
def test_merge_scatter_matches_folded_merge_bitwise(template, use_kernel):
    g_np = template(9)
    st_np = jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                   *[template(20 + i) for i in range(4)])
    alphas = [0.6, 0.3, 0.0, 0.45]             # one masked straggler
    coef = staleness_merge_coefficients(alphas)
    g = _pt(g_np)
    store = ClientStateStore(g, 8)
    new_params, new_g = store.merge_scatter([0, 2, 5, 7], _pt(st_np), coef,
                                            g, use_kernel=use_kernel)
    # the dict path's merge, bit for bit
    _tree_equal(new_params, staleness_weighted_merge(
        g, _pt(st_np), alphas, use_kernel=use_kernel))
    # merged clients' rows now hold the new global; others untouched
    for c in (0, 2, 5, 7):
        _tree_equal(store.gather_one(c), new_params)
    _tree_equal(store.gather_one(1), g)
    if store.pi:
        new_g = new_g[0]
        assert torch.equal(store.flatten(new_params)[0], new_g)
    else:
        assert torch.equal(store.flatten(new_params), new_g)
    # and the reference's store within tolerance
    ref = RefStore(_jx(g_np), 8)
    want, _ = ref.merge_scatter([0, 2, 5, 7], _jx(st_np), coef, _jx(g_np),
                                use_kernel=use_kernel, interpret=True)
    _close_to_reference(new_params, want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_merge_scatter_zero_coef_pad_rows_are_exact_noops(use_kernel):
    """Padded rows (repeat-last ids, coefficient 0) must not change the
    merge by a single bit — the engine's window convention."""
    g = _pt(_template_np(10))
    trees = [_pt(_template_np(30 + i)) for i in range(3)]
    coef = staleness_merge_coefficients([0.5, 0.25, 0.7])
    p1, r1 = ClientStateStore(g, 8).merge_scatter(
        [1, 2, 3], tree_stack(trees), coef, g, use_kernel=use_kernel)
    p2, r2 = ClientStateStore(g, 8).merge_scatter(
        [1, 2, 3, 3], tree_stack(trees + [trees[-1]]),
        np.concatenate([coef, np.zeros(1, np.float32)]), g,
        use_kernel=use_kernel)
    _tree_equal(p1, p2)
    assert torch.equal(r1, r2)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_merge_scatter_masks_nonfinite_zero_coef_rows(use_kernel):
    g = _pt(_template_np(11))
    bad = tree_map(lambda l: l * float("nan"), _pt(_template_np(12)))
    stacked = tree_stack([_pt(_template_np(13)), bad])
    coef = staleness_merge_coefficients([0.4, 0.0])   # nan row masked
    store = ClientStateStore(g, 4)
    new_params, _ = store.merge_scatter([0, 1], stacked, coef, g,
                                        use_kernel=use_kernel)
    for l in tree_leaves(new_params):
        assert torch.isfinite(l.float()).all()


def test_repeated_inplace_updates_keep_serving_gathers():
    """scatter/merge_scatter write into the store's own buffer: many
    cycles in a row keep every row right and the buffer's shape."""
    g = _pt(_template_np(14))
    store = ClientStateStore(g, 6)
    params = g
    for it in range(5):
        t = _pt(_template_np(40 + it))
        store.scatter_params([it % 6], t)
        stacked = tree_stack([t, _pt(_template_np(50 + it))])
        coef = staleness_merge_coefficients([0.5, 0.25])
        params, _ = store.merge_scatter([it % 6, (it + 1) % 6], stacked,
                                        coef, params)
        _tree_equal(store.gather_one(it % 6), params)
    assert store.buffer.shape == (6, store.p)


# ---------------------------------------------------------------------------
# the engine's window step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["batched", "looped"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_train_window_matches_cohort_plus_merge(use_kernel, engine):
    """The store window (padded to 4 rows, coefficient 0 on the pad)
    reproduces the dict path's train_cohort + merge_staleness bit for
    bit, with the cohort method or the looped fallback."""
    tr = SyntheticCohortTrainer(device="cpu")
    g = tr.init_params(0)
    starts = [tr.init_params(i + 1) for i in range(3)]
    ids, seeds = [4, 1, 6], [11, 22, 33]
    alphas = [0.5, 0.0, 0.3]
    store = ClientStateStore(g, 8)
    for c, t in zip(ids, starts):
        store.scatter_params([c], t)
    new_params, row = make_engine(
        tr, use_kernel_agg=use_kernel, engine=engine).train_window(
            store, g, ids, seeds, alphas)
    eng = make_engine(tr, use_kernel_agg=use_kernel, engine=engine)
    stacked, _ = eng.train_cohort(starts, ids, seeds)
    _tree_equal(new_params, eng.merge_staleness(g, stacked, alphas))
    for c in ids:
        _tree_equal(store.gather_one(c), new_params)
    assert torch.equal(row, store.flatten(new_params))


def test_engine_train_window_empty_cohort_returns_params():
    tr = SyntheticCohortTrainer(device="cpu")
    g = tr.init_params(0)
    store = ClientStateStore(g, 4)
    out, row = make_engine(tr).train_window(store, g, [], [], [])
    assert out is g and torch.equal(row, store.flatten(g))


def test_train_cohort_matches_per_client_training():
    tr = SyntheticCohortTrainer.many_leaf(n_leaves=5, leaf=16,
                                          device="cpu")
    eng = make_engine(tr)
    starts = [tr.init_params(i) for i in range(3)]
    stacked, sizes = eng.train_cohort(starts, [0, 3, 5], [11, 22, 33])
    for i, (c, s) in enumerate(zip([0, 3, 5], [11, 22, 33])):
        solo, n = tr.local_train(starts[i], c, s)
        _tree_equal(_row(stacked, i), solo)
        assert sizes[i] == n
    assert eng.train_cohort([], [], [])[0] is None
