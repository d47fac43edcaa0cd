"""The async runtime's host logic and merge arithmetic in the port,
against the JAX package.

Events and the aggregation buffer are copies of framework-free code and
must agree exactly.  The staleness coefficients are numpy on both sides
and must agree bit for bit.  The folded merge (``_merge_folded``,
``fedagg_fold_plain``) is held against the reference's Pallas kernel in
interpret mode and its jnp oracle at rtol=atol=1e-6 (f32 row sums in
another order), and against itself bitwise across zero-coefficient
padding."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.kernels.fedagg import fedagg_fold as ref_fedagg_fold
from repro.kernels.ref import fedagg_fold_ref
from repro.runtime import AggregationBuffer as RefBuffer
from repro.runtime import ClientEvent as RefEvent
from repro.runtime import EventQueue as RefQueue
from repro_torch import bridge
from repro_torch.core import aggregation as pt_agg
from repro_torch.kernels import fedagg as fedagg_mod
from repro_torch.kernels import fedagg_fold_op, fedagg_fold_pytree
from repro_torch.kernels.fedagg import fedagg_fold_plain
from repro_torch.runtime import AggregationBuffer, ClientEvent, EventQueue
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

FOLD_RTOL, FOLD_ATOL = 1e-6, 1e-6


def _ev(e):
    return (e.finish, e.client, e.version, e.rnd, e.cost)


def _queues(times):
    """The same completions in a port queue and a reference queue."""
    return (EventQueue([ClientEvent(t, c) for c, t in enumerate(times)]),
            RefQueue([RefEvent(t, c) for c, t in enumerate(times)]))


# ---------------------------------------------------------------------------
# event queue
# ---------------------------------------------------------------------------

def test_event_queue_orders_by_finish_time():
    q, rq = EventQueue(), RefQueue()
    for t, c in [(5.0, 1), (2.0, 4), (9.0, 0), (3.5, 2)]:
        q.push(ClientEvent(t, c))
        rq.push(RefEvent(t, c))
    got = [q.pop().client for _ in range(4)]
    assert got == [4, 2, 1, 0] == [rq.pop().client for _ in range(4)]


@pytest.mark.parametrize("order", [[3, 1, 2, 0], [0, 1, 2, 3],
                                   [2, 0, 3, 1]])
def test_event_queue_ties_break_on_client_id_not_insertion_order(order):
    q = EventQueue()
    for c in order:
        q.push(ClientEvent(7.0, c, version=c, rnd=c))
    assert [q.pop().client for _ in range(4)] == [0, 1, 2, 3]


def test_event_queue_payload_does_not_affect_order():
    q = EventQueue([ClientEvent(1.0, 5, version=9, rnd=9, cost=99.0),
                    ClientEvent(1.0, 3, version=0, rnd=0, cost=0.0)])
    assert q.peek().client == 3
    assert len(q) == 2 and bool(q)
    assert not EventQueue()


def test_peek_n_matches_pop_order_and_never_perturbs():
    times = [5.0, 2.0, 9.0, 2.0, 7.0, 2.0]     # triple tie at 2.0
    q, rq = _queues(times)
    snap = sorted((e.finish, e.client) for e in q._heap)
    for k in (0, -3, 1, 3, len(times), len(times) + 5):
        got = q.peek_n(k)
        assert [_ev(e) for e in got] == [_ev(e) for e in rq.peek_n(k)]
        assert len(got) == max(0, min(k, len(times)))
        assert sorted((e.finish, e.client) for e in q._heap) == snap
    want = [q.pop() for _ in range(4)]
    q2, _ = _queues(times)
    assert q2.peek_n(4) == want
    assert [e.client for e in q2.peek_n(4)][:3] == [1, 3, 5]


# ---------------------------------------------------------------------------
# aggregation buffer: every drain held against the reference's
# ---------------------------------------------------------------------------

def _drains(times, window=0, window_secs=0.0, limit=None):
    """All drains of a queue, with close times, in both packages."""
    q, rq = _queues(times)
    buf, rbuf = AggregationBuffer(window, window_secs), RefBuffer(
        window, window_secs)
    got, want = [], []
    while q:
        b, rb = buf.drain(q, limit=limit), rbuf.drain(rq, limit=limit)
        got.append(([e.client for e in b], buf.close_time(b, limit=limit)))
        want.append(([e.client for e in rb],
                     rbuf.close_time(rb, limit=limit)))
    assert got == want and not rq
    return got


def test_buffer_window0_is_one_at_a_time():
    drains = _drains([1.0, 2.0, 3.0])
    assert [d for d, _ in drains] == [[0], [1], [2]]
    assert [t for _, t in drains] == [1.0, 2.0, 3.0]


def test_buffer_count_window_waits_for_k():
    drains = _drains([1.0, 2.0, 30.0, 40.0], window=3)
    assert [d for d, _ in drains] == [[0, 1, 2], [3]]


def test_buffer_time_window_anchors_on_earliest():
    drains = _drains([1.0, 5.0, 6.9, 20.0], window_secs=6.0)
    assert [d for d, _ in drains] == [[0, 1, 2], [3]]


def test_buffer_limit_caps_the_drain():
    q, _ = _queues([1.0, 1.1, 1.2, 1.3])
    buf = AggregationBuffer(window_secs=10.0)
    assert len(buf.drain(q, limit=2)) == 2
    assert len(buf.drain(q, limit=10)) == 2
    _drains([1.0, 1.1, 1.2, 1.3, 9.0], window_secs=10.0, limit=2)


def test_buffer_drain_until_external_deadline():
    q, rq = _queues([1.0, 2.0, 3.0, 9.0])
    got = AggregationBuffer.drain_until(q, deadline=3.0)
    assert [e.client for e in got] == [0, 1, 2] == [
        e.client for e in RefBuffer.drain_until(rq, deadline=3.0)]
    assert AggregationBuffer.drain_until(q, deadline=3.0) == []
    assert len(q) == 1


def test_buffer_rejects_negative_windows():
    with pytest.raises(ValueError):
        AggregationBuffer(window=-1)
    with pytest.raises(ValueError):
        AggregationBuffer(window_secs=-0.5)


def test_buffer_close_time_semantics():
    # time-closed window: the server waits out the full deadline
    assert _drains([1.0, 3.0, 20.0], window_secs=6.0)[0] == ([0, 1], 7.0)
    # count-closed window (K-th arrival lands): closes at last arrival
    assert _drains([1.0, 3.0, 4.0, 20.0], window=3,
                   window_secs=50.0)[0] == ([0, 1, 2], 4.0)
    # sequential (window=0): closes at the event itself
    assert _drains([2.5]) == [([0], 2.5)]


@pytest.mark.parametrize("window,window_secs,limit", [
    (0, 0.0, None), (3, 0.0, None), (0, 6.0, None), (2, 6.0, None),
    (3, 0.0, 2), (0, 50.0, 2)])
def test_peek_window_equals_the_coming_drain(window, window_secs, limit):
    times = [1.0, 5.0, 6.9, 1.0, 20.0, 6.9]
    buf = AggregationBuffer(window, window_secs)
    q, rq = _queues(times)
    peeked = buf.peek_window(q, limit=limit)
    assert len(q) == len(times)                 # peeking popped nothing
    assert [_ev(e) for e in peeked] == [
        _ev(e) for e in RefBuffer(window, window_secs).peek_window(
            rq, limit=limit)]
    assert peeked == buf.drain(q, limit=limit)
    _drains(times, window, window_secs, limit)


def test_peek_window_and_drain_empty_queue():
    buf = AggregationBuffer(window=3)
    q = EventQueue()
    assert buf.peek_window(q) == []
    assert buf.drain(q) == []


def test_drain_tied_finish_times_pop_in_client_order():
    drains = _drains([4.0, 4.0, 4.0, 4.0], window=4)
    assert drains == [([0, 1, 2, 3], 4.0)]


def test_drain_until_exact_window_boundary_is_inclusive():
    # finish == deadline drains; the next event (one ulp later) stays
    q, _ = _queues([1.0, 3.0, np.nextafter(3.0, 4.0), 5.0])
    got = AggregationBuffer.drain_until(q, deadline=3.0)
    assert [e.client for e in got] == [0, 1]
    assert len(q) == 2
    assert AggregationBuffer.drain_until(q, deadline=0.5) == []
    assert len(q) == 2


def test_time_window_exact_boundary_is_inclusive():
    # anchor 1.0 + window 6.0: an event AT 7.0 joins the window
    drains = _drains([1.0, 7.0, np.nextafter(7.0, 8.0)], window_secs=6.0)
    assert drains[0][0] == [0, 1]
    q, _ = _queues([1.0, 7.0, 8.0])
    assert AggregationBuffer(window_secs=6.0).peek_window(q) == \
        AggregationBuffer(window_secs=6.0).drain(_queues([1.0, 7.0,
                                                          8.0])[0])


@pytest.mark.parametrize("deadline", [0.0, 2.0, 3.0, 100.0])
@pytest.mark.parametrize("limit", [None, 2])
def test_peek_until_matches_drain_until_without_popping(deadline, limit):
    times = [1.0, 2.0, 3.0, 9.0]
    q, rq = _queues(times)
    peeked = AggregationBuffer.peek_until(q, deadline, limit=limit)
    assert len(q) == len(times)
    assert [_ev(e) for e in peeked] == [
        _ev(e) for e in RefBuffer.peek_until(rq, deadline, limit=limit)]
    assert peeked == AggregationBuffer.drain_until(q, deadline, limit=limit)
    assert AggregationBuffer.peek_until(EventQueue(), 5.0) == []


# ---------------------------------------------------------------------------
# staleness coefficients and the folded merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alphas", [
    [0.6], [0.5, 0.25, 0.1], [1.0, 0.5], [0.0, 0.0], [],
    list(np.random.default_rng(0).uniform(0, 1, 17)),
    list(np.random.default_rng(1).uniform(0, 1, 32))])
def test_staleness_merge_coefficients_bit_exact(alphas):
    got = pt_agg.staleness_merge_coefficients(alphas)
    want = ref_agg.staleness_merge_coefficients(alphas)
    assert got.dtype == np.float32 and got.shape == (len(alphas) + 1,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _fold_case(name):
    rng = np.random.default_rng(len(name) + 7)
    k, p = {"odd-p": (5, 1237), "k1": (1, 33), "wide": (9, 4096)}.get(
        name, (6, 515))
    u = rng.normal(size=(k, p)).astype(np.float32)
    g = rng.normal(size=(p,)).astype(np.float32)
    coef = ref_agg.staleness_merge_coefficients(rng.uniform(0.1, 0.9, k))
    if name == "masked-inf-nan":
        u[1], u[4] = np.inf, np.nan
        coef[2], coef[5] = 0.0, 0.0
    if name == "c0-zero-inf-global":
        coef[0] = 0.0
        g[::5] = np.inf
    if name == "nan-and-negative-coef":
        coef[3], coef[4] = np.nan, -0.5
        u[3] = np.inf
    if name == "all-zero":
        coef[:] = 0.0
    return u, g, coef


FOLD_CASES = ["odd-p", "k1", "wide", "masked-inf-nan", "c0-zero-inf-global",
              "nan-and-negative-coef", "all-zero"]


@pytest.mark.parametrize("name", FOLD_CASES)
def test_fedagg_fold_plain_matches_reference_kernel_and_oracle(name):
    u, g, coef = _fold_case(name)
    ju, jg, jc = jnp.asarray(u), jnp.asarray(g), jnp.asarray(coef)
    kernel = np.asarray(ref_fedagg_fold(ju, jg, jc, block_p=128,
                                        interpret=True))
    oracle = np.asarray(fedagg_fold_ref(ju, jg, jc))
    before = fedagg_mod.fold_launches
    got = fedagg_fold_op(torch.from_numpy(u), torch.from_numpy(g), coef)
    assert fedagg_mod.fold_launches == before   # CPU tensor: no launch
    assert got.dtype == torch.float32 and got.shape == (u.shape[1],)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), kernel, rtol=FOLD_RTOL,
                               atol=FOLD_ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=FOLD_RTOL,
                               atol=FOLD_ATOL)
    # a tensor coefficient vector is the same call
    again = fedagg_fold_plain(torch.from_numpy(u), torch.from_numpy(g),
                              torch.from_numpy(coef))
    assert torch.equal(again, got)
    if name == "all-zero":
        assert not got.numpy().any()


@pytest.mark.parametrize("k", [3, 5, 7])
def test_padded_window_equals_unpadded_bitwise(k):
    """The engine pads a window of k rows to the next power of two with
    copies of the last row and coefficient 0: neither the plain kernel
    version nor the per-leaf merge may change a single bit for it."""
    rng = np.random.default_rng(100 + k)
    target = 1 << (k - 1).bit_length()
    for p in (331, 100_003):
        u = rng.normal(size=(k, p)).astype(np.float32)
        g = rng.normal(size=(p,)).astype(np.float32)
        coef = pt_agg.staleness_merge_coefficients(rng.uniform(0, 1, k))
        u_pad = np.concatenate([u, np.repeat(u[-1:], target - k, 0)])
        c_pad = np.concatenate([coef, np.zeros(target - k, np.float32)])
        base = fedagg_fold_plain(torch.from_numpy(u), torch.from_numpy(g),
                                 coef)
        padded = fedagg_fold_plain(torch.from_numpy(u_pad),
                                   torch.from_numpy(g), c_pad)
        assert torch.equal(base, padded)
        tree = {"a": torch.from_numpy(u[:, :p // 2].copy()),
                "b": torch.from_numpy(u[:, p // 2:].copy())}
        tree_pad = tree_map(lambda l: torch.cat(
            [l, l[-1:].expand(target - k, -1)]), tree)
        gt = {"a": torch.from_numpy(g[:p // 2].copy()),
              "b": torch.from_numpy(g[p // 2:].copy())}
        m = pt_agg._merge_folded(gt, tree, coef)
        m_pad = pt_agg._merge_folded(gt, tree_pad, c_pad)
        for x, y in zip(tree_leaves(m), tree_leaves(m_pad)):
            assert torch.equal(x, y)
        np.testing.assert_array_equal(
            torch.cat([m["a"], m["b"]]).numpy(), base.numpy())


def test_fold_coefficient_sum_ignores_trailing_zeros():
    """The case a row-axis ``torch.sum`` gets wrong: the normalising sum
    over K+1 coefficients and over the same vector padded with zeros
    to the pow2 bucket must agree in every bit."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        k = int(rng.integers(2, 33))
        target = 1 << k.bit_length()
        c = rng.uniform(0, 1, k + 1).astype(np.float32)
        padded = np.concatenate([c, np.zeros(target - k - 1, np.float32)])
        a = fedagg_mod.fold_coefficients(c, "cpu")
        b = fedagg_mod.fold_coefficients(padded, "cpu")
        assert torch.equal(a, b[:k + 1])


def _rand_tree(rng, n):
    return {"w": rng.normal(size=(n, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 5)).astype(np.float32).astype(
                ml_dtypes.bfloat16)}


def _row(tree, i):
    return tree_map(lambda l: l[i], tree)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("alphas", [
    [0.6], [0.5, 0.25], [0.9, 0.0, 0.3], [0.2, 1.0, 0.4], [0.0, 0.0]])
def test_staleness_weighted_merge_matches_sequential_fold(alphas,
                                                          use_kernel):
    rng = np.random.default_rng(len(alphas))
    n = len(alphas)
    g_np = jax.tree_util.tree_map(lambda l: l[0], _rand_tree(rng, 1))
    st_np = _rand_tree(rng, n)
    g = bridge.from_reference(g_np, "cpu")
    stacked = bridge.from_reference(st_np, "cpu")
    want = g
    for i, a in enumerate(alphas):
        want = pt_agg.staleness_merge(want, _row(stacked, i), a)
    got = pt_agg.staleness_weighted_merge(g, stacked, alphas,
                                          use_kernel=use_kernel)
    ref = ref_agg.staleness_weighted_merge(
        jax.tree_util.tree_map(jnp.asarray, g_np),
        jax.tree_util.tree_map(jnp.asarray, st_np), alphas,
        use_kernel=use_kernel, interpret=True)
    for k in g:
        tol = 2e-2 if g[k].dtype == torch.bfloat16 else 1e-5
        assert got[k].dtype == g[k].dtype
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(ref[k], np.float32),
                                   rtol=tol, atol=tol)


def test_staleness_merge_matches_reference():
    rng = np.random.default_rng(3)
    g_np = jax.tree_util.tree_map(lambda l: l[0], _rand_tree(rng, 1))
    c_np = jax.tree_util.tree_map(lambda l: l[0], _rand_tree(rng, 1))
    got = pt_agg.staleness_merge(bridge.from_reference(g_np, "cpu"),
                                 bridge.from_reference(c_np, "cpu"), 0.37)
    want = ref_agg.staleness_merge(
        jax.tree_util.tree_map(jnp.asarray, g_np),
        jax.tree_util.tree_map(jnp.asarray, c_np), 0.37)
    for k in got:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=1e-6, atol=1e-6)


def test_fedagg_fold_pytree_matches_reference_and_casts_to_global():
    rng = np.random.default_rng(11)
    g_np = jax.tree_util.tree_map(lambda l: l[0], _rand_tree(rng, 1))
    st_np = _rand_tree(rng, 4)
    st_np["w"][2] = np.nan                   # masked by coefficient 0
    coef = ref_agg.staleness_merge_coefficients([0.5, 0.2, 0.0, 0.7])
    from repro.kernels import fedagg_fold_pytree as ref_pytree
    want = ref_pytree(jax.tree_util.tree_map(jnp.asarray, g_np),
                      jax.tree_util.tree_map(jnp.asarray, st_np),
                      jnp.asarray(coef), interpret=True)
    got = fedagg_fold_pytree(bridge.from_reference(g_np, "cpu"),
                             bridge.from_reference(st_np, "cpu"), coef)
    for k in got:
        assert got[k].dtype == bridge.from_reference(g_np, "cpu")[k].dtype
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_fold_wrapper_rejects_wrong_shapes():
    u, g = torch.zeros(3, 5), torch.zeros(5)
    with pytest.raises(ValueError):
        fedagg_fold_op(u, g, np.ones(3, np.float32))
    with pytest.raises(ValueError):
        fedagg_fold_op(u, torch.zeros(4), np.ones(4, np.float32))
    with pytest.raises(ValueError):
        fedagg_fold_op(u[0], g, np.ones(2, np.float32))
