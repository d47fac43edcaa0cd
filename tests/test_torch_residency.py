"""The port's tiered client-state residency (``TieredClientStateStore``,
``HostColdTier``, ``DiskColdTier``) on the CPU.

``tests/test_residency.py`` restated for the port: seeded interleavings
of ``gather`` / ``scatter`` / ``merge_scatter`` / ``prefetch`` over
capacities {N, N/2, 1} × float and int-sidecar templates × kernel and
plain merges × f32 and int8 rows must stay BIT-identical to a dense
store replaying the same ops (residency is data movement, never
arithmetic); LRU eviction and write-behind accounting, prefetch
pinning, the disk tier's spill and persistence, the constructor's
contract, and runner histories at capacity < N equal to the dense
store's and the dict path's.  On top: the quantized case of
``tests/test_state.py`` (dense == tiered-host == tiered-disk), the
tiered cases of ``tests/test_obs.py``, the error-feedback residuals
held by the hot side (at most ``capacity``), and the port against the
reference — the same tiered runs in both packages give the same
histories (accuracy within atol=1e-6, as ``tests/test_torch_async.py``
holds it) and the same residency counters."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config.base import FLConfig as RefFLConfig
from repro.core import run_method as ref_run_method
from repro.fl.network import WirelessNetwork as RefNetwork
from repro.fl.testing import SyntheticCohortTrainer as RefSynthetic
from repro.obs import telemetry as ref_tel
from repro_torch import obs
from repro_torch.config.base import FLConfig
from repro_torch.core import run_method
from repro_torch.core.aggregation import staleness_merge_coefficients
from repro_torch.core.baselines import run_fedasync, run_fedbuff
from repro_torch.core.residency import (DiskColdTier, HostColdTier,
                                        TieredClientStateStore)
from repro_torch.core.state import ClientStateStore
from repro_torch.fl.network import WirelessNetwork
from repro_torch.fl.testing import SyntheticCohortTrainer
from repro_torch.obs import telemetry as obs_tel
from repro_torch.obs.validate import validate_file
from repro_torch.runtime.async_loop import run_feddct_async
from repro_torch.tree import tree_stack

from test_torch_store import _int_template_np, _pt, _template_np, _tree_equal

torch.set_num_threads(1)

N = 6
_FLOATS = (np.dtype(np.float32), np.dtype(np.float16),
           np.dtype(ml_dtypes.bfloat16))


def _template(seed=0):
    return _pt(_template_np(seed))


def _rand_tree(template_np, seed):
    """A random tree with ``template_np``'s structure and dtypes (int
    leaves fresh in-range values, floats fresh normals), as the port's
    tensors."""
    rng = np.random.default_rng(seed)

    def leaf(l):
        l = np.asarray(l)
        if l.dtype in _FLOATS:
            return rng.normal(size=l.shape).astype(np.float32).astype(
                l.dtype)
        if l.dtype == np.bool_:
            return rng.integers(0, 2, size=l.shape).astype(bool)
        info = np.iinfo(l.dtype)
        return rng.integers(info.min, int(info.max) + 1, size=l.shape,
                            dtype=np.int64).astype(l.dtype)

    return _pt({k: leaf(v) for k, v in template_np.items()})


def _net(fl):
    return WirelessNetwork(fl.n_clients, fl.tier_delay_means, fl.delay_std,
                           fl.mu, fl.failure_delay, fl.seed)


def _ref_net(fl):
    return RefNetwork(fl.n_clients, fl.tier_delay_means, fl.delay_std,
                      fl.mu, fl.failure_delay, fl.seed)


def _trainer():
    return SyntheticCohortTrainer(device="cpu")


def _hist_equal(ha, hb):
    assert ha.rounds == hb.rounds
    assert ha.times == hb.times
    assert ha.accuracy == hb.accuracy
    assert ha.n_selected == hb.n_selected
    assert ha.n_stragglers == hb.n_stragglers


class _FakeLoopTrainer:
    """Deterministic linear updates, looped path only (exercises the
    store's gather_one + stacked merge)."""

    class cfg:
        arch_id = "fake"

    device = torch.device("cpu")

    def init_params(self, seed=0):
        return {"w": torch.zeros(3)}

    def local_train(self, params, client_id, rnd_seed):
        return {"w": params["w"] + (client_id + 1.0)}, 10.0 + client_id

    def evaluate(self, params):
        return float(np.clip(float(params["w"].mean()) / 100.0, 0.0, 1.0))


class _IntLeafTrainer(_FakeLoopTrainer):
    """Params carry a non-float leaf (a step counter) in the int32
    sidecar."""

    def init_params(self, seed=0):
        return {"w": torch.zeros(3),
                "step": torch.zeros((), dtype=torch.int32)}

    def local_train(self, params, client_id, rnd_seed):
        return {"w": params["w"] + (client_id + 1.0),
                "step": params["step"] + 1}, 10.0 + client_id


# ---------------------------------------------------------------------------
# the tentpole gate: randomized op interleavings, bitwise vs dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant_bits", [32, 8], ids=["q32", "q8"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain-merge", "kernel-merge"])
@pytest.mark.parametrize("template_np", [_template_np, _int_template_np],
                         ids=["float-tree", "int-sidecar-tree"])
@pytest.mark.parametrize("capacity", [N, N // 2, 1])
def test_random_interleaving_bit_identical_to_dense(capacity, template_np,
                                                    use_kernel, quant_bits):
    tpl_np = template_np(0)
    tpl = _pt(tpl_np)
    dense = ClientStateStore(tpl, N, quant_bits=quant_bits)
    tiered = TieredClientStateStore(tpl, N, capacity=capacity,
                                    quant_bits=quant_bits)
    assert tiered.rows == capacity
    assert dense.p == tiered.p and dense.pi == tiered.pi
    rng = np.random.default_rng(100 + capacity)

    for step in range(40):
        op = rng.integers(0, 5)
        if op == 0:
            # gather with duplicates (the engine's pow2 pad convention)
            ids = rng.integers(0, N, size=rng.integers(1, 7)).tolist()
            _tree_equal(dense.gather(ids), tiered.gather(ids))
        elif op == 1:
            ids = rng.choice(N, size=rng.integers(1, 4),
                             replace=False).tolist()
            t = _rand_tree(tpl_np, int(rng.integers(1 << 20)))
            ra = dense.scatter_params(ids, t)
            rb = tiered.scatter_params(ids, t)
            _tree_equal(ra, rb)
        elif op == 2:
            ids = rng.choice(N, size=rng.integers(1, 3),
                             replace=False).tolist()
            flat = dense.flatten(_rand_tree(tpl_np,
                                            int(rng.integers(1 << 20))))
            dense.scatter(ids, flat)
            tiered.scatter(ids, flat)
        elif op == 3:
            k = int(rng.integers(1, 6))
            ids = rng.choice(N, size=k, replace=False).tolist()
            stacked = dense.gather(ids)        # equal stores -> equal rows
            coef = staleness_merge_coefficients(
                rng.random(k).astype(np.float32))
            g = _rand_tree(tpl_np, int(rng.integers(1 << 20)))
            na, _ = dense.merge_scatter(ids, stacked, coef, g,
                                        use_kernel=use_kernel)
            nb, _ = tiered.merge_scatter(ids, tiered.gather(ids), coef, g,
                                         use_kernel=use_kernel)
            _tree_equal(na, nb)
        else:
            # a lookahead hint, right or wrong, with a pinned cohort
            tiered.prefetch(rng.integers(0, N, size=3).tolist(),
                            keep=rng.integers(0, N, size=1).tolist())
        c = int(rng.integers(0, N))
        _tree_equal(dense.gather_one(c), tiered.gather_one(c))

    # final full-population sweep: every row identical in both layouts
    _tree_equal(dense.gather(list(range(N))),
                tiered.gather(list(range(N))))
    bd, bt = dense.bytes_by_tier(), tiered.bytes_by_tier()
    assert bd["ef"] == bt["ef"]
    assert bt["hot"] * N == bd["hot"] * capacity
    if capacity < N:
        assert tiered.n_promoted > 0           # residency actually moved


def test_padded_zero_coef_merge_is_exact_across_tiers():
    """The engine's repeat-last padded merge (coef 0 rows) over a
    capacity-1 store: pads and spills together must still be no-ops."""
    g = _template(10)
    trees = [_template(30 + i) for i in range(3)]
    coef = staleness_merge_coefficients([0.5, 0.25, 0.7])
    s1 = ClientStateStore(g, N)
    p1, _ = s1.merge_scatter([1, 2, 3], tree_stack(trees), coef, g)
    s2 = TieredClientStateStore(g, N, capacity=1)
    padded = tree_stack(trees + [trees[-1]])
    coef_pad = np.concatenate([coef, np.zeros(1, np.float32)])
    p2, _ = s2.merge_scatter([1, 2, 3, 3], padded, coef_pad, g)
    _tree_equal(p1, p2)
    for c in (1, 2, 3):
        _tree_equal(s2.gather_one(c), p1)
    _tree_equal(s2.gather_one(0), g)


# ---------------------------------------------------------------------------
# residency mechanics: LRU, write-behind, prefetch pinning
# ---------------------------------------------------------------------------

def test_lru_eviction_and_write_behind_only_dirty_rows():
    tpl = _template(0)
    store = TieredClientStateStore(tpl, N, capacity=2)
    store.gather([0, 1])                       # promote 0, 1 (clean)
    assert store.hot_clients == (0, 1)
    store.gather_one(0)                        # LRU touch: 1 is now oldest
    assert store.hot_clients == (1, 0)
    store.gather_one(2)                        # evicts 1 — clean, no write
    assert store.hot_clients == (0, 2)
    assert len(store.cold) == 0                # write-behind skipped
    t = _template(99)
    store.scatter_params([2], t)               # dirties 2 while hot
    store.gather([3, 4])                       # evicts 0 (clean), 2 (dirty)
    assert len(store.cold) == 1                # only the dirty row demoted
    assert store.n_demoted == 1
    _tree_equal(store.gather_one(2), t)        # …and reads back exactly


def test_prefetch_is_partial_and_respects_pins():
    tpl = _template(1)
    store = TieredClientStateStore(tpl, N, capacity=2)
    promoted = store.prefetch([3, 4, 5])       # truncated to capacity
    assert promoted == [3, 4]
    assert store.hot_clients == (3, 4)
    # every slot pinned: prefetch must stop quietly, not evict or raise
    assert store.prefetch([0, 1], keep=[3, 4]) == []
    assert store.hot_clients == (3, 4)
    # unpinned: prefetch evicts LRU as usual
    assert store.prefetch([0], keep=[4]) == [0]
    assert 0 in store.hot_clients and 3 not in store.hot_clients


def test_prefetch_is_only_a_hint_values_never_change():
    """A deliberately WRONG prefetch (staging clients the next window
    will not touch) must not change any value the store serves."""
    tpl_np = _int_template_np(2)
    dense = ClientStateStore(_pt(tpl_np), N)
    tiered = TieredClientStateStore(_pt(tpl_np), N, capacity=2)
    t = _rand_tree(tpl_np, 7)
    dense.scatter_params([0, 5], t)
    tiered.scatter_params([0, 5], t)
    tiered.prefetch([3, 4])                    # stale lookahead
    _tree_equal(dense.gather([0, 5, 3]), tiered.gather([0, 5, 3]))


def test_ensure_window_batches_promotion_for_looped_gathers():
    tpl = _template(3)
    store = TieredClientStateStore(tpl, N, capacity=3)
    store.ensure_window([2, 4, 2, 5])          # duplicates collapse
    assert set(store.hot_clients) == {2, 4, 5}
    promoted_before = store.n_promoted
    for c in (2, 4, 5):
        store.gather_one(c)                    # all hot: no further moves
    assert store.n_promoted == promoted_before
    store.ensure_window(list(range(N)))        # wider than hot: a no-op
    assert set(store.hot_clients) == {2, 4, 5}


# ---------------------------------------------------------------------------
# cold tiers
# ---------------------------------------------------------------------------

def test_host_cold_tier_defaults_and_broadcast():
    f0 = torch.arange(4, dtype=torch.float32)
    i0 = torch.tensor([7], dtype=torch.int32)
    cold = HostColdTier(f0, i0)
    f, i = cold.read([0, 3])                   # untouched -> template row
    assert torch.equal(f, torch.stack([f0, f0]))
    assert torch.equal(i, torch.stack([i0, i0]))
    cold.write([1, 2], f0 * 2, i0 * 2)         # 1-D broadcast form
    f, i = cold.read([1, 2, 0])
    assert torch.equal(f[0], f0 * 2)
    assert torch.equal(f[1], f0 * 2)
    assert torch.equal(f[2], f0)
    assert len(cold) == 2
    assert cold.nbytes == 2 * (4 * 4 + 4)
    # a 2-D block is per client; dtypes are the templates', kept
    cold.write([0, 3], torch.stack([f0 + 1, f0 + 3]), i0)
    f, i = cold.read([3, 0])
    assert f.dtype == torch.float32 and i.dtype == torch.int32
    assert torch.equal(f, torch.stack([f0 + 3, f0 + 1]))


def test_disk_cold_tier_spills_and_persists(tmp_path):
    rng = np.random.default_rng(11)
    f0 = np.zeros(5, np.float32)
    i0 = np.zeros(2, np.int32)
    rows = {c: (rng.normal(size=5).astype(np.float32),
                rng.integers(0, 99, size=2).astype(np.int32))
            for c in range(7)}
    cold = DiskColdTier(str(tmp_path), 7, f0, i0, chunk=2, cache_chunks=2)
    for c, (f, i) in rows.items():             # > cache: chunks spill
        cold.write([c], torch.from_numpy(f), torch.from_numpy(i))
    cold.flush()
    assert len(list(tmp_path.glob("ckpt_*.npz"))) == 4  # ceil(7/2) chunks
    # a fresh tier over the same directory reads every row back exactly
    cold2 = DiskColdTier(str(tmp_path), 7, f0, i0, chunk=2)
    f, i = cold2.read(list(range(7)))
    for c in range(7):
        np.testing.assert_array_equal(f[c].numpy(), rows[c][0])
        np.testing.assert_array_equal(i[c].numpy(), rows[c][1])


def test_disk_tier_store_bit_identical_to_dense(tmp_path):
    tpl_np = _int_template_np(4)
    dense = ClientStateStore(_pt(tpl_np), N)
    tiered = TieredClientStateStore(_pt(tpl_np), N, capacity=2,
                                    cold="disk", cold_dir=str(tmp_path),
                                    chunk=2)
    assert tiered.residency == "tiered-disk"
    rng = np.random.default_rng(5)
    for step in range(12):
        ids = rng.choice(N, size=rng.integers(1, 4), replace=False).tolist()
        t = _rand_tree(tpl_np, step)
        dense.scatter_params(ids, t)
        tiered.scatter_params(ids, t)
        c = int(rng.integers(0, N))
        _tree_equal(dense.gather_one(c), tiered.gather_one(c))
    _tree_equal(dense.gather(list(range(N))),
                tiered.gather(list(range(N))))


def test_disk_tier_survives_flush_and_reload(tmp_path):
    """A tiered disk store's spill, flushed, reloads in a fresh tier:
    every row the store would serve, read back from disk alone (hot
    rows written behind first)."""
    tpl_np = _template_np(6)
    tiered = TieredClientStateStore(_pt(tpl_np), N, capacity=2,
                                    cold="disk", cold_dir=str(tmp_path),
                                    chunk=4, quant_bits=8)
    for step in range(6):
        tiered.scatter_params([step % N, (step + 3) % N],
                              _rand_tree(tpl_np, step))
        tiered.gather([step % N])
    want = tiered._read_rows(list(range(tiered.rows)))
    hot = list(tiered.hot_clients)
    tiered.cold.write(hot, *tiered._read_rows(tiered._slots_of(hot)))
    tiered.cold.flush()
    fresh = DiskColdTier(str(tmp_path), N, *[b[0] for b in tiered.bufs],
                         chunk=4)
    got = fresh.read(list(range(N)))
    for j in range(len(tiered.bufs)):
        for c, s in zip(hot, tiered._slots_of(hot)):
            assert torch.equal(got[j][c], want[j][s])
    dense_view = tiered.gather(list(range(N)))
    rows = tiered._rows_to_tree(got, N)
    _tree_equal(rows, dense_view)


# ---------------------------------------------------------------------------
# constructor contract
# ---------------------------------------------------------------------------

def test_tiered_store_rejects_bad_configs(tmp_path):
    tpl = _template(0)
    with pytest.raises(ValueError):
        TieredClientStateStore(tpl, N, capacity=0)
    with pytest.raises(ValueError):
        TieredClientStateStore(tpl, N, capacity=2, cold="disk")  # no dir
    with pytest.raises(ValueError):
        TieredClientStateStore(tpl, N, capacity=2, cold="tape")
    with pytest.raises(ValueError):
        # tiered residency manages ONE device; sharding is the dense
        # store's mesh= job
        TieredClientStateStore(tpl, N, capacity=2,
                               mesh=SimpleNamespace(size=2))
    # capacity above N clamps to N (degenerate dense layout, still tiered)
    s = TieredClientStateStore(tpl, 3, capacity=64)
    assert s.capacity == 3 and s.rows == 3


# ---------------------------------------------------------------------------
# error-feedback residuals move with their rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cold", ["host", "disk"])
def test_residuals_follow_their_rows_and_stay_within_capacity(tmp_path,
                                                               cold):
    """The hot side keeps the residuals of hot clients only (at most
    ``capacity``), the cold side the rest; none is lost or doubled, so
    ``bytes_by_tier()["ef"]`` equals the dense store's after every op,
    and every residual equals the dense store's bit for bit."""
    tpl_np = _template_np(8)
    cap = 2
    dense = ClientStateStore(_pt(tpl_np), N, quant_bits=8)
    tiered = TieredClientStateStore(_pt(tpl_np), N, capacity=cap,
                                    quant_bits=8, cold=cold,
                                    cold_dir=str(tmp_path), chunk=2)
    rng = np.random.default_rng(3)
    for step in range(30):
        ids = rng.choice(N, size=rng.integers(1, 5), replace=False).tolist()
        t = _rand_tree(tpl_np, step)
        dense.scatter_params(ids, t)
        tiered.scatter_params(ids, t)
        if step % 3 == 0:
            tiered.prefetch(rng.integers(0, N, size=2).tolist())
        else:
            c = int(rng.integers(0, N))
            _tree_equal(dense.gather_one(c), tiered.gather_one(c))
        assert len(tiered._ef) <= cap
        assert set(tiered._ef) <= set(tiered.hot_clients)
        assert not set(tiered._ef) & set(tiered._ef_cold)
        assert (len(tiered._ef) + len(tiered._ef_cold) == len(dense._ef))
        assert tiered.bytes_by_tier()["ef"] == dense.bytes_by_tier()["ef"]
        for c in dense._ef:
            assert torch.equal(tiered.ef_residual(c), dense.ef_residual(c))


# ---------------------------------------------------------------------------
# runner-level history parity at capacity < N
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain-merge", "kernel-merge"])
def test_fedasync_tiered_history_identical_to_dense(use_kernel):
    fl = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=4, seed=3)
    hd = run_fedasync(_trainer(), _net(fl), fl, window=3, eval_every=4,
                      use_store=True, use_kernel_agg=use_kernel)
    ht = run_fedasync(_trainer(), _net(fl), fl, window=3, eval_every=4,
                      store_capacity=3, use_kernel_agg=use_kernel)
    _hist_equal(hd, ht)
    assert ht.meta["residency"] == "tiered-host"
    assert ht.meta["hot_rows"] == 3
    assert ht.meta["store_reason"] == "auto-tiered"
    assert hd.meta["residency"] == "dense"
    assert hd.meta["hot_rows"] == 8


@pytest.mark.parametrize("trainer_cls", [_IntLeafTrainer,
                                         SyntheticCohortTrainer])
def test_fedbuff_capacity_one_history_identical_to_dense(trainer_cls):
    """Capacity 1 forces spill-path gathers and merges on every window
    (window=2 > hot rows) — histories still bit-identical.  The
    _IntLeafTrainer variant rides the looped gather_one path with the
    int32 sidecar in play."""
    fl = FLConfig(n_clients=6, tau=2, rounds=4, seed=2)

    def trainer():
        return trainer_cls(device="cpu") if trainer_cls is \
            SyntheticCohortTrainer else trainer_cls()

    hd = run_fedbuff(trainer(), _net(fl), fl, window=2, eval_every=8,
                     use_store=True)
    ht = run_fedbuff(trainer(), _net(fl), fl, window=2, eval_every=8,
                     store_capacity=1)
    _hist_equal(hd, ht)
    assert ht.meta["hot_rows"] == 1


def test_feddct_async_tiered_history_identical_to_dense(tmp_path):
    fl = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=6, mu=0.3,
                  seed=5, beta=1.1)
    hd = run_feddct_async(_trainer(), _net(fl), fl, use_store=True)
    ht = run_feddct_async(_trainer(), _net(fl), fl, store_capacity=2)
    _hist_equal(hd, ht)
    assert ht.meta["residency"] == "tiered-host"
    # and the disk cold tier produces the same history again
    hk = run_feddct_async(_trainer(), _net(fl), fl, store_capacity=2,
                          store_cold_dir=str(tmp_path))
    _hist_equal(hd, hk)
    assert hk.meta["residency"] == "tiered-disk"


def test_tiered_history_identical_to_dict_reference():
    """Transitivity spot-check straight against the dict-of-trees path."""
    fl = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=4, seed=3)
    hdict = run_fedasync(_FakeLoopTrainer(), _net(fl), fl, window=3,
                         eval_every=4, use_store=False)
    ht = run_fedasync(_FakeLoopTrainer(), _net(fl), fl, window=3,
                      eval_every=4, store_capacity=2)
    _hist_equal(hdict, ht)
    assert hdict.meta["residency"] == "dict"
    assert hdict.meta["hot_rows"] == 0


def test_use_store_false_wins_over_capacity():
    """Explicit dict-path requests beat the capacity hint — the A/B
    reference arm must stay a true dict path."""
    fl = FLConfig(n_clients=6, tau=2, rounds=2, seed=6)
    h = run_fedbuff(_trainer(), _net(fl), fl, window=2, eval_every=8,
                    use_store=False, store_capacity=2)
    assert h.meta["store_path"] == "dict"
    assert h.meta["store_reason"] == "forced-off"


def test_quant8_dense_tiered_host_disk_histories_identical(tmp_path):
    """Residency stays pure data movement under quantized rows: dense
    vs tiered-host vs tiered-disk at capacity < N are bit-identical,
    with identical modeled uplink and residual bytes."""
    fl = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=6, mu=0.3,
                  seed=5, beta=1.1)
    hd = run_feddct_async(_trainer(), _net(fl), fl, quant_bits=8)
    hh = run_feddct_async(_trainer(), _net(fl), fl, quant_bits=8,
                          store_capacity=3)
    hk = run_feddct_async(_trainer(), _net(fl), fl, quant_bits=8,
                          store_capacity=3, store_cold_dir=str(tmp_path))
    _hist_equal(hd, hh)
    _hist_equal(hd, hk)
    assert hd.meta["bytes_up"] == hh.meta["bytes_up"] \
        == hk.meta["bytes_up"]
    assert hd.meta["store_bytes_ef"] == hh.meta["store_bytes_ef"] \
        == hk.meta["store_bytes_ef"] > 0
    assert hh.meta["store_bytes_cold"] > 0
    assert hk.meta["store_bytes_cold"] > 0


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def _equal_but_accuracy(got, want):
    g, w = got.to_json(), want.to_json()
    acc_g, acc_w = g.pop("accuracy"), w.pop("accuracy")
    assert g == w       # times, rounds, tiers, selections, all of meta
    assert len(acc_g) == len(acc_w) > 0
    np.testing.assert_allclose(acc_g, acc_w, rtol=0, atol=1e-6)


FEDDCT_FL = dict(n_clients=8, n_tiers=4, tau=2, rounds=6, mu=0.3, seed=5,
                 beta=1.1)
TIERED_RUNS = {
    "fedasync-w3": ("fedasync", dict(n_clients=8, n_tiers=4, tau=2,
                                     rounds=4, seed=3),
                    dict(window=3, eval_every=4)),
    "fedbuff": ("fedbuff", dict(n_clients=6, tau=2, rounds=4, seed=2),
                dict(window=2, eval_every=8)),
    "feddct_async": ("feddct_async", FEDDCT_FL, {}),
}


@pytest.mark.parametrize("quant_bits", [32, 8], ids=["q32", "q8"])
@pytest.mark.parametrize("capacity,cold", [(3, "host"), (1, "host"),
                                           (2, "disk")])
@pytest.mark.parametrize("run", sorted(TIERED_RUNS))
def test_tiered_histories_equal_the_reference(tmp_path, run, capacity,
                                              cold, quant_bits):
    """The same tiered run in both packages: equal histories and meta
    (residency, hot rows, hot / cold / residual bytes, uplink)."""
    method, fl_kw, kw = TIERED_RUNS[run]
    kw = dict(kw, store_capacity=capacity, use_kernel_agg=False,
              quant_bits=quant_bits)
    dirs = {}
    if cold == "disk":
        for side in ("ref", "port"):
            dirs[side] = str(tmp_path / side)
    want = ref_run_method(method, RefSynthetic(),
                          _ref_net(RefFLConfig(**fl_kw)),
                          RefFLConfig(**fl_kw),
                          store_cold_dir=dirs.get("ref"), **kw)
    got = run_method(method, _trainer(), _net(FLConfig(**fl_kw)),
                     FLConfig(**fl_kw), store_cold_dir=dirs.get("port"),
                     **kw)
    _equal_but_accuracy(got, want)
    assert got.meta["residency"] == f"tiered-{cold}"
    assert got.meta["hot_rows"] == capacity


@pytest.mark.parametrize("capacity", [2, 4])
def test_traced_residency_counters_equal_the_reference(capacity):
    """Traced tiered runs record the same residency and lookahead
    counters in both packages: the same promotions, hits, write-behinds,
    clean evictions, write-arounds and oversubscribed gathers."""
    for method, fl_kw, kw in TIERED_RUNS.values():
        kw = dict(kw, store_capacity=capacity, use_kernel_agg=False)
        with obs.tracing():
            got = run_method(method, _trainer(), _net(FLConfig(**fl_kw)),
                             FLConfig(**fl_kw), **kw)
        with ref_tel.tracing():
            want = ref_run_method(method, RefSynthetic(),
                                  _ref_net(RefFLConfig(**fl_kw)),
                                  RefFLConfig(**fl_kw), **kw)
        g = got.meta["telemetry"]["counters"]
        w = want.meta["telemetry"]["counters"]
        pick = ("residency.", "lookahead.")
        gr = {k: v for k, v in g.items() if k.startswith(pick)}
        assert gr == {k: v for k, v in w.items() if k.startswith(pick)}
        assert any(k.startswith("residency.") for k in gr), method
        assert got.meta["telemetry"]["gauges"] == \
            want.meta["telemetry"]["gauges"]


# ---------------------------------------------------------------------------
# telemetry of tiered runs (the tiered cases of tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_tracing_is_numerically_invisible_tiered():
    """Bit-identical RunHistories with tracing on vs off on a tiered
    store; the traced meta differs ONLY by the additive ``telemetry``
    block."""
    fl = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=3, seed=0)
    h_off = run_method("feddct_async", _trainer(), _net(fl), fl,
                       store_capacity=2)
    with obs.tracing():
        h_on = run_method("feddct_async", _trainer(), _net(fl), fl,
                          store_capacity=2)
    assert h_on.times == h_off.times
    assert h_on.rounds == h_off.rounds
    assert h_on.accuracy == h_off.accuracy
    assert h_on.tier == h_off.tier
    assert h_on.n_selected == h_off.n_selected
    assert "telemetry" not in h_off.meta
    on_meta = dict(h_on.meta)
    assert on_meta.pop("telemetry")["spans"]["run"]["count"] == 1
    assert on_meta == h_off.meta


def test_traced_tiered_feddct_async_acceptance(tmp_path, monkeypatch):
    """A tiered-residency feddct_async run under tracing yields (a)
    spans covering >= 95% of the measured run wall-clock, (b) per-window
    gather/train/merge/scatter attribution, (c) residency + prefetch
    counters, (d) a Chrome trace and a JSONL trace that validates.

    (a) leaves out the run's own summary, which follows the ``run``
    span's end in both packages: the port's eager run here takes ~10
    ms, of which the summary's percentiles are ~2 ms."""
    fl = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=4, seed=0)
    trainer, net = _trainer(), _net(fl)
    summary_s = []
    real = obs_tel.Telemetry.summarize_into

    def timed_summary(self, meta):
        t = time.perf_counter()
        real(self, meta)
        summary_s.append(time.perf_counter() - t)

    monkeypatch.setattr(obs_tel.Telemetry, "summarize_into", timed_summary)
    t0 = time.perf_counter()
    with obs.tracing() as tel:
        hist = run_method("feddct_async", trainer, net, fl,
                          store_capacity=4)
    wall = time.perf_counter() - t0 - sum(summary_s)
    t = hist.meta["telemetry"]
    run_s = t["spans"]["run"]["total_s"]
    assert len(summary_s) == 1
    assert run_s >= 0.95 * wall, f"run span {run_s:.4f}s < 95% of {wall:.4f}s"
    for name in ("window.prefetch", "window.merge", "window.gather",
                 "window.train", "store.merge", "store.scatter",
                 "round.select", "eval"):
        assert name in t["spans"], f"missing span {name}"
    counters = t["counters"]
    assert any(k.startswith("residency.") for k in counters), counters
    assert counters.get("lookahead.hit", 0) > 0
    assert "lookahead_accuracy" in t.get("rates", {})
    assert "drain.deadline" in counters or "drain.budget" in counters
    jp = tel.export_jsonl(str(tmp_path / "t.jsonl"))
    errors, counts = validate_file(jp)
    assert errors == []
    assert counts["span"] == len(tel.spans)
    cp = tel.export_chrome(str(tmp_path / "t.json"))
    with open(cp) as f:
        doc = json.load(f)
    assert any(e.get("name") == "run" for e in doc["traceEvents"])


def test_prefetch_hit_rate_surfaces_when_windows_fit():
    """With a hot tier at least as wide as the windows, gathers take
    the demand-staging path and the prefetch hit rate is defined."""
    fl = FLConfig(n_clients=6, n_tiers=4, tau=2, rounds=4, seed=0)
    with obs.tracing():
        h = run_method("fedasync", _trainer(), _net(fl), fl, window=2,
                       store_capacity=4, eval_every=2)
    t = h.meta["telemetry"]
    c = t["counters"]
    demand = (c.get("residency.demand_hit", 0)
              + c.get("residency.demand_promote", 0))
    assert demand > 0, c
    assert "prefetch_hit_rate" in t["rates"]
    assert 0.0 <= t["rates"]["prefetch_hit_rate"] <= 1.0
