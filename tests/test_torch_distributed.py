"""The port's client-mesh path (``repro_torch.distributed``) against the
JAX package's.

On the CPU the port's mesh is four virtual shards of the CPU
(``make_client_mesh(4, devices=["cpu"] * 4)``), the counterpart of the
JAX package's forced host devices.  The JAX package has one CPU device
in this run, so the port's multi-shard results are held against the
reference's single-device results and its 1-device ``sharded_aggregate``
— what ``tests/test_distributed.py``'s own multi-device tests assert.

Tolerances: sharded reductions add per-shard partial sums, so they
equal the single-device reduction up to f32 reassociation (rtol=atol=
1e-5, bf16 leaves 2e-2 as the reference's tests state); the reduced CNN
trains a shard's rows in smaller batched products than the whole
cohort's (atol 5e-5 on the trained rows, 1e-4 on the merge); whole
histories keep their times and selections and hold accuracy within
5e-3.  The plan's arithmetic, the store's gathers and a 1-shard mesh
are exact.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config.base import FLConfig
from repro.core import aggregation as ref_agg
from repro.core import baselines as ref_baselines
from repro.core.scheduler import run_feddct as ref_run_feddct
from repro.distributed import ClientShardingPlan as RefPlan
from repro.distributed import make_client_mesh as ref_make_client_mesh
from repro.distributed import sharded_aggregate as ref_sharded_aggregate
from repro.fl.network import WirelessNetwork
from repro.fl.testing import SyntheticCohortTrainer as RefSynthetic
from repro.kernels import fedagg_pytree as ref_fedagg_pytree
from repro.runtime.async_loop import run_feddct_async as ref_feddct_async
from repro_torch import bridge
from repro_torch.config import get_arch as pt_get_arch
from repro_torch.config.base import FLConfig as PtFLConfig
from repro_torch.core import baselines as pt_baselines
from repro_torch.core.aggregation import (staleness_merge_coefficients,
                                          staleness_weighted_merge,
                                          weighted_average_stacked)
from repro_torch.core.engine import BatchedClientEngine, make_engine
from repro_torch.core.scheduler import run_feddct
from repro_torch.core.state import ClientStateStore
from repro_torch.distributed import (CLIENT_AXIS, ClientShardingPlan,
                                     client_devices,
                                     ensure_host_device_count,
                                     forced_host_device_count,
                                     make_client_mesh, shard_cohort_train,
                                     sharded_aggregate,
                                     sharded_staleness_merge)
from repro_torch.distributed import hostdevices
from repro_torch.distributed.engine import ShardedClientEngine
from repro_torch.fl.client import CNNTrainer
from repro_torch.fl.network import WirelessNetwork as PtNetwork
from repro_torch.fl.testing import SyntheticCohortTrainer
from repro_torch.kernels import fedagg as fedagg_mod
from repro_torch.launch import fl_train
from repro_torch.runtime.async_loop import run_feddct_async
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = hostdevices.ENV_VAR
SHARDS = 4
MESH = make_client_mesh(SHARDS, devices=["cpu"] * SHARDS)
ONE_SHARD = make_client_mesh(1, devices=["cpu"])


@pytest.fixture(autouse=True)
def _no_forced_count(monkeypatch):
    """Every test starts without a forced shard count in the process
    environment, and whatever a test sets there is undone after it
    (``setenv`` first, so that monkeypatch records the variable)."""
    monkeypatch.setenv(ENV, "")
    monkeypatch.delenv(ENV)


def _stacked_np(n, seed=0):
    """Mixed-dtype stacked update tree: 3-d f32, bf16 matrix, scalar."""
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.normal(size=(n, 5, 3)).astype(np.float32),
        "bf16": rng.normal(size=(n, 7)).astype(np.float32).astype(
            ml_dtypes.bfloat16),
        "scalar": rng.normal(size=(n,)).astype(np.float32),
    }


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_close(got, want, rtol=1e-5, atol=1e-5, bf16_tol=2e-2):
    """``got`` a port tree, ``want`` a reference (or port) tree, leaf by
    leaf in the reference's leaf order, dtypes equal."""
    got_l = tree_leaves(got)
    want_l = (tree_leaves(want) if isinstance(tree_leaves(want)[0],
                                              torch.Tensor)
              else jax.tree_util.tree_leaves(want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        w = (w.float().numpy() if isinstance(w, torch.Tensor)
             else np.asarray(w, np.float32))
        assert tuple(g.shape) == w.shape
        tol = (dict(rtol=bf16_tol, atol=bf16_tol)
               if g.dtype == torch.bfloat16 else dict(rtol=rtol, atol=atol))
        np.testing.assert_allclose(g.float().numpy(), w, **tol)


def _net(cls, fl):
    return cls(fl.n_clients, fl.tier_delay_means, fl.delay_std, fl.mu,
               fl.failure_delay, fl.seed)


# ---------------------------------------------------------------------------
# forced shard count (hostdevices)
# ---------------------------------------------------------------------------

def test_ensure_host_device_count_appends_not_clobbers():
    env = {ENV: "--other_flag=false"}
    assert ensure_host_device_count(8, env) == 8
    assert env[ENV] == "--other_flag=false --force_client_shards=8"


def test_ensure_host_device_count_existing_flag_wins():
    env = {ENV: "--force_client_shards=4"}
    assert ensure_host_device_count(16, env) == 4
    assert env[ENV] == "--force_client_shards=4"
    assert forced_host_device_count(env) == 4
    # an existing count wins even over a request the function refuses
    assert ensure_host_device_count(0, env) == 4


def test_ensure_host_device_count_empty_env():
    env = {}
    assert ensure_host_device_count(2, env) == 2
    assert env[ENV] == "--force_client_shards=2"
    with pytest.raises(ValueError):
        ensure_host_device_count(0, {})


def test_forced_host_device_count_absent_and_ignores_xla_flags():
    assert forced_host_device_count({ENV: "--foo=1"}) is None
    assert forced_host_device_count({}) is None
    # torch ignores XLA_FLAGS, and so does the port's count
    assert forced_host_device_count(
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}) is None


def test_ensure_host_device_count_defaults_to_the_process_environment():
    assert forced_host_device_count() is None
    assert ensure_host_device_count(3) == 3
    assert forced_host_device_count() == 3


def test_hostdevices_imports_no_torch():
    tree = ast.parse((ROOT / "src" / "repro_torch" / "distributed" /
                      "hostdevices.py").read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert "torch" not in names and names <= {"__future__", "os", "re",
                                              "typing"}


# ---------------------------------------------------------------------------
# mesh factory
# ---------------------------------------------------------------------------

def test_make_client_mesh_spans_the_devices_there_are(monkeypatch):
    mesh = make_client_mesh(devices=client_devices("cpu"))
    assert mesh.axis_names == ("clients",) == (CLIENT_AXIS,)
    # the CPU asked for by name and no forced count: the CPU alone, as
    # the reference's unforced CPU mesh
    assert mesh.size == len(jax.devices()) == 1
    assert mesh.devices == (torch.device("cpu"),)
    monkeypatch.setenv(ENV, "--force_client_shards=4")
    forced = make_client_mesh(devices=client_devices("cpu"))
    assert forced.size == 4
    assert forced.devices == (torch.device("cpu"),) * 4


def test_make_client_mesh_subset_and_clamp(monkeypatch):
    def cpu_mesh(n):
        return make_client_mesh(n, devices=client_devices("cpu"))

    assert cpu_mesh(1).size == 1
    assert cpu_mesh(10 ** 6).size == 1                    # clamped
    with pytest.raises(ValueError):
        cpu_mesh(0)
    monkeypatch.setenv(ENV, "--force_client_shards=4")
    assert cpu_mesh(2).size == 2
    assert cpu_mesh(10 ** 6).size == 4
    # the JAX package clamps the same way
    assert int(ref_make_client_mesh(10 ** 6).size) == len(jax.devices())


def test_make_client_mesh_raises_without_a_gpu():
    """No silent CPU mesh: the default devices are CUDA devices."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_client_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        client_devices()


def test_make_client_mesh_explicit_devices():
    mesh = make_client_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert make_client_mesh(2, devices=["cpu"] * 3).size == 2
    assert MESH.size == SHARDS
    with pytest.raises(AttributeError):            # frozen
        MESH.devices = ()


# ---------------------------------------------------------------------------
# sharding plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,pow2,expect", [
    (3, 8, False, 8),       # N smaller than the mesh
    (12, 8, False, 16),     # N not divisible by the mesh
    (16, 8, False, 16),     # exact multiple: no padding
    (3, 8, True, 8),        # pow2 then mesh multiple
    (5, 4, True, 8),
    (6, 1, True, 8),        # 1-device mesh: pure pow2 convention
    (7, 3, False, 9),       # non-pow2 mesh still lands on a multiple
])
def test_plan_padding_math(n, d, pow2, expect):
    plan = ClientShardingPlan.for_cohort(n, d, pow2=pow2)
    ref = RefPlan.for_cohort(n, d, pow2=pow2)
    assert plan.padded_n == ref.padded_n == expect
    assert plan.padded_n % d == 0
    assert plan.pad_rows == ref.pad_rows == expect - n
    assert plan.rows_per_shard == ref.padded_n // ref.mesh_size == expect // d
    assert plan.axis == ref.axis == "clients"


def test_plan_takes_a_mesh_and_rejects_empty_cohorts_and_meshes():
    assert ClientShardingPlan.for_cohort(5, MESH).padded_n == 8
    for bad in ((0, 4), (3, 0)):
        with pytest.raises(ValueError):
            ClientShardingPlan.for_cohort(*bad)
        with pytest.raises(ValueError):
            RefPlan.for_cohort(*bad)


def test_plan_pad_unpad_roundtrip_edge_and_zero():
    tree_np = _stacked_np(5)
    tree = bridge.from_reference(tree_np, "cpu")
    plan = ClientShardingPlan.for_cohort(5, 4)
    ref_plan = RefPlan.for_cohort(5, 4)
    for mode in ("edge", "zero"):
        padded = plan.pad_stacked(tree, mode=mode)
        assert {l.shape[0] for l in tree_leaves(padded)} == {8}
        ref_padded = ref_plan.pad_stacked(_jax(tree_np), mode=mode)
        _assert_close(padded, ref_padded, rtol=0, atol=0, bf16_tol=0)
        back = plan.unpad(padded)
        for a, b in zip(tree_leaves(back), tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    edge = plan.pad_stacked(tree, mode="edge")
    assert torch.equal(edge["f32"][-1], tree["f32"][-1])
    zero = plan.pad_stacked(tree, mode="zero")
    assert float(zero["f32"][5:].abs().sum()) == 0.0
    w = plan.pad_weights(np.ones(5, np.float32))
    assert w.shape == (8,) and w.dtype == torch.float32
    assert float(w[5:].sum()) == 0.0
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(ref_plan.pad_weights(np.ones(5, np.float32))))
    # a tensor stays a tensor on its device
    assert torch.equal(plan.pad_weights(torch.ones(5, dtype=torch.float64)),
                       w)
    with pytest.raises(ValueError):
        plan.pad_stacked(tree, mode="wat")


def test_plan_without_padding_returns_its_inputs():
    tree = bridge.from_reference(_stacked_np(8), "cpu")
    plan = ClientShardingPlan.for_cohort(8, 4)
    assert plan.pad_rows == 0
    assert plan.pad_stacked(tree) is tree and plan.unpad(tree) is tree


# ---------------------------------------------------------------------------
# sharded aggregation (uneven cohorts, mixed dtypes, stragglers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n", [3, 5, 12, 16])
def test_sharded_aggregate_matches_reference(n, use_kernel):
    """N < mesh, N not divisible by the mesh, N a multiple: the port's
    4-shard reduction equals the reference's single-device one and its
    1-device sharded one within dtype tolerance."""
    tree = _stacked_np(n, seed=n)
    rng = np.random.default_rng(n + 1)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[0] = 0.0                                 # masked straggler row
    before = fedagg_mod.partial_launches
    out = sharded_aggregate(MESH, bridge.from_reference(tree, "cpu"), w,
                            use_kernel=use_kernel)
    assert fedagg_mod.partial_launches == before   # CPU: no launch
    _assert_close(out, ref_agg.weighted_average_stacked(_jax(tree), w))
    _assert_close(out, ref_sharded_aggregate(ref_make_client_mesh(),
                                             _jax(tree), w))
    _assert_close(out, weighted_average_stacked(
        bridge.from_reference(tree, "cpu"), w))
    for got, leaf in zip(tree_leaves(out),
                         tree_leaves(bridge.from_reference(tree, "cpu"))):
        assert got.dtype == leaf.dtype and got.shape == leaf.shape[1:]


def test_sharded_aggregate_kernel_dispatch_equals_the_plain_branch():
    """``use_kernel`` on CPU tensors takes the kernel's plain version,
    the very row loop the plain branch runs: bit for bit."""
    tree = bridge.from_reference(_stacked_np(9, seed=11), "cpu")
    w = np.random.default_rng(12).uniform(0.5, 2.0, 9).astype(np.float32)
    w[3] = 0.0
    a = sharded_aggregate(MESH, tree, w, use_kernel=True)
    b = sharded_aggregate(MESH, tree, w)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_sharded_aggregate_nonuniform_alphas():
    n = 11
    tree = _stacked_np(n, seed=2)
    rng = np.random.default_rng(3)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    alphas = (0.6 * (np.arange(n) + 1.0) ** -0.5).astype(np.float32)
    alphas[4] = 0.0                            # zero-alpha straggler
    out = sharded_aggregate(MESH, bridge.from_reference(tree, "cpu"), w,
                            alphas=alphas)
    _assert_close(out, ref_agg.weighted_average_stacked(_jax(tree), w,
                                                        alphas=alphas))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_aggregate_zero_rows_masked_even_nonfinite(use_kernel):
    tree = {"w": torch.tensor([[1.0, 2.0], [np.nan, np.inf], [3.0, 4.0]])}
    out = sharded_aggregate(MESH, tree, [1.0, 0.0, 1.0],
                            use_kernel=use_kernel)
    np.testing.assert_allclose(out["w"].numpy(), [2.0, 3.0], rtol=1e-6)
    want = ref_sharded_aggregate(ref_make_client_mesh(),
                                 {"w": jnp.asarray(tree["w"].numpy())},
                                 [1.0, 0.0, 1.0])
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6)


def test_sharded_aggregate_all_masked_is_zeros():
    out = sharded_aggregate(MESH, {"w": torch.ones(4, 9)}, np.zeros(4))
    assert not out["w"].any()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_aggregate_all_masked_fallback(use_kernel):
    fallback = {"w": torch.tensor([5.0, 6.0])}
    out = sharded_aggregate(MESH, {"w": torch.full((4, 2), float("nan"))},
                            np.zeros(4), fallback=fallback,
                            use_kernel=use_kernel)
    assert torch.equal(out["w"], fallback["w"])
    # with a survivor the fallback is not taken
    live = sharded_aggregate(MESH, {"w": torch.ones(4, 2)},
                             [0.0, 0.0, 2.0, 0.0], fallback=fallback)
    assert torch.equal(live["w"], torch.ones(2))


def test_sharded_aggregate_matches_pallas_fedagg():
    n = 6
    tree = _stacked_np(n, seed=5)
    w = np.asarray([1.0, 2.0, 0.0, 3.0, 0.5, 1.5], np.float32)
    out = sharded_aggregate(MESH, bridge.from_reference(tree, "cpu"), w)
    _assert_close(out, ref_fedagg_pytree(_jax(tree), jnp.asarray(w),
                                         interpret=True))


def test_sharded_aggregate_rejects_length_mismatch():
    with pytest.raises(ValueError):
        sharded_aggregate(MESH, {"w": torch.ones(4, 2)}, np.ones(3))
    with pytest.raises(ValueError):
        sharded_aggregate(MESH, {"w": torch.ones(4, 2)}, np.ones(4),
                          alphas=np.ones(5))


def test_sharded_aggregate_padding_rows_are_a_bitwise_no_op():
    """Zero-weight rows appended to the cohort change no bit: the plan's
    zero rows, and rows a caller pads with, are skipped alike."""
    tree = bridge.from_reference(_stacked_np(5, seed=21), "cpu")
    w = np.asarray([1.5, 0.0, 2.0, 0.7, 1.1], np.float32)
    base = sharded_aggregate(MESH, tree, w)
    padded = ClientShardingPlan.for_cohort(5, 4).pad_stacked(tree,
                                                             mode="edge")
    more = sharded_aggregate(MESH, padded, np.concatenate(
        [w, np.zeros(3, np.float32)]))
    for a, b in zip(tree_leaves(base), tree_leaves(more)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n,seed", [(7, 8), (10, 13)])
def test_sharded_staleness_merge_matches_reference(n, seed, use_kernel):
    stacked = _stacked_np(n, seed=seed)
    g_np = jax.tree_util.tree_map(lambda l: (l[0].astype(np.float32) * 0.5)
                                  .astype(l.dtype), stacked)
    alphas = 0.6 * (np.arange(n, dtype=np.float64) + 1.0) ** -0.5
    alphas[2 if n == 7 else 4] = 0.0          # carried straggler: no-op row
    out = sharded_staleness_merge(MESH, bridge.from_reference(g_np, "cpu"),
                                  bridge.from_reference(stacked, "cpu"),
                                  alphas, use_kernel=use_kernel)
    want = ref_agg.staleness_weighted_merge(_jax(g_np), _jax(stacked),
                                            alphas)
    _assert_close(out, want)
    # and the port's own single-device merge
    _assert_close(out, staleness_weighted_merge(
        bridge.from_reference(g_np, "cpu"),
        bridge.from_reference(stacked, "cpu"), alphas))
    for o, g in zip(tree_leaves(out), tree_leaves(
            bridge.from_reference(g_np, "cpu"))):
        assert o.dtype == g.dtype


def test_sharded_staleness_merge_global_only_and_nonfinite_masked_rows():
    g = {"w": torch.tensor([1.0, -2.0, 3.0])}
    stacked = {"w": torch.tensor([[np.inf, 0.0, 0.0], [5.0, 6.0, 7.0]])}
    alphas = np.asarray([0.0, 0.0])
    out = sharded_staleness_merge(MESH, g, stacked, alphas, use_kernel=True)
    assert torch.equal(out["w"], g["w"])      # c0 == 1 exactly


# ---------------------------------------------------------------------------
# shard_cohort_train mechanics (plain functions, no trainer)
# ---------------------------------------------------------------------------

def test_shard_cohort_train_elementwise_parity_uneven():
    shapes = []

    def train(starts, x):
        shapes.append(x.shape[0])
        return tree_map(lambda l: l + x[:, :1] ** 2, starts)

    run = shard_cohort_train(MESH, train, replicated=0)
    for n in (2, 5, 16):                       # < mesh, uneven, multiple
        shapes.clear()
        starts = {"w": torch.arange(float(n * 3)).reshape(n, 3)}
        x = torch.arange(float(n * 4)).reshape(n, 4)
        out = run(starts, x)
        assert out["w"].shape == (n, 3)
        assert torch.equal(out["w"], train(starts, x)["w"])
        # four shards of equal height
        assert shapes[:SHARDS] == [-(-n // SHARDS)] * SHARDS


def test_shard_cohort_train_replicated_leading_arg():
    seen = []

    def train(params, x):
        seen.append(float(params["scale"]))
        return {"w": x * params["scale"]}

    run = shard_cohort_train(MESH, train, replicated=1)
    x = torch.arange(float(SHARDS * 2 + 1)).reshape(-1, 1)   # uneven rows
    out = run({"scale": torch.tensor(3.0)}, x)
    assert torch.equal(out["w"], x * 3.0)
    assert seen == [3.0] * SHARDS              # every shard got it whole


def test_shard_cohort_train_requires_sharded_arg():
    run = shard_cohort_train(MESH, lambda p: p, replicated=1)
    with pytest.raises(ValueError):
        run({"w": torch.ones(3)})


# ---------------------------------------------------------------------------
# engine selection
# ---------------------------------------------------------------------------

class _FakeLoopTrainer:
    class cfg:
        arch_id = "fake"

    device = torch.device("cpu")

    def init_params(self, seed=0):
        return {"w": torch.zeros(4)}

    def local_train(self, params, client_id, rnd_seed):
        return {"w": params["w"] + 1.0 + client_id}, 10 + client_id


def test_make_engine_one_shard_mesh_is_plain_engine():
    """A 1-shard mesh selects the existing engine, so histories are
    bit-identical by construction."""
    eng = make_engine(_FakeLoopTrainer(), mesh=ONE_SHARD)
    assert type(eng) is BatchedClientEngine
    assert type(make_engine(_FakeLoopTrainer())) is BatchedClientEngine


def test_make_engine_looped_plus_mesh_rejected_or_passthrough():
    with pytest.raises(ValueError):
        make_engine(_FakeLoopTrainer(), engine="looped", mesh=MESH)
    eng = make_engine(_FakeLoopTrainer(), engine="looped",
                      mesh=ONE_SHARD)
    assert eng.force_looped


def test_make_engine_multi_shard_mesh_is_sharded():
    eng = make_engine(_FakeLoopTrainer(), mesh=MESH, use_kernel_agg=True)
    assert isinstance(eng, ShardedClientEngine)
    assert eng.mesh is MESH and eng.use_kernel_agg
    # pad target composes pow2 with the mesh multiple
    assert [eng._pad_target(n) for n in (1, 3, 5, 9)] == [4, 4, 8, 16]
    three = ShardedClientEngine(_FakeLoopTrainer(),
                                make_client_mesh(devices=["cpu"] * 3))
    assert [three._pad_target(n) for n in (1, 3, 5)] == [3, 6, 9]


def test_sharded_engine_loop_only_trainer_falls_back():
    """A trainer without the batched paths (or the wrap hook) keeps the
    looped fallback under a multi-shard mesh; the merge is sharded."""
    for use_kernel in (False, True):
        eng = make_engine(_FakeLoopTrainer(), mesh=MESH,
                          use_kernel_agg=use_kernel)
        out = eng.train_round({"w": torch.zeros(4)}, [1, 3], rnd_seed=0)
        expect = (2.0 * 11 + 4.0 * 13) / 24
        np.testing.assert_allclose(out["w"].numpy(),
                                   np.full(4, expect, np.float32),
                                   rtol=1e-6)


def test_sharded_engine_caches_one_runner_per_function():
    tr = SyntheticCohortTrainer(device="cpu")
    eng = make_engine(tr, mesh=MESH)
    assert eng._trainer_takes_wrap("local_train_cohort")
    assert not eng._trainer_takes_wrap("local_train")
    assert eng._wrap(tr._cohort_impl, 0) is eng._wrap(tr._cohort_impl, 0)
    assert eng._wrap(tr._cohort_impl, 0) is not eng._wrap(tr._cohort_impl,
                                                           1)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_synthetic_cohort_sharded_is_bitwise_the_plain_engine(n):
    """Elementwise training is exact on any split of the rows."""
    tr = SyntheticCohortTrainer(device="cpu")
    starts = [tr.init_params(c % 3) for c in range(n)]
    ids, seeds = list(range(n)), [5 * c + 2 for c in range(n)]
    s, s_sizes = make_engine(tr, mesh=MESH).train_cohort(starts, ids, seeds)
    p, p_sizes = make_engine(tr).train_cohort(starts, ids, seeds)
    np.testing.assert_array_equal(s_sizes, p_sizes)
    for a, b in zip(tree_leaves(s), tree_leaves(p)):
        assert a.shape[0] == n and torch.equal(a, b)


# ---------------------------------------------------------------------------
# trainer-level parity: the reduced CNN over four shards
# ---------------------------------------------------------------------------

_TRAINERS = {}


def _cnn(n_clients=8, seed=0, lr=0.003, tau=2, rounds=2):
    kw = dict(n_clients=n_clients, n_tiers=4, tau=tau, rounds=rounds,
              mu=0.0, primary_frac=0.7, seed=seed, lr=lr)
    fl = PtFLConfig(**kw)
    key = (n_clients, seed, lr)
    if key not in _TRAINERS:
        _TRAINERS[key] = CNNTrainer(pt_get_arch("cnn-mnist").reduced(), fl,
                                    "mnist", scale=0.01, device="cpu")
    return _TRAINERS[key], _net(PtNetwork, fl), fl


def test_cohort16_trains_sharded_and_matches_single_device():
    """A 16-client cohort trains over the four shards and matches the
    single-device engine row for row; the sharded merge with nonuniform
    staleness alphas and a zero-weight straggler row matches the plain
    merge."""
    tr, _, _ = _cnn(n_clients=16)
    sharded, plain = make_engine(tr, mesh=MESH), make_engine(tr)
    assert isinstance(sharded, ShardedClientEngine)
    ids = list(range(16))
    seeds = [7 * c + 1 for c in ids]
    starts = [tr.init_params(c % 3) for c in ids]
    s_stacked, s_sizes = sharded.train_cohort(starts, ids, seeds)
    p_stacked, p_sizes = plain.train_cohort(starts, ids, seeds)
    np.testing.assert_array_equal(s_sizes, p_sizes)
    for a, b in zip(tree_leaves(s_stacked), tree_leaves(p_stacked)):
        assert a.shape[0] == 16
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-5)

    alphas = 0.6 * (np.arange(16, dtype=np.float64) + 1.0) ** -0.5
    alphas[3] = 0.0                            # zero-weight straggler row
    g = tr.init_params(0)
    merged = sharded.merge_staleness(g, s_stacked, alphas)
    ref = plain.merge_staleness(g, p_stacked, alphas)
    for a, b in zip(tree_leaves(merged), tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


def test_train_clients_sharded_uneven_cohort_matches():
    """Sync path (shared global params, replicated arg) with a cohort
    smaller than the mesh."""
    tr, _, _ = _cnn()
    params = tr.init_params(0)
    s_stacked, s_sizes = make_engine(tr, mesh=MESH).train_clients(
        params, [0, 1, 2], 1)
    p_stacked, p_sizes = make_engine(tr).train_clients(params, [0, 1, 2], 1)
    np.testing.assert_array_equal(s_sizes, p_sizes)
    for a, b in zip(tree_leaves(s_stacked), tree_leaves(p_stacked)):
        assert a.shape[0] == 3
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-5)


@pytest.mark.parametrize("method", ["fedavg", "feddct"])
def test_cnn_sharded_history_matches_single_device(method):
    tr, net, fl = _cnn()
    hs = pt_baselines.run_method(method, tr, net, fl, mesh=MESH)
    tr2, net2, fl2 = _cnn()
    hp = pt_baselines.run_method(method, tr2, net2, fl2)
    assert hs.rounds == hp.rounds
    np.testing.assert_allclose(hs.times, hp.times, rtol=1e-9)
    np.testing.assert_allclose(hs.accuracy, hp.accuracy, atol=5e-3)
    assert hs.meta["mesh_devices"] == SHARDS and hp.meta["mesh_devices"] == 1


@pytest.mark.parametrize("use_store", [True, False])
def test_cnn_fedasync_windowed_sharded_matches_single_device(use_store):
    """Windowed async cohorts train sharded and merge (store: the
    folded merge; dict: the sharded reduction) within tolerance of the
    single-device runtime."""
    tr, net, fl = _cnn(seed=1)
    hs = pt_baselines.run_fedasync(tr, net, fl, window_secs=20.0,
                                   eval_every=4, mesh=MESH,
                                   use_store=use_store)
    assert hs.meta["store_path"] == ("store" if use_store else "dict")
    tr2, net2, fl2 = _cnn(seed=1)
    hp = pt_baselines.run_fedasync(tr2, net2, fl2, window_secs=20.0,
                                   eval_every=4, use_store=use_store)
    assert hs.rounds == hp.rounds
    assert hs.times == hp.times
    assert hs.meta["mean_cohort"] == hp.meta["mean_cohort"] > 1.0
    np.testing.assert_allclose(hs.accuracy, hp.accuracy, atol=5e-3)


def test_fedasync_window0_gate_holds_with_one_shard_mesh():
    """A 1-shard client mesh leaves ``run_fedasync(window=0)``
    history-identical to the sequential loop."""
    tr, net, fl = _cnn()
    hs = pt_baselines.run_fedasync_sequential(tr, net, fl, eval_every=3)
    tr2, net2, fl2 = _cnn()
    hr = pt_baselines.run_fedasync(tr2, net2, fl2, window=0, eval_every=3,
                                   mesh=ONE_SHARD)
    assert hs.rounds == hr.rounds
    assert hs.times == hr.times
    assert hs.accuracy == hr.accuracy
    assert hs.n_selected == hr.n_selected


# ---------------------------------------------------------------------------
# whole histories with the synthetic trainer: 4 shards vs the reference
# ---------------------------------------------------------------------------

SYNC_FL = dict(n_clients=8, n_tiers=4, tau=3, rounds=4, seed=3)
ASYNC_FL = dict(n_clients=8, n_tiers=4, tau=2, rounds=4, seed=3)
FEDDCT_ASYNC_FL = dict(n_clients=8, n_tiers=4, tau=2, rounds=6, mu=0.3,
                       seed=5, beta=1.1)
HISTORIES = {
    "fedavg": (ref_baselines.run_fedavg, pt_baselines.run_fedavg, SYNC_FL,
               {}),
    "tifl": (ref_baselines.run_tifl, pt_baselines.run_tifl, SYNC_FL, {}),
    "fedprox": (ref_baselines.run_fedprox, pt_baselines.run_fedprox,
                SYNC_FL, {}),
    "feddct": (ref_run_feddct, run_feddct, SYNC_FL, {}),
    "fedasync-w3": (ref_baselines.run_fedasync, pt_baselines.run_fedasync,
                    ASYNC_FL, dict(window=3, eval_every=4)),
    "fedbuff": (ref_baselines.run_fedbuff, pt_baselines.run_fedbuff,
                ASYNC_FL, dict(window=2, eval_every=4)),
    "feddct_async": (ref_feddct_async, run_feddct_async, FEDDCT_ASYNC_FL,
                     {}),
}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("method", sorted(HISTORIES))
def test_synthetic_sharded_histories_equal_the_reference(method,
                                                         use_kernel):
    """Every loop over four shards against the reference's single-device
    run: equal in all but accuracy (within 1e-5: the sharded sums are
    reassociated) and ``meta["mesh_devices"]``."""
    ref_run, pt_run, fl_kw, kw = HISTORIES[method]
    ref_fl, pt_fl = FLConfig(**fl_kw), PtFLConfig(**fl_kw)
    want = ref_run(RefSynthetic(), _net(WirelessNetwork, ref_fl), ref_fl,
                   use_kernel_agg=use_kernel, **kw)
    got = pt_run(SyntheticCohortTrainer(device="cpu"), _net(PtNetwork, pt_fl),
                 pt_fl, mesh=MESH, use_kernel_agg=use_kernel, **kw)
    assert got.meta["mesh_devices"] == SHARDS
    assert want.meta["mesh_devices"] == 1
    g, w = got.to_json(), want.to_json()
    for d in (g, w):
        d["meta"].pop("mesh_devices")
    acc_g, acc_w = g.pop("accuracy"), w.pop("accuracy")
    assert g == w
    assert len(acc_g) == len(acc_w) > 0
    np.testing.assert_allclose(acc_g, acc_w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["fedasync-w3", "fedbuff",
                                    "feddct_async"])
def test_synthetic_sharded_store_equals_dict(method):
    """Over four shards the store path merges through ``merge_scatter``
    and the dict path through the sharded reduction: equal up to
    reassociation, with the same windows."""
    _, pt_run, fl_kw, kw = HISTORIES[method]
    fl = PtFLConfig(**fl_kw)
    runs = {s: pt_run(SyntheticCohortTrainer(device="cpu"),
                      _net(PtNetwork, fl), fl, mesh=MESH, use_store=s, **kw)
            for s in (True, False)}
    assert runs[True].meta["store_path"] == "store"
    assert runs[False].meta["store_path"] == "dict"
    assert runs[True].times == runs[False].times
    assert runs[True].rounds == runs[False].rounds
    np.testing.assert_allclose(runs[True].accuracy, runs[False].accuracy,
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the client-state store over a mesh
# ---------------------------------------------------------------------------

def test_client_state_store_rows_padded_to_the_mesh_with_exact_gathers():
    template = {"f32": torch.arange(15.0).reshape(5, 3),
                "bf16": torch.arange(7.0).to(torch.bfloat16),
                "scalar": torch.tensor(0.5)}
    other = tree_map(lambda l: (l.float() * 2.0 + 1.0).to(l.dtype),
                     template)
    plain = ClientStateStore(template, 10)
    shard = ClientStateStore(template, 10, mesh=MESH)
    assert plain.rows == 10 and shard.rows == 12
    assert shard.rows % SHARDS == 0
    assert shard.bufs[0].shape[0] == 12
    assert shard.bufs[0].device == plain.bufs[0].device
    # a 1-shard mesh is the plain store
    assert ClientStateStore(template, 10, mesh=ONE_SHARD).rows == 10

    for s in (plain, shard):
        s.scatter_params([3, 5], other)
    for c in (0, 3, 5, 9):
        for a, b in zip(tree_leaves(shard.gather_one(c)),
                        tree_leaves(plain.gather_one(c))):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(shard.gather([9, 3, 0])),
                    tree_leaves(plain.gather([9, 3, 0]))):
        assert torch.equal(a, b)

    stacked = {"f32": template["f32"].expand(8, 5, 3) * 1.1,
               "bf16": (torch.ones(8, 7) * 0.3).to(torch.bfloat16),
               "scalar": torch.arange(8.0)}
    alphas = 0.6 * (np.arange(8, dtype=np.float64) + 1.0) ** -0.5
    alphas[2] = 0.0
    coef = staleness_merge_coefficients(alphas)
    ids = list(range(8))
    pp, _ = plain.merge_scatter(ids, stacked, coef, template)
    ps, _ = shard.merge_scatter(ids, stacked, coef, template)
    for a, b in zip(tree_leaves(ps), tree_leaves(pp)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(shard.gather_one(4)),
                    tree_leaves(plain.gather_one(4))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# meta and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["fedavg", "tifl", "fedprox", "feddct",
                                    "fedasync", "fedbuff", "feddct_async"])
def test_meta_records_the_mesh_size(method):
    fl = PtFLConfig(n_clients=6, tau=2, rounds=2, seed=4)
    kw = {"window": 2} if method in ("fedasync", "fedbuff") else {}
    for mesh, want in ((MESH, SHARDS), (ONE_SHARD, 1),
                       (None, 1)):
        hist = pt_baselines.run_method(method,
                                       SyntheticCohortTrainer(device="cpu"),
                                       _net(PtNetwork, fl), fl, mesh=mesh,
                                       **kw)
        assert hist.meta["mesh_devices"] == want


CLI = ["--arch", "cnn-mnist", "--method", "feddct", "--rounds", "2",
       "--clients", "4", "--tiers", "2", "--tau", "2", "--device", "cpu",
       "--scale", "0.01", "--mesh-clients", "4"]


def test_cli_mesh_clients_forced_and_unforced(monkeypatch, capsys):
    monkeypatch.setenv(ENV, "--force_client_shards=4")
    forced = fl_train.main(CLI)
    assert "[fl_train] client mesh: 4 device(s)" in capsys.readouterr().out
    assert forced.meta["mesh_devices"] == 4
    monkeypatch.delenv(ENV)
    unforced = fl_train.main(CLI)
    # no forced count and no GPU: clamped to the one device there is
    assert "[fl_train] client mesh: 1 device(s)" in capsys.readouterr().out
    assert unforced.meta["mesh_devices"] == 1
    plain = fl_train.main(CLI[:-2])
    assert "client mesh" not in capsys.readouterr().out
    assert unforced.to_json() == plain.to_json()
    assert forced.rounds == plain.rounds and forced.times == plain.times
    np.testing.assert_allclose(forced.accuracy, plain.accuracy, atol=5e-3)


def test_cli_mesh_async_store_and_no_store(monkeypatch, capsys):
    monkeypatch.setenv(ENV, "--force_client_shards=4")
    argv = CLI[:2] + ["--method", "feddct_async"] + CLI[4:]
    store = fl_train.main(argv)
    on_dict = fl_train.main(argv + ["--no-store"])
    out = capsys.readouterr().out
    assert out.count("[fl_train] client mesh: 4 device(s)") == 2
    assert store.meta["store_path"] == "store"
    assert on_dict.meta["store_path"] == "dict"
    assert store.meta["mesh_devices"] == on_dict.meta["mesh_devices"] == 4
    assert store.times == on_dict.times
    np.testing.assert_allclose(store.accuracy, on_dict.accuracy, atol=5e-3)


def test_cli_mesh_raises_without_a_cuda_device(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv(ENV, "--force_client_shards=4")
    with pytest.raises(RuntimeError, match="CUDA"):
        fl_train.main(["--rounds", "1", "--clients", "2", "--mesh-clients",
                       "4"])
