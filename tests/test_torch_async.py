"""The async slice of the port as a whole, against the JAX package:
whole ``RunHistory``s of FedAsync (windows 0, K and a time window),
FedBuff and semi-async FedDCT with the synthetic trainer — equal in
everything, accuracy within atol=1e-6 — on the store and dict paths,
with the kernel path on and off, batched and looped; the port's own
identities (store == dict bit for bit, window 0 == the sequential
loop, two seeded runs equal); one CNN window step from bridged
parameters (rtol=atol=1e-4: convolutions sum in another order); and the
CLI."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.config.base import FLConfig
from repro.core import baselines as ref_baselines
from repro.core.engine import make_engine as ref_make_engine
from repro.core.state import ClientStateStore as RefStore
from repro.fl.client import CNNTrainer as RefTrainer
from repro.fl.network import WirelessNetwork
from repro.fl.testing import SyntheticCohortTrainer as RefSynthetic
from repro.runtime.async_loop import run_feddct_async as ref_feddct_async
from repro_torch import bridge
from repro_torch.config import get_arch as pt_get_arch
from repro_torch.config.base import FLConfig as PtFLConfig
from repro_torch.core import baselines as pt_baselines
from repro_torch.core.engine import make_engine
from repro_torch.core.state import ClientStateStore
from repro_torch.fl.client import CNNTrainer
from repro_torch.fl.network import WirelessNetwork as PtNetwork
from repro_torch.fl.testing import SyntheticCohortTrainer
from repro_torch.launch import fl_train
from repro_torch.runtime import AsyncRunner
from repro_torch.runtime.async_loop import run_feddct_async
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

# meta keys that name the snapshot path, and so differ store vs dict
STORE_KEYS = {"store", "store_path", "store_reason", "residency",
              "hot_rows", "store_bytes_hot", "store_bytes_cold",
              "store_bytes_ef"}


def _net(cls, fl):
    return cls(fl.n_clients, fl.tier_delay_means, fl.delay_std, fl.mu,
               fl.failure_delay, fl.seed)


def _json(hist, drop=()):
    out = hist.to_json()
    out["meta"] = {k: v for k, v in out["meta"].items() if k not in drop}
    return out


def _equal_but_accuracy(got, want):
    g, w = got.to_json(), want.to_json()
    acc_g, acc_w = g.pop("accuracy"), w.pop("accuracy")
    assert g == w       # times, rounds, tiers, selections, stragglers, meta
    assert len(acc_g) == len(acc_w) > 0
    np.testing.assert_allclose(acc_g, acc_w, rtol=0, atol=1e-6)


# the reference runner, the port runner, FLConfig and call keywords
FEDASYNC_FL = dict(n_clients=8, n_tiers=4, tau=2, rounds=4, seed=3)
FEDDCT_FL = dict(n_clients=8, n_tiers=4, tau=2, rounds=6, mu=0.3, seed=5,
                 beta=1.1)
METHODS = {
    "fedasync-w0": (ref_baselines.run_fedasync, pt_baselines.run_fedasync,
                    FEDASYNC_FL, dict(window=0, eval_every=4)),
    "fedasync-w3": (ref_baselines.run_fedasync, pt_baselines.run_fedasync,
                    FEDASYNC_FL, dict(window=3, eval_every=4)),
    "fedasync-25s": (ref_baselines.run_fedasync, pt_baselines.run_fedasync,
                     FEDASYNC_FL, dict(window_secs=25.0, eval_every=4)),
    "fedbuff": (ref_baselines.run_fedbuff, pt_baselines.run_fedbuff,
                dict(n_clients=6, tau=2, rounds=4, seed=2),
                dict(window=2, eval_every=8)),
    "feddct_async": (ref_feddct_async, run_feddct_async, FEDDCT_FL, {}),
}


@pytest.mark.parametrize("engine", ["batched", "looped"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_synthetic_histories_equal_the_reference_on_both_paths(
        method, use_kernel, engine):
    ref_run, pt_run, fl_kw, kw = METHODS[method]
    kw = dict(kw, engine=engine, use_kernel_agg=use_kernel)
    ref_fl, pt_fl = FLConfig(**fl_kw), PtFLConfig(**fl_kw)
    runs = {}
    for use_store in (True, False):
        want = ref_run(RefSynthetic(), _net(WirelessNetwork, ref_fl),
                       ref_fl, use_store=use_store, **kw)
        got = pt_run(SyntheticCohortTrainer(device="cpu"),
                     _net(PtNetwork, pt_fl), pt_fl, use_store=use_store,
                     **kw)
        _equal_but_accuracy(got, want)
        runs[use_store] = got
    # in the port, the store path and the dict path agree bit for bit
    assert runs[True].meta["store_path"] == "store"
    assert runs[False].meta["store_path"] == "dict"
    assert runs[True].meta["kernel_agg"] is use_kernel
    assert _json(runs[True], STORE_KEYS) == _json(runs[False], STORE_KEYS)
    if method != "fedasync-w0":
        assert runs[True].meta["mean_cohort"] > 1.0


class _RefIntLeafTrainer(RefSynthetic):
    """A non-float leaf (a step counter) beside the float ones: it lives
    in the store's int32 sidecar."""

    def init_params(self, seed=0):
        return dict(super().init_params(seed),
                    step=jnp.zeros((), jnp.int32))

    def local_train(self, params, client_id, rnd_seed):
        step = params["step"]
        out, n = super().local_train(
            {k: v for k, v in params.items() if k != "step"}, client_id,
            rnd_seed)
        return dict(out, step=step + 1), n


class _IntLeafTrainer(SyntheticCohortTrainer):
    def init_params(self, seed=0):
        return dict(super().init_params(seed),
                    step=torch.zeros((), dtype=torch.int32))

    def local_train(self, params, client_id, rnd_seed):
        step = params["step"]
        out, n = super().local_train(
            {k: v for k, v in params.items() if k != "step"}, client_id,
            rnd_seed)
        return dict(out, step=step + 1), n


def test_int_leaf_template_runs_on_the_store_path():
    """Looped training (no cohort method) and an int32 sidecar leaf:
    the store path equals the dict path bit for bit and the reference
    in all but accuracy."""
    for cls in (_IntLeafTrainer, _RefIntLeafTrainer):
        cls.local_train_cohort = None
    try:
        fl_kw = dict(n_clients=4, tau=2, rounds=2, seed=7)
        ref_fl, pt_fl = FLConfig(**fl_kw), PtFLConfig(**fl_kw)
        runs = {}
        for use_store in (True, False):
            runs[use_store] = pt_baselines.run_fedbuff(
                _IntLeafTrainer(device="cpu"), _net(PtNetwork, pt_fl), pt_fl,
                window=2, eval_every=8, use_store=use_store,
                engine="looped")
            want = ref_baselines.run_fedbuff(
                _RefIntLeafTrainer(), _net(WirelessNetwork, ref_fl), ref_fl,
                window=2, eval_every=8, use_store=use_store,
                engine="looped")
            _equal_but_accuracy(runs[use_store], want)
        assert runs[True].meta["store_path"] == "store"
        assert _json(runs[True], STORE_KEYS) == _json(runs[False],
                                                      STORE_KEYS)
    finally:
        for cls in (_IntLeafTrainer, _RefIntLeafTrainer):
            del cls.local_train_cohort


@pytest.mark.parametrize("seed", [0, 1, 4])
@pytest.mark.parametrize("engine", ["batched", "looped"])
def test_fedasync_window0_equals_the_sequential_loop(seed, engine):
    fl = PtFLConfig(n_clients=6, n_tiers=3, tau=3, rounds=3, seed=seed)
    seq = pt_baselines.run_fedasync_sequential(
        SyntheticCohortTrainer(device="cpu"), _net(PtNetwork, fl), fl,
        eval_every=4, engine=engine)
    for use_store in (None, True):
        hist = pt_baselines.run_fedasync(
            SyntheticCohortTrainer(device="cpu"), _net(PtNetwork, fl), fl,
            window=0, eval_every=4, engine=engine, use_store=use_store)
        for field in ("rounds", "times", "accuracy", "n_selected"):
            assert getattr(hist, field) == getattr(seq, field)
    assert hist.rounds[-1] == fl.rounds * fl.tau        # terminal eval
    ref_fl = FLConfig(n_clients=6, n_tiers=3, tau=3, rounds=3, seed=seed)
    want = ref_baselines.run_fedasync_sequential(
        RefSynthetic(), _net(WirelessNetwork, ref_fl), ref_fl, eval_every=4,
        engine=engine)
    _equal_but_accuracy(seq, want)


def test_store_reason_records_resolved_path():
    fl = PtFLConfig(n_clients=6, tau=2, rounds=2, seed=6)

    def run(**kw):
        return pt_baselines.run_fedasync(SyntheticCohortTrainer(device="cpu"),
                                         _net(PtNetwork, fl), fl,
                                         eval_every=8, **kw).meta

    assert (run(window=0)["store_path"], run(window=0)["store_reason"]) \
        == ("dict", "window0-sequential")
    assert run(window=2, use_store=False)["store_reason"] == "forced-off"
    assert run(window=2)["store_reason"] == "auto-windowed"
    assert run(window=0, use_store=True)["store_reason"] == "forced-on"
    meta = run(window=2)
    assert meta["residency"] == "dense" and meta["hot_rows"] == 6
    assert meta["mesh_devices"] == 1 and meta["quant_bits"] == 32


def test_two_seeded_runs_are_identical_and_windows_batch():
    fl = PtFLConfig(n_clients=6, tau=3, rounds=4, seed=1)
    runner = AsyncRunner(SyntheticCohortTrainer(device="cpu"),
                         _net(PtNetwork, fl), fl, window_secs=30.0,
                         eval_every=5)
    a = runner.run()
    b = AsyncRunner(SyntheticCohortTrainer(device="cpu"), _net(PtNetwork, fl),
                    fl, window_secs=30.0, eval_every=5).run()
    assert a.to_json() == b.to_json()
    assert sum(runner.cohort_sizes) == fl.rounds * fl.tau
    assert max(runner.cohort_sizes) > 1
    assert a.rounds[-1] == fl.rounds * fl.tau
    assert a.times == sorted(a.times)


def test_feddct_async_carries_stragglers_instead_of_dropping():
    fl = PtFLConfig(**FEDDCT_FL)
    hist = run_feddct_async(SyntheticCohortTrainer(device="cpu"),
                            _net(PtNetwork, fl), fl)
    assert hist.rounds == list(range(1, 7))
    assert hist.times == sorted(hist.times)
    assert hist.meta["n_drains"] >= 1
    assert sum(hist.n_stragglers) >= 1


# ---------------------------------------------------------------------------
# one window step of the small CNN against the reference's
# ---------------------------------------------------------------------------

_CNN = {}


def _cnn_trainers():
    if not _CNN:
        kw = dict(n_clients=8, n_tiers=4, tau=2, rounds=2, seed=0,
                  primary_frac=0.7, lr=0.003)
        _CNN["ref"] = RefTrainer(get_arch("cnn-mnist").reduced(),
                                 FLConfig(**kw), "mnist", scale=0.01)
        _CNN["port"] = CNNTrainer(pt_get_arch("cnn-mnist").reduced(),
                                  PtFLConfig(**kw), "mnist", scale=0.01,
                                  device="cpu")
    return _CNN["ref"], _CNN["port"]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_cnn_train_window_from_bridged_params_matches_reference(use_kernel):
    ref, port = _cnn_trainers()
    g_ref = ref.init_params(0)
    s_ref = ref.init_params(1)
    g_np, s_np = jax.device_get(g_ref), jax.device_get(s_ref)
    ids, seeds, alphas = [0, 3, 5], [11, 22, 33], [0.6, 0.3, 0.45]

    ref_store = RefStore(g_ref, 8)
    ref_store.scatter_params([3], s_ref)
    want, _ = ref_make_engine(ref, use_kernel_agg=use_kernel,
                              interpret=True).train_window(
        ref_store, g_ref, ids, seeds, alphas)

    g_pt = bridge.from_reference(g_np, "cpu")
    store = ClientStateStore(g_pt, 8)
    store.scatter_params([3], bridge.from_reference(s_np, "cpu"))
    got, _ = make_engine(port, use_kernel_agg=use_kernel).train_window(
        store, g_pt, ids, seeds, alphas)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    for c in ids:
        for a, b in zip(tree_leaves(store.gather_one(c)), tree_leaves(got)):
            assert torch.equal(a, b)


def test_cnn_feddct_async_store_equals_dict_and_reruns_identically():
    _, port = _cnn_trainers()
    fl = dataclasses.replace(port.fl, rounds=2)
    store = run_feddct_async(port, _net(PtNetwork, fl), fl)
    again = run_feddct_async(port, _net(PtNetwork, fl), fl)
    on_dict = run_feddct_async(port, _net(PtNetwork, fl), fl,
                               use_store=False)
    assert again.to_json() == store.to_json()
    assert _json(store, STORE_KEYS) == _json(on_dict, STORE_KEYS)
    assert store.meta["n_drains"] >= 1
    assert all(0.0 <= a <= 1.0 for a in store.accuracy)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "cnn-mnist", "--rounds", "2", "--clients", "4", "--tiers",
       "2", "--tau", "2", "--device", "cpu", "--scale", "0.01"]


def test_cli_runs_feddct_async_on_cpu_and_writes_the_history(tmp_path,
                                                             capsys):
    out = tmp_path / "h.json"
    hist = fl_train.main(CLI + ["--method", "feddct_async", "--out",
                                str(out)])
    from repro_torch.fl.metrics import RunHistory
    assert RunHistory.load(str(out)).to_json() == hist.to_json()
    assert hist.meta["store_path"] == "store"
    assert hist.meta["kernel_agg"] is False and len(hist.rounds) == 2
    assert "[fl_train] feddct_async on cnn-mnist" in capsys.readouterr().out


def test_cli_fedbuff_store_and_no_store_print_the_same_lines(capsys):
    # 3 rounds of tau 2: three windows of 2 updates, one evaluation line
    argv = CLI + ["--method", "fedbuff", "--window", "2", "--rounds", "3"]
    store = fl_train.main(argv)
    store_out = capsys.readouterr().out
    on_dict = fl_train.main(argv + ["--no-store"])
    dict_out = capsys.readouterr().out
    assert store.meta["store_path"] == "store"
    assert on_dict.meta["store_path"] == "dict"
    assert store_out == dict_out and "[fedbuff] u=" in store_out
    assert store.meta["window"] == 2


@pytest.mark.parametrize("method", ["fedasync", "fedbuff", "feddct_async"])
def test_cli_async_methods_raise_without_a_cuda_device(method):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fl_train.main(["--method", method, "--rounds", "1", "--clients",
                       "2"])
