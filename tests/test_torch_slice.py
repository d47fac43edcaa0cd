"""The sync slice of the port as a whole, against the JAX package:
schedulers with the synthetic trainer (whole histories), the engine's
round with the small CNN (within tolerance), and the port's own
identities."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.config.base import FLConfig
from repro.core import baselines as ref_baselines
from repro.core.engine import make_engine as ref_make_engine
from repro.core.scheduler import run_feddct as ref_run_feddct
from repro.fl.client import CNNTrainer as RefTrainer
from repro.fl.network import WirelessNetwork
from repro.fl.testing import SyntheticCohortTrainer as RefSynthetic
from repro_torch import bridge
from repro_torch.config import get_arch as pt_get_arch
from repro_torch.config.base import FLConfig as PtFLConfig
from repro_torch.core import baselines as pt_baselines
from repro_torch.core.engine import BatchedClientEngine, make_engine
from repro_torch.core.scheduler import run_feddct
from repro_torch.fl.client import CNNTrainer
from repro_torch.fl.network import WirelessNetwork as PtNetwork
from repro_torch.fl.testing import SyntheticCohortTrainer
from repro_torch.launch import fl_train
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

FL_KW = dict(n_clients=8, n_tiers=4, tau=2, rounds=3, primary_frac=0.7,
             lr=0.003)


def _net(cls, fl):
    return cls(fl.n_clients, fl.tier_delay_means, fl.delay_std, fl.mu,
               fl.failure_delay, fl.seed)


RUNNERS = {
    "feddct": (ref_run_feddct, run_feddct),
    "fedavg": (ref_baselines.run_fedavg, pt_baselines.run_fedavg),
    "tifl": (ref_baselines.run_tifl, pt_baselines.run_tifl),
    "fedprox": (ref_baselines.run_fedprox, pt_baselines.run_fedprox),
}


@pytest.mark.parametrize("engine", ["batched", "looped"])
@pytest.mark.parametrize("mu,seed", [(0.0, 0), (0.3, 1)])
@pytest.mark.parametrize("method", sorted(RUNNERS))
def test_synthetic_histories_equal_the_reference(method, mu, seed, engine):
    kw = dict(FL_KW, rounds=6, mu=mu, seed=seed)
    ref_fl, pt_fl = FLConfig(**kw), PtFLConfig(**kw)
    ref_run, pt_run = RUNNERS[method]
    want = ref_run(RefSynthetic(), _net(WirelessNetwork, ref_fl), ref_fl,
                   engine=engine)
    got = pt_run(SyntheticCohortTrainer(device="cpu"), _net(PtNetwork, pt_fl),
                 pt_fl, engine=engine)
    w, g = want.to_json(), got.to_json()
    acc_w, acc_g = w.pop("accuracy"), g.pop("accuracy")
    assert g == w               # times, rounds, tiers, selections, meta
    assert len(acc_g) == len(acc_w) > 0
    np.testing.assert_allclose(acc_g, acc_w, rtol=0, atol=1e-6)


def test_run_method_dispatch_and_later_slice_names():
    fl = PtFLConfig(**dict(FL_KW, rounds=2))
    for name in ("feddct", "fedavg", "tifl", "fedprox", "fedasync",
                 "fedbuff", "feddct_async"):
        hist = pt_baselines.run_method(name,
                                       SyntheticCohortTrainer(device="cpu"),
                                       _net(PtNetwork, fl), fl)
        assert hist.method == name and hist.accuracy
    # int8 rows and tiered residency run on every async method; a
    # tiered run's history equals the dense one's
    for name in ("fedasync", "fedbuff", "feddct_async"):
        hist = pt_baselines.run_method(name,
                                       SyntheticCohortTrainer(device="cpu"),
                                       _net(PtNetwork, fl), fl,
                                       use_store=True, quant_bits=8)
        assert hist.meta["quant_bits"] == 8 and hist.accuracy
        dense, tiered = (pt_baselines.run_method(
            name, SyntheticCohortTrainer(device="cpu"), _net(PtNetwork, fl),
            fl, use_store=True, **kw) for kw in ({}, {"store_capacity": 2}))
        assert tiered.meta["residency"] == "tiered-host"
        assert tiered.meta["hot_rows"] == 2
        assert dense.meta["residency"] == "dense"
        for key in ("rounds", "times", "accuracy", "n_selected",
                    "n_stragglers"):
            assert getattr(tiered, key) == getattr(dense, key), (name, key)


_TRAINERS = {}


def _cnn_trainers(seed=0):
    if seed not in _TRAINERS:
        kw = dict(FL_KW, seed=seed)
        ref = RefTrainer(get_arch("cnn-mnist").reduced(), FLConfig(**kw),
                         "mnist", scale=0.01)
        port = CNNTrainer(pt_get_arch("cnn-mnist").reduced(),
                          PtFLConfig(**kw), "mnist", scale=0.01,
                          device="cpu")
        _TRAINERS[seed] = (ref, port)
    return _TRAINERS[seed]


@pytest.mark.parametrize("use_kernel_agg", [False, True])
def test_train_round_from_bridged_params_matches_reference(use_kernel_agg):
    ref, port = _cnn_trainers()
    p_ref = ref.init_params(0)
    p_pt = bridge.from_reference(jax.device_get(p_ref), "cpu")
    cohort = [0, 3, 5]                    # padded to 4 inside the engine
    want = ref_make_engine(ref, use_kernel_agg=use_kernel_agg,
                           interpret=True).train_round(p_ref, cohort, 2)
    got = make_engine(port, use_kernel_agg=use_kernel_agg).train_round(
        p_pt, cohort, 2)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_batched_round_equals_looped_round_in_port():
    _, port = _cnn_trainers()
    params = port.init_params(1)
    a = make_engine(port, engine="batched").train_round(params, [1, 2, 6], 4)
    b = make_engine(port, engine="looped").train_round(params, [1, 2, 6], 4)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_padded_cohort_equals_unpadded_cohort():
    _, port = _cnn_trainers()
    params = port.init_params(1)
    padded = BatchedClientEngine(port).train_round(params, [1, 2, 6], 4)
    plain = BatchedClientEngine(port, pad_cohorts=False).train_round(
        params, [1, 2, 6], 4)
    for x, y in zip(tree_leaves(padded), tree_leaves(plain)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_all_straggler_round_returns_params_untouched():
    _, port = _cnn_trainers()
    eng = make_engine(port)
    params = port.init_params(0)
    assert eng.train_round(params, [], 1) is params
    stacked, sizes = eng.train_clients(params, [], 1)
    assert stacked is None and sizes.shape == (0,)
    kept = eng.train_round(params, [0, 1], 1, weights=[0.0, 0.0])
    for a, b in zip(tree_leaves(kept), tree_leaves(params)):
        assert torch.equal(a, b)


def test_kernel_agg_resolves_from_the_device_and_lands_in_meta():
    _, port = _cnn_trainers()
    assert make_engine(port).use_kernel_agg is False       # CPU trainer
    assert make_engine(port, use_kernel_agg=True).use_kernel_agg is True
    fl = dataclasses.replace(port.fl, rounds=1)
    net = _net(PtNetwork, fl)
    assert run_feddct(port, net, fl).meta["kernel_agg"] is False
    assert run_feddct(port, net, fl,
                      use_kernel_agg=True).meta["kernel_agg"] is True
    with pytest.raises(ValueError):
        make_engine(port, engine="sharded")


def test_cnn_feddct_trace_matches_reference_and_reruns_identically():
    ref, port = _cnn_trainers()
    want = ref_run_feddct(ref, _net(WirelessNetwork, ref.fl), ref.fl)
    got = run_feddct(port, _net(PtNetwork, port.fl), port.fl)
    again = run_feddct(port, _net(PtNetwork, port.fl), port.fl)
    assert again.to_json() == got.to_json()
    # the two start from different random models (JAX's and torch's
    # generators differ), so only what precedes the first accuracy
    # feedback is common: the first round's clock, cohort and stragglers
    assert got.times[0] == want.times[0]
    assert got.n_selected[0] == want.n_selected[0]
    assert got.n_stragglers[0] == want.n_stragglers[0]
    assert len(got.rounds) == len(want.rounds) == port.fl.rounds
    assert all(0.0 <= a <= 1.0 for a in got.accuracy)


def test_cli_runs_on_cpu_and_writes_the_history(tmp_path, capsys):
    out = tmp_path / "h.json"
    hist = fl_train.main(["--arch", "cnn-mnist", "--method", "feddct",
                          "--rounds", "2", "--clients", "4", "--tiers", "2",
                          "--tau", "1", "--device", "cpu", "--scale", "0.01",
                          "--out", str(out)])
    from repro_torch.fl.metrics import RunHistory
    assert RunHistory.load(str(out)).to_json() == hist.to_json()
    assert hist.meta["kernel_agg"] is False and len(hist.rounds) == 2
    assert "[fl_train] feddct on cnn-mnist" in capsys.readouterr().out


def test_cli_raises_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fl_train.main(["--rounds", "1", "--clients", "2"])


@pytest.mark.parametrize("cold", ["host", "disk"])
def test_cli_tiered_residency_prints_the_dense_lines(tmp_path, capsys,
                                                     cold):
    """``--hot-rows 2`` (with ``--cold-dir``: the disk tier) runs on the
    CPU and prints the dense run's lines."""
    argv = ["--method", "fedbuff", "--window", "2", "--rounds", "2",
            "--clients", "4", "--tau", "2", "--device", "cpu", "--scale",
            "0.005"]
    dense = fl_train.main(argv)
    want = capsys.readouterr().out
    extra = ["--hot-rows", "2"]
    if cold == "disk":
        extra += ["--cold-dir", str(tmp_path / "cold")]
    tiered = fl_train.main(argv + extra)
    assert capsys.readouterr().out == want
    assert tiered.meta["residency"] == f"tiered-{cold}"
    assert tiered.meta["hot_rows"] == 2
    assert dense.meta["residency"] == "dense"
    assert tiered.meta["store_bytes_cold"] > 0


def test_synthetic_trainer_defaults_to_the_card():
    """``SyntheticCohortTrainer`` is an entry point like the others: it
    runs on the CUDA device unless given ``device="cpu"``."""
    assert SyntheticCohortTrainer(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert SyntheticCohortTrainer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SyntheticCohortTrainer()
        with pytest.raises(RuntimeError, match="CUDA"):
            SyntheticCohortTrainer.many_leaf(n_leaves=2, leaf=4)


# -- the port stands alone ---------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)(\s|\.|,|$)|from\s+(jax|repro)(\s|\.))",
    re.MULTILINE)


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) > 20
    names = {p.relative_to(ROOT / "src").as_posix() for p in files[:-1]}
    for mod in ("catalogue", "telemetry", "flstats", "export", "validate",
                "report", "__init__"):
        assert f"repro_torch/obs/{mod}.py" in names, mod
    assert "repro_torch/kernels/ref.py" in names
    assert "repro_torch/models/xlstm.py" in names
    for mod in ("core/residency.py", "checkpoint/ckpt.py",
                "checkpoint/__init__.py"):
        assert f"repro_torch/{mod}" in names, mod
    for path in files:
        hit = _FORBIDDEN.search(path.read_text())
        assert hit is None, f"{path}: {hit.group(0)!r}"
    # the pattern does see what it is meant to see
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "import repro", "from repro import obs",
                 "from repro.core import x", "    import repro.configs"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x"):
        assert not _FORBIDDEN.search(line), line


def test_the_port_calls_no_library_attention_kernel():
    """``scaled_dot_product_attention`` (and cuDNN's or PyTorch's other
    fused attention) is chip_smoke.py's yardstick only: no module of the
    port calls it."""
    pattern = re.compile(r"scaled_dot_product_attention|_flash_attention_"
                         r"forward|_efficient_attention|cudnn_attention")
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        hit = pattern.search(path.read_text())
        assert hit is None, f"{path}: {hit.group(0)!r}"
    assert pattern.search((ROOT / "chip_smoke.py").read_text())


def test_importing_the_port_leaves_jax_unloaded():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "src",
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")
