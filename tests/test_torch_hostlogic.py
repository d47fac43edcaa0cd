"""The port's copies of the framework-free host logic equal the
originals exactly: same source (up to the package name) and the same
outputs on seeded sweeps."""

import dataclasses
import hashlib
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.config as ref_config
import repro.core.selection as ref_selection
import repro.data as ref_data
import repro.fl.metrics as ref_metrics
import repro.fl.network as ref_network
import repro_torch.config as pt_config
import repro_torch.core.selection as pt_selection
import repro_torch.data as pt_data
import repro_torch.fl.metrics as pt_metrics
import repro_torch.fl.network as pt_network

torch.set_num_threads(1)

# ``repro.core`` exports a function named ``tiering`` over the submodule
ref_tiering = importlib.import_module("repro.core.tiering")
pt_tiering = importlib.import_module("repro_torch.core.tiering")

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED = ["config/base.py", "config/__init__.py", "configs/paper_models.py",
          "configs/llama3_2_1b.py", "configs/hymba_1_5b.py",
          "configs/granite_20b.py", "configs/nemotron_4_340b.py",
          "configs/phi4_mini_3_8b.py", "configs/mixtral_8x7b.py",
          "configs/arctic_480b.py", "configs/hubert_xlarge.py",
          "configs/chameleon_34b.py", "configs/shapes.py",
          "core/tiering.py", "core/selection.py", "fl/network.py",
          "fl/metrics.py", "data/synthetic.py", "data/partition.py",
          "data/pipeline.py", "data/__init__.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_source_is_the_original(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port.replace("repro_torch", "repro") == ref


def test_input_shapes_reexport_is_the_originals():
    """``configs.INPUT_SHAPES`` (through ``configs/shapes.py``) names
    the same shapes in both packages."""
    import repro.configs as ref_configs
    import repro_torch.configs as pt_configs
    from repro_torch.config.base import INPUT_SHAPES
    assert pt_configs.INPUT_SHAPES is INPUT_SHAPES
    assert {k: dataclasses.asdict(v)
            for k, v in pt_configs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v)
         for k, v in ref_configs.INPUT_SHAPES.items()}


@pytest.mark.parametrize("mu", [0.0, 0.3])
@pytest.mark.parametrize("seed", [0, 5])
def test_wireless_delays_bit_for_bit(mu, seed):
    args = (20, (5.0, 10.0, 15.0, 20.0, 25.0), 2.0, mu, (30.0, 60.0), seed)
    ref, port = ref_network.WirelessNetwork(*args), \
        pt_network.WirelessNetwork(*args)
    clients = list(range(20))
    for rnd in (0, 1, 7, 123):
        for attempt in (0, 2):
            a = ref.delays(clients, rnd, attempt)
            b = port.delays(clients, rnd, attempt)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ref.delay(3, 4) == port.delay(3, 4)
    assert ref.expected_mean(7) == port.expected_mean(7)


def test_pcg64_batched_seeding_matches():
    seeds = np.arange(0, 4000, 37, dtype=np.uint64)
    assert ref_network._pcg64_states(seeds) == pt_network._pcg64_states(seeds)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiering_and_cstt_match(seed):
    rng = np.random.default_rng(seed)
    at = {c: float(t) for c, t in enumerate(rng.uniform(3, 40, 23))}
    ct = {c: int(k) for c, k in enumerate(rng.integers(0, 6, 23))}
    tiers_ref, tiers_pt = ref_tiering.tiering(at, 5), pt_tiering.tiering(at, 5)
    assert tiers_ref == tiers_pt
    assert ref_tiering.update_avg_time(9.5, 3, 12.25) == \
        pt_tiering.update_avg_time(9.5, 3, 12.25)
    for t_ptr, v_prev, v_now in [(1, 0.1, 0.2), (3, 0.5, 0.4), (5, 0.3, 0.3)]:
        out_ref = ref_selection.cstt(t_ptr, v_prev, v_now, tiers_ref, at, ct,
                                     3, 1.2, 30.0,
                                     np.random.default_rng(seed + 7))
        out_pt = pt_selection.cstt(t_ptr, v_prev, v_now, tiers_pt, at, ct,
                                   3, 1.2, 30.0,
                                   np.random.default_rng(seed + 7))
        assert out_ref == out_pt


def test_evaluate_client_matches():
    args = (10, (5.0, 10.0, 15.0, 20.0, 25.0), 2.0, 0.2, (30.0, 60.0), 1)
    ref, port = ref_network.WirelessNetwork(*args), \
        pt_network.WirelessNetwork(*args)
    for c in range(10):
        assert ref_tiering.evaluate_client(ref, c, 2, 2, 30.0) == \
            pt_tiering.evaluate_client(port, c, 2, 2, 30.0)


def _digest(d):
    h = hashlib.sha256()
    for k in sorted(d):
        v = np.asarray(d[k])
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(v.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["mnist", "fmnist", "cifar10"])
def test_image_dataset_digest_matches(name):
    a = ref_data.make_image_dataset(name, seed=3, scale=0.002)
    b = pt_data.make_image_dataset(name, seed=3, scale=0.002)
    assert _digest(a) == _digest(b)


def test_partition_and_batches_match():
    data = pt_data.make_image_dataset("mnist", seed=0, scale=0.005)
    y = data["y_train"]
    for frac in (0.0, 0.7):
        pa = ref_data.primary_class_partition(y, 6, frac, seed=2)
        pb = pt_data.primary_class_partition(y, 6, frac, seed=2)
        assert len(pa) == len(pb)
        for a, b in zip(pa, pb):
            np.testing.assert_array_equal(a, b)
    part = pb[0]
    ds_ref = ref_data.ClientDataset(data["x_train"][part], y[part])
    ds_pt = pt_data.ClientDataset(data["x_train"][part], y[part])
    got = list(pt_data.client_batches(ds_pt, 10, 131 * 4 + 1))
    want = list(ref_data.client_batches(ds_ref, 10, 131 * 4 + 1))
    assert len(got) == len(want) > 0
    for (xa, ya), (xb, yb) in zip(got, want):
        assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()


def test_run_history_json_matches_and_round_trips():
    def fill(cls):
        h = cls(method="feddct", arch="cnn-mnist", meta={"mu": 0.1})
        h.record(time=1.5, rnd=1, acc=0.25, tier=2, n_selected=5,
                 n_stragglers=1)
        h.record(time=3.0, rnd=2, acc=0.5)
        return h
    a, b = fill(ref_metrics.RunHistory), fill(pt_metrics.RunHistory)
    assert a.to_json() == b.to_json()
    assert pt_metrics.RunHistory.from_json(b.to_json()).to_json() == \
        b.to_json()
    assert ref_metrics.RunHistory.from_json(b.to_json()).to_json() == \
        a.to_json()
    with pytest.raises(ValueError):
        pt_metrics.RunHistory.from_json({"schema_version": 99,
                                         "method": "x", "arch": "y"})


@pytest.mark.parametrize("arch", ["cnn-mnist", "cnn-fmnist",
                                  "resnet8-cifar10", "llama3.2-1b",
                                  "hymba-1.5b", "granite-20b",
                                  "nemotron-4-340b", "phi4-mini-3.8b",
                                  "mixtral-8x7b", "arctic-480b",
                                  "xlstm-350m", "hubert-xlarge",
                                  "chameleon-34b"])
def test_arch_configs_match(arch):
    a, b = ref_config.get_arch(arch), pt_config.get_arch(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())


def test_fl_config_defaults_match_and_port_registers_cnn_family_only():
    assert dataclasses.asdict(ref_config.FLConfig()) == \
        dataclasses.asdict(pt_config.FLConfig())
    # the CNN family and the LM configs of the dense, hybrid, MoE,
    # xLSTM, audio and VLM families: every arch of the reference
    assert pt_config.list_archs() == ["arctic-480b", "chameleon-34b",
                                      "cnn-fmnist", "cnn-mnist",
                                      "granite-20b", "hubert-xlarge",
                                      "hymba-1.5b", "llama3.2-1b",
                                      "mixtral-8x7b", "nemotron-4-340b",
                                      "phi4-mini-3.8b", "resnet8-cifar10",
                                      "xlstm-350m"]


# The public constructors of model state: ``cuda`` by default, the CPU
# only on request (``repro_torch.resolve_device``).
def _init_cnn(**kw):
    from repro_torch.models.cnn import init_cnn
    return init_cnn(pt_config.get_arch("cnn-mnist"),
                    torch.Generator().manual_seed(3), **kw)


def _init_kv_cache(**kw):
    from repro_torch.models.attention import init_kv_cache
    return init_kv_cache(2, 5, 3, 8, dtype=torch.float32, **kw)


def _init_ssm_state(**kw):
    from repro_torch.models.ssm import init_ssm_state
    return init_ssm_state(2, 8, 4, 2, 4, dtype=torch.float32, **kw)


_STATE_INITS = {"init_cnn": _init_cnn, "init_kv_cache": _init_kv_cache,
                "init_ssm_state": _init_ssm_state}


@pytest.mark.parametrize("name", sorted(_STATE_INITS))
def test_state_init_defaults_to_cuda_and_raises_without_one(name,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _STATE_INITS[name]()


@pytest.mark.parametrize("name", sorted(_STATE_INITS))
def test_state_init_on_request_is_the_cpu_state(name):
    from repro_torch.tree import tree_leaves
    got = _STATE_INITS[name](device="cpu")
    again = _STATE_INITS[name](device=torch.device("cpu"))
    leaves = tree_leaves(got)
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    assert all(torch.equal(a, b) for a, b in zip(leaves, tree_leaves(again)))
    if name == "init_kv_cache":
        assert not bool(got["k"].any()) and not bool(got["v"].any())
        assert got["pos"].tolist() == [-1] * 5
        assert got["pos"].dtype == torch.int32
    elif name == "init_ssm_state":
        assert tuple(got["h"].shape) == (2, 16, 4)
        assert tuple(got["conv"].shape) == (2, 3, 16)
        assert got["h"].dtype == torch.float32
        assert not bool(got["h"].any()) and not bool(got["conv"].any())
    else:
        # the same draw as the reference's shapes, in f32
        assert all(t.dtype == torch.float32 for t in leaves)
        assert sum(t.numel() for t in leaves) == 1_630_090
