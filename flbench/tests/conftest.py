"""Shared set-up of the benchmark's tests: the repository's ``src`` and
root on the path, the ``card`` marker, and a tiny cell of each mix."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


# the tiny version of each mix: 8 clients in 2 tiers of 4, all of a
# tier selected, 20 samples each
TINY = {"clients": 8, "tiers": 2, "tau": 4, "samples_per_client": 20,
        "test_samples": 64}
TINY_CELLS = {"tiny.sync": ("cnn-mnist", "sync.c1000.s60"),
              "tiny.resnet": ("resnet8-cifar10", "sync.c1000.s50"),
              "tiny.async": ("cnn-mnist", "async.c2000.s30")}
# limits of a tiny cell that differ from its repository mix's: ResNet8's
# merged model against the reference's merge (``agg_gap``) reads 0.019-0.068
# on the CPU over 10-30 judged rounds of 2-4 updates (seeds 3, 5, 7, 11, 13,
# 2**31 + 11), where no wide cohort averages a row's drift down as the
# cell's 50-300 updates do on the card (<= 0.0072 there); the TF32 control
# reads 0.19-0.23 at this size
TINY_LIMITS = {"tiny.resnet": {"agg_gap": 0.12}}


def make_root(tmp: Path, cells=TINY_CELLS, rows: int = 8) -> Path:
    """A checkout-like root holding the repository's manifest with
    ``cells`` in place of its workloads: each a tiny copy of a
    repository mix (every sampled client judged) on a repository
    configuration."""
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "flbench" / "traffic").mkdir(parents=True)
    shutil.copytree(ROOT / "flbench" / "configs", tmp / "flbench" / "configs")
    for sub in ("metrics", "methods", "families"):
        shutil.copytree(ROOT / "flbench" / sub, tmp / "flbench" / sub)
    man["workloads"] = []
    for name, (config, mix) in cells.items():
        tr = json.loads((ROOT / "flbench" / "traffic" / f"{mix}.json")
                        .read_text())
        tr.update(TINY)
        tr["limits"].update(TINY_LIMITS.get(name, {}))
        tr["check"] = dict(tr["check"], every=1, rows=rows)
        tr["trace"] = {"profile_rounds": 2}
        (tmp / "flbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(tr))
        man["workloads"].append({"name": name, "config": config,
                                 "traffic": name, "chips": 1, "why": "test"})
    for m in man["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
