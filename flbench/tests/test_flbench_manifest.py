"""``BENCHMARK.json`` and the harness's imports.

* What ``flbench`` runs imports neither JAX nor the JAX package
  (``repro``), by top-level module name, and the reference imports
  nothing of the program either; a run leaves none of them loaded.
* The manifest keeps the contract's names, units and keys, and every
  cell finds its configuration, traffic mix and metric readers by name.
* A cell defined only by new files (a configuration, a mix, a metric
  reader and an entry) runs without a change to any file of the
  harness.
"""

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from flbench import bench
from flbench.tests.conftest import ROOT, make_root

FLBENCH = ROOT / "flbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names of the modules a source file imports (relative
    imports resolve inside ``flbench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("flbench" if node.level else node.module.split(".")[0])
    return out


def _sources(sub=""):
    return sorted((FLBENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(FLBENCH)))
def test_no_jax_or_jax_package(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "contextlib", "heapq", "math", "typing",
               "numpy", "torch", "flbench"}
    names = _imports(path)
    assert names <= allowed
    text = path.read_text()
    assert "repro_torch" not in text
    assert all(m.startswith("flbench.reference") for m in re.findall(
        r"from (flbench[\w.]*) import", text))


def test_a_run_leaves_no_jax_loaded(tmp_path):
    """A whole run in a fresh interpreter: nothing of JAX is loaded at
    its end (the check ``run.py`` makes before it prints)."""
    root = make_root(tmp_path)
    code = (
        "import sys, time, torch\n"
        "from pathlib import Path\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from flbench import run\n"
        f"run.execute(Path({str(root)!r}), 'tiny.async', 1, 0.5, True,\n"
        "            torch.device('cpu'), time.perf_counter())\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_names_and_units():
    man = _manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["flbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in man["command"])
    assert 1 <= man["run_seconds"] <= 51
    names = [c["name"] for c in man["configs"]] + [
        w["name"] for w in man["workloads"]] + [
        m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
        assert set(m.get("workloads", cells)) <= cells
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    assert {"setup_s", "samples_per_s", "peak_mem_gb"} == {
        m["name"] for m in man["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in _manifest()[
    "workloads"]])
def test_every_cell_resolves_its_files(cell):
    c = bench.resolve_cell(ROOT, cell)
    assert c["config"]["name"] == next(
        w["config"] for w in _manifest()["workloads"] if w["name"] == cell)
    assert c["readers"] and all(p.is_file() for p in c["readers"].values())
    for key in ("method", "clients", "samples_per_client", "limits",
                "check", "trace", "warmup_rounds"):
        assert key in c["traffic"]


def test_a_cell_of_new_files_runs(tmp_path):
    """A configuration of a new model family, a mix of a new method, the
    family's and the method's modules, a metric reader and a manifest
    entry, all new files: the harness runs the cell and reports the new
    metric."""
    root = make_root(tmp_path, cells={})
    for kind, old, new in (("families", "cnn", "cnn_copy"),
                           ("methods", "feddct", "feddct_copy")):
        (root / "flbench" / kind / f"{new}.py").write_text(
            (ROOT / "flbench" / kind / f"{old}.py").read_text())
    cfg = json.loads((ROOT / "flbench" / "configs" / "cnn-mnist.json")
                     .read_text())
    cfg["name"], cfg["family"] = "cnn-mnist-copy", "cnn_copy"
    (root / "flbench" / "configs" / "cnn-mnist-copy.json").write_text(
        json.dumps(cfg))
    tr = json.loads((ROOT / "flbench" / "traffic" / "sync.c1000.s60.json")
                    .read_text())
    tr.update(clients=6, tiers=2, tau=3, samples_per_client=20,
              test_samples=32, check=dict(tr["check"], every=1),
              method="feddct_copy")
    (root / "flbench" / "traffic" / "sync.c6.s20.json").write_text(
        json.dumps(tr))
    (root / "flbench" / "metrics" / "rounds_seen.py").write_text(
        "def read(trace):\n    return float(len(trace.rounds))\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "cnn-mnist-copy", "source": "x",
                           "file": "flbench/configs/cnn-mnist-copy.json",
                           "reduced": [], "why": "test"})
    man["workloads"] = [{"name": "copy.sync", "config": "cnn-mnist-copy",
                         "traffic": "sync.c6.s20", "chips": 1,
                         "why": "test"}]
    man["per_layer"].append({"name": "rounds_seen", "unit": "rounds",
                             "better": "higher", "source": "program_span",
                             "layer": "scheduler", "moves": "samples_per_s",
                             "workloads": ["copy.sync"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    from flbench.run import execute
    res = execute(root, "copy.sync", 4, 0.5, True, torch.device("cpu"),
                  time.perf_counter())
    assert res["metrics"]["rounds_seen"]["value"] >= 1
    cell = bench.resolve_cell(root, "copy.sync")
    assert cell["method"].__file__.startswith(str(root))
    assert cell["family"].__file__.startswith(str(root))
    # a traced run judges the rounds after the profiled ones, which a
    # short window on a busy CPU may not reach: correctness untraced
    res = execute(root, "copy.sync", 4, 0.5, False, torch.device("cpu"),
                  time.perf_counter())
    assert res["correct"], res["checks"]
