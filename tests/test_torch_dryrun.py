"""The port's compiler-free dry run (``launch/dryrun.py``) against the
JAX package's: the sweep of ``ASSIGNED`` x ``INPUT_SHAPES`` x {single,
multi} gives 80 records, ``ok`` (each with its roofline on the H100) or
the reference's skip, and the bytes a device holds equal those computed
here from the reference's own spec trees over its ``eval_shape``
shapes.

The reference's ``launch/dryrun.py`` forces 512 host devices when it is
imported; the test swaps that call out before importing it, so the
worker's jax keeps its one device.
"""

import json

import numpy as np
import pytest
from jax.sharding import PartitionSpec as RefP

from repro.config import get_arch as ref_get_arch
from repro.config.base import INPUT_SHAPES as REF_SHAPES
from repro.launch import steps as ref_steps
from repro.sharding import rules as ref_rules
from repro_torch.config import get_arch
from repro_torch.config.base import INPUT_SHAPES
from repro_torch.launch import dryrun

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def ref_dryrun():
    mp = pytest.MonkeyPatch()
    import repro.distributed.hostdevices as hd
    mp.setattr(hd, "ensure_host_device_count", lambda n, env=None: n)
    import repro.launch.dryrun as ref
    yield ref
    mp.undo()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    assert dryrun.main(["--all", "--mesh", "both", "--out", str(out)]) == 0
    return {(r["arch"], r["shape"], r["mesh"]): r
            for r in (json.loads(p.read_text()) for p in out.glob("*.json"))}


def fake_mesh(shape, names):
    class FakeMesh:
        axis_names = names

        class devices:
            pass
    FakeMesh.devices.shape = shape
    return FakeMesh()


def _ref_bytes(tree, specs, sizes):
    leaves = __import__("jax").tree_util.tree_leaves(tree)
    spec_leaves = __import__("jax").tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, RefP))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for i, entry in enumerate(tuple(spec)):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            n = int(np.prod([sizes[a] for a in names]))
            assert shape[i] % n == 0
            shape[i] //= n
        total += int(np.prod(shape, dtype=np.int64)) * leaf.dtype.itemsize
    return total


def test_copies_of_the_reference_are_equal(ref_dryrun):
    assert dryrun.ASSIGNED == ref_dryrun.ASSIGNED
    assert dryrun.BASELINE_TCFG.__dict__ == ref_dryrun.BASELINE_TCFG.__dict__
    for arch in dryrun.ASSIGNED:
        for name in INPUT_SHAPES:
            assert dryrun.skip_reason(get_arch(arch), INPUT_SHAPES[name]) \
                == ref_dryrun.skip_reason(ref_get_arch(arch),
                                          REF_SHAPES[name])
            assert dryrun.variant_note(get_arch(arch), INPUT_SHAPES[name],
                                       dryrun.BASELINE_TCFG) == \
                ref_dryrun.variant_note(ref_get_arch(arch), REF_SHAPES[name],
                                        ref_dryrun.BASELINE_TCFG)


def test_sweep_gives_80_records_ok_or_the_reference_skip(records,
                                                         ref_dryrun):
    assert len(records) == 80
    status = [r["status"] for r in records.values()]
    assert status.count("error") == 0
    skipped = sorted(k for k, r in records.items()
                     if r["status"] == "skipped")
    assert skipped == sorted((a, s, m) for a in ["hubert-xlarge"]
                             for s in ("decode_32k", "long_500k")
                             for m in MESHES)
    for (arch, shape, _), r in records.items():
        if r["status"] == "skipped":
            assert r["reason"] == ref_dryrun.skip_reason(
                ref_get_arch(arch), REF_SHAPES[shape])
        else:
            # the roofline, on H100_SXM, with the reference's keys
            roof = r["roofline"]
            assert set(roof) == {"compute_s", "memory_s", "collective_s",
                                 "dominant", "bound_s", "model_flops_global",
                                 "hlo_flops_global", "useful_ratio"}
            assert r["roofline_hw"] == "h100-sxm5-80gb"
            assert "no SPMD partitioner" in r["roofline_basis"]
            assert roof["collective_s"] == 0.0
            assert roof["bound_s"] == roof[roof["dominant"]] > 0
            assert roof["model_flops_global"] == r["model_flops"]
            assert "roofline" not in r["not_measured"]
            assert "collectives" in r["not_measured"]
            assert r["model_flops"] == ref_steps.model_flops(
                ref_get_arch(arch), REF_SHAPES[shape])
            n_chips = 512 if r["mesh"] == "2x16x16" else 256
            assert r["model_flops_per_chip"] == r["model_flops"] / n_chips
            # per chip: the global count over the chips
            assert roof["compute_s"] == pytest.approx(
                roof["hlo_flops_global"] / (n_chips * 989e12), rel=1e-12)


@pytest.mark.parametrize("arch", dryrun.ASSIGNED)
def test_bytes_per_device_equal_the_reference_specs(arch, records,
                                                    ref_dryrun):
    tcfg = ref_dryrun.BASELINE_TCFG
    ref_cfg = ref_get_arch(arch)
    params = ref_steps.abstract_params(ref_cfg, tcfg)
    n_params = sum(int(np.prod(x.shape)) for x in
                   __import__("jax").tree_util.tree_leaves(params))
    for mesh_name, (shape, names) in MESHES.items():
        fm = fake_mesh(shape, names)
        sizes = dict(zip(names, shape))
        p_bytes = _ref_bytes(params, ref_rules.param_specs(
            params, fm, fsdp=tcfg.fsdp, mode=tcfg.parallelism), sizes)
        for sname, ishape in REF_SHAPES.items():
            rec = records[(arch, sname, mesh_name)]
            if rec["status"] == "skipped":
                continue
            mem = rec["memory"]
            assert rec["param_count"] == n_params
            assert mem["params_bytes_per_device"] == p_bytes
            batch = ref_steps.input_specs(ref_cfg, ishape, tcfg)
            want = {"params": p_bytes, "batch": _ref_bytes(
                batch, ref_rules.batch_specs(batch, fm,
                                             mode=tcfg.parallelism), sizes)}
            if ishape.kind == "train":
                opt = ref_steps.abstract_opt_state(ref_cfg, tcfg)
                want["opt_state"] = _ref_bytes(
                    opt, ref_dryrun._opt_specs(opt, params, fm, tcfg), sizes)
            elif ishape.kind == "decode":
                st = ref_steps.abstract_decode_state(ref_cfg, ishape, tcfg)
                want["decode_state"] = _ref_bytes(
                    st, ref_rules.decode_state_specs(st, fm), sizes)
            assert {k: mem[f"{k}_bytes_per_device"] for k in want} == want
            assert mem["argument_bytes_per_device"] == sum(want.values())


def test_default_out_and_cached_records(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--arch", "llama3.2-1b", "--shape", "train_4k"]
    assert dryrun.main(argv) == 0
    path = tmp_path / "build" / "dryrun_torch" / \
        "llama3.2-1b_train_4k_single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert dryrun.main(argv) == 0
    assert "cached" in capsys.readouterr().out
