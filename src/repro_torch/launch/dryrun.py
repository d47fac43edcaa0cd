"""Production-mesh dry run without a compiler: every (arch x input
shape) on the production meshes, placed and sized, nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The JAX package's ``launch/dryrun.py`` lowers and compiles each step on
512 forced host devices and reads XLA's memory and cost analyses.  The
port has no compiler to ask: it builds the step's arguments as ``meta``
tensors (``launch.steps.abstract_*``, ``input_specs``), places them
with the sharding rules on the ``meta`` production meshes
(``launch.mesh.make_production_mesh``), and sums the bytes each device
holds.  A record has ``arch``, ``shape``, ``mesh``, ``variant`` and
``status`` (``ok``; ``skipped`` with its ``reason``; ``error``), and
when ok:

* ``memory.argument_bytes_per_device``, split into ``params``,
  ``opt_state`` (training), ``batch`` and ``decode_state`` (decode);
* ``param_count`` counted over the parameter tree (and the config's
  analytic ``param_count_config``, which miscounts xLSTM and leaves out
  the SSM's ``w_dt``), ``model_flops`` and ``model_flops_per_chip``;
* ``not_measured``: what the reference's record has and this one does
  not -- compile seconds, XLA's temp and output bytes and cost, the
  HLO's collectives and the roofline need a compiler's analysis
  (ROADMAP.md queue 1 item 16, ``roofline/``).

Records go to ``--out`` (default ``build/dryrun_torch``), one JSON file
each; a file already there is read back, not recomputed.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Dict, Optional

import numpy as np

from repro_torch.config import get_arch
from repro_torch.config.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                     TrainConfig)
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import (batch_specs, decode_state_specs,
                                  named_shardings, param_specs)
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.tree import tree_leaves, tree_map

# a copy of the reference's list (tests pin it to the original)
ASSIGNED = [
    "granite-20b", "nemotron-4-340b", "phi4-mini-3.8b", "llama3.2-1b",
    "mixtral-8x7b", "hubert-xlarge", "hymba-1.5b", "arctic-480b",
    "xlstm-350m", "chameleon-34b",
]

# The BASELINE sharding config: megatron TP + FSDP without the
# reference's hillclimb options, as its roofline table uses.
BASELINE_TCFG = TrainConfig(context_parallel="never", seq_parallel=False,
                            long_ctx_swa=False, decode_headdim_shard=False)

NOT_MEASURED = ("compile_s, output/temp/alias bytes, xla_cost, hlo and "
                "roofline need a compiler's analysis: ROADMAP.md queue 1 "
                "item 16 (roofline/)")


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if cfg.is_encoder_only and shape.kind == "decode":
        return "encoder-only: no decode step (DESIGN.md §6)"
    return None


def variant_note(cfg: ModelConfig, shape: InputShape,
                 tcfg: TrainConfig) -> str:
    if steps_lib.swa_window_for(cfg, shape, enabled=tcfg.long_ctx_swa) > 0:
        return f"swa-{steps_lib.SWA_OVERRIDE_WINDOW}"
    return "native"


def _device_bytes(shardings, tree) -> int:
    return sum(sh.device_bytes(x)
               for sh, x in zip(tree_leaves(shardings), tree_leaves(tree)))


def run_one(arch: str, shape_name: str, multi_pod: bool,
            tcfg: TrainConfig = None, verbose: bool = True) -> Dict:
    if tcfg is None:
        tcfg = BASELINE_TCFG
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "variant": variant_note(cfg, shape, tcfg)}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    # no step is traced, so no model code reads the mesh or the decode
    # toggle: the reference's set_mesh and DECODE_HEADDIM_SHARD around its
    # lowering have nothing to do here
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = int(np.prod(mesh.devices.shape))
    params = steps_lib.abstract_params(cfg, tcfg)
    p_specs = param_specs(params, mesh, fsdp=tcfg.fsdp,
                          mode=tcfg.parallelism)
    mem = {"params": _device_bytes(named_shardings(p_specs, mesh), params)}
    batch = steps_lib.input_specs(cfg, shape, tcfg)
    mem["batch"] = _device_bytes(named_shardings(
        batch_specs(batch, mesh, mode=tcfg.parallelism), mesh), batch)
    if shape.kind == "train":
        opt_state = steps_lib.abstract_opt_state(cfg, tcfg)
        mem["opt_state"] = _device_bytes(named_shardings(
            _opt_specs(opt_state, params, mesh, tcfg), mesh), opt_state)
    elif shape.kind == "decode":
        state = steps_lib.abstract_decode_state(cfg, shape, tcfg)
        mem["decode_state"] = _device_bytes(named_shardings(
            decode_state_specs(state, mesh), mesh), state)

    rec["memory"] = {"argument_bytes_per_device": sum(mem.values()),
                     **{f"{k}_bytes_per_device": v for k, v in mem.items()}}
    rec["param_count"] = sum(x.numel() for x in tree_leaves(params))
    rec["param_count_config"] = cfg.param_count()
    mf = steps_lib.model_flops(cfg, shape)
    rec["model_flops"] = mf
    rec["model_flops_per_chip"] = mf / n_chips
    rec["not_measured"] = NOT_MEASURED
    rec["status"] = "ok"
    if verbose:
        print(f"[dryrun] {arch:16s} {shape_name:12s} {mesh_name:8s} "
              f"{rec['variant']:10s} args/device="
              f"{rec['memory']['argument_bytes_per_device'] / 2**30:8.3f} "
              f"GiB params={rec['param_count'] / 1e9:.3f}B", flush=True)
    return rec


def _opt_specs(opt_state, params, mesh, tcfg):
    """Optimizer moments shard like their parameter; scalars replicate."""
    p_specs = param_specs(params, mesh, fsdp=tcfg.fsdp,
                          mode=tcfg.parallelism)
    # adam state: {"m": tree, "v": tree, "t": scalar}
    if isinstance(opt_state, dict) and "m" in opt_state:
        return {"m": p_specs, "v": p_specs, "t": P()}
    if isinstance(opt_state, tuple) and len(opt_state) == 0:
        return ()
    return tree_map(lambda _: P(), opt_state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] {tag}: cached")
                    with open(path) as f:
                        results.append(json.load(f))
                    continue
                try:
                    rec = run_one(arch, shape, mp)
                except Exception as e:  # fedlint: disable=FED007 -- sweep harness records the per-arch failure and continues
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"[dryrun] {tag}: ERROR {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                results.append(rec)
    ok = sum(1 for r in results if r.get("status") == "ok")
    sk = sum(1 for r in results if r.get("status") == "skipped")
    er = sum(1 for r in results if r.get("status") == "error")
    print(f"[dryrun] done: {ok} ok, {sk} skipped, {er} errors")
    return 0 if er == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
