"""One run of one benchmark cell of the FedDCT port (``repro_torch``).

    python3 flbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``src/`` is put on the path here).  It
needs a CUDA device: without one it exits non-zero and prints no result.
The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (client updates trained in the window, and
those not merged into a global model), ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``,
``setup_split`` (the set-up's seconds by phase: imports, inputs,
trainer, cohort shapes, warm-up rounds), ``check_copy_s`` (the seconds
of the check's host copies, kept out of the set-up and the window),
``judged_rounds`` ([round, updates] of each round the check judged),
and last ``checks``: each number the correctness check compared, with
its limit.
The same numbers end standard error, one a line.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from flbench import bench, check  # noqa: E402
from flbench.trace import Tracer, breakdown  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"flbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device, t_process: float, replace=None,
            detail: dict = None) -> dict:
    """The run of ``workload`` on ``device``: set-up, warm-up, window,
    metrics and check.  Returns the result line as a dict.  ``replace``:
    see ``bench.run_program``; ``detail``: see ``check.judge``."""
    cell = bench.resolve_cell(root, workload)
    tr = cell["traffic"]
    tracer = Tracer(cell) if trace else None
    run = bench.run_program(cell, seed, seconds, device, t_process,
                            tracer=tracer, replace=replace)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(run["peak"])}
    metrics = {}
    if trace:
        tr_ = tracer.trace
        for m in cell["per_layer"]:
            value = _reader(cell["readers"][m["name"]])(tr_)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr_.busy_s(), window_s=tr_.profiled_s)
    else:
        have = {"samples_per_s": run["samples_per_s"],
                "peak_mem_gb": run["peak"] / 1e9,
                "setup_s": run["setup_s"]}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": have[m["name"]], "unit": m["unit"]}
    detail = {} if detail is None else detail
    numbers = check.judge(cell, seed, run, device, detail)
    limits = tr["limits"]
    result = {"correct": check.verdict(numbers, limits),
              "attempted": run["attempted"], "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = breakdown(tracer.trace)
    result["setup_split"] = run["setup_split"]
    result["check_copy_s"] = run["copy_s"]
    result["judged_rounds"] = detail["judged"]
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    result["checks"]["rounds_checked"] = {"value": numbers["rounds_checked"],
                                          "at_least": 1}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = bench.resolve_cell(Path.cwd(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"flbench: {args.workload} needs {cell['chips']} CUDA "
              "device(s); none usable here", file=sys.stderr)
        return 2
    result = execute(Path.cwd(), args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda"), T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"flbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    for k, v in result["checks"].items():
        bound = (f"limit {v['limit']!r}" if "limit" in v
                 else f"at least {v['at_least']!r}")
        print(f"check {k} = {v['value']!r} ({bound})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
