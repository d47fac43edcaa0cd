"""Two trees of this repository side by side on one card: the build's
seconds, K4's forwards without a softcap timed at the layer shapes of
``PERF.md`` §6, and the SASS of the kernels both trees build.

Run once per tree, each with that tree's ``src`` on ``PYTHONPATH`` and
from its root (the tree builds its own libraries into its ``build/``),
in the order parent, change, change, parent:

    PYTHONPATH=src python tools/ab_forward.py --out build/ab_<tag>.json

and then compare the four records (the first record of each tree has
the cold build):

    python tools/ab_forward.py --compare build/ab_p1.json \\
        build/ab_c1.json build/ab_c2.json build/ab_p2.json

``--compare`` prints, per shape, each tree's best time and the change's
ratio to the parent, and, per kernel both trees hold (K1-K3, K4's
forwards and both backward pairs), whether its SASS is the same text
(addresses and comments stripped).  Run the change's copy of this tool
for both trees: it reads the libraries each tree builds.
Needs a GPU and ``nvcc``; imports neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# (name, q shape, kv shape, causal, window, dtype) at PERF.md §6's rows
SHAPES = (
    ("hymba-4096", (2, 4096, 25, 64), (2, 4096, 5, 64), True, 1024, "bf16"),
    ("hymba-1024", (2, 1024, 25, 64), (2, 1024, 5, 64), True, 0, "bf16"),
    ("llama-4096", (2, 4096, 32, 64), (2, 4096, 8, 64), True, 0, "bf16"),
    ("mixtral", (2, 4096, 32, 128), (2, 4096, 8, 128), True, 4096, "bf16"),
    ("phi4-mini", (2, 4096, 24, 128), (2, 4096, 8, 128), True, 0, "bf16"),
    ("nemotron", (1, 4096, 96, 192), (1, 4096, 8, 192), True, 0, "bf16"),
    ("hubert", (8, 1024, 16, 80), (8, 1024, 16, 80), False, 0, "bf16"),
    ("llama-f32", (2, 2048, 32, 64), (2, 2048, 8, 64), True, 0, "f32"),
    ("phi4-mini-f32", (1, 2048, 24, 128), (1, 2048, 8, 128), True, 0,
     "f32"),
)
# the kernels whose SASS both trees hold: K1-K3's single launches, K4's
# forwards and its two backward pairs
SASS_LIBRARIES = ("fedagg", "flash_attention", "flash_attention_bwd",
                  "flash_attention_bwd_tc")
# K4's kernel families with a CAP flag, and the template arguments they
# have with it (the flag the last): a family's instantiations without a
# cap keep their key from before the flag
CAP_FAMILIES = {"fa_fwd_f32_kernel": 3, "flash_attention_tc_kernel": 3,
                "fa_bwd_dq_kernel": 2, "fa_bwd_dkdv_kernel": 2,
                "fa_bwd_tc_dq_kernel": 2, "fa_bwd_tc_dkdv_kernel": 2}


def _ms(fn, runs=7, per_run=10):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def _sass(path: Path, nvcc: str) -> dict:
    """Function name -> its SASS text, addresses and comments stripped."""
    tool = str(Path(nvcc).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and "/*" in line:
            op = re.sub(r"/\*[0-9a-f]{4}\*/", "", line)
            op = re.sub(r"/\*.*?\*/", "", op).strip()
            if op:
                funcs[name].append(op)
    return {k: "\n".join(v) for k, v in funcs.items()}


def measure(out: Path) -> None:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    names = ["fedagg", "flash_attention", "flash_attention_bwd",
             "flash_attention_bwd_tc", "ssm_scan", "ssm_scan_bwd"]
    t0 = time.perf_counter()
    libs = _build.build(names)
    build_s = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, qs, ks, causal, window, dt in SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q = torch.randn(qs, generator=gen, device="cuda", dtype=dtype)
        k, v = (torch.randn(ks, generator=gen, device="cuda", dtype=dtype)
                for _ in range(2))
        rows[name] = _ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window))
        del q, k, v
    sizes = {f"{dt}_d{d}": fa.fwd_sizes(d, dtype) for d in fa.HEAD_DIMS
             for dt, dtype in (("f32", torch.float32),
                               ("bf16", torch.bfloat16))}
    nvcc = _build._nvcc()
    sass = {lib: _sass(libs[lib], nvcc) for lib in SASS_LIBRARIES}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "build_s": build_s,
                               "ms": rows, "fwd_sizes": sizes,
                               "sass": sass}))
    print(json.dumps({"out": str(out), "card": card, "build_s": build_s,
                      "ms": rows}), flush=True)


def _by_template(funcs: dict) -> dict:
    """Kernels keyed by their name and integer / bool template arguments
    (the parameter list left out), K4's ``CAP`` flag (the last argument
    of ``CAP_FAMILIES``, added after the others) dropped where it is
    ``false`` and marked ``+cap`` where it is ``true``: an instantiation
    without a cap keeps its key across the flag's arrival, though its
    parameters grew by the cap's scalars at the end."""
    out = {}
    for name, text in funcs.items():
        m = re.match(r"(.*?I)((?:L[ib]\d+E)+)", name)
        if not m:
            out[name] = text
            continue
        args = re.findall(r"L[ib]\d+E", m.group(2))
        family = next((f for f in CAP_FAMILIES
                       if m.group(1).endswith(f"{f}I")), None)
        cap = len(args) == CAP_FAMILIES.get(family) \
            and args.pop() == "Lb1E"
        out[m.group(1) + "".join(args) + ("+cap" if cap else "")] = text
    return out


def compare(paths) -> None:
    p1, c1, c2, p2 = (json.loads(Path(p).read_text()) for p in paths)
    report = {"card": p1["card"],
              "build_s": {"parent": [p1["build_s"], p2["build_s"]],
                          "change": [c1["build_s"], c2["build_s"]]},
              "fwd_sizes_equal": p1["fwd_sizes"] == c1["fwd_sizes"],
              "ms": {}, "sass": {}}
    for name in p1["ms"]:
        par = min(p1["ms"][name], p2["ms"][name])
        chg = min(c1["ms"][name], c2["ms"][name])
        report["ms"][name] = {"parent": [p1["ms"][name], p2["ms"][name]],
                              "change": [c1["ms"][name], c2["ms"][name]],
                              "change_over_parent": chg / par}
    for lib in SASS_LIBRARIES:
        a, b = (_by_template(t["sass"][lib]) for t in (p1, c1))
        both = sorted(set(a) & set(b))
        report["sass"][lib] = {
            "kernels_in_both": len(both),
            "identical": sum(a[k] == b[k] for k in both),
            "differ": [k for k in both if a[k] != b[k]],
            "only_in_change": sorted(set(b) - set(a)),
            "only_in_parent": sorted(set(a) - set(b))}
    print(json.dumps(report, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs=4, metavar="JSON")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.compare)
    elif args.out:
        measure(args.out)
    else:
        ap.error("--out or --compare")
    return 0


if __name__ == "__main__":
    sys.exit(main())
