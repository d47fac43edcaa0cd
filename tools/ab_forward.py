"""Two trees of this repository side by side on one card: the build's
seconds, K4's forwards without a softcap timed at the layer shapes of
``PERF.md`` §6, K1's single launch at the main path's shapes and the
tiled route of K1-K3 at 8,192 rows, and the SASS of the kernels both
trees build.

Run once per tree, each with that tree's ``src`` on ``PYTHONPATH`` and
from its root (the tree builds its own libraries into its ``build/``),
in the order parent, change, change, parent:

    PYTHONPATH=src python tools/ab_forward.py --out build/ab_<tag>.json \
        [--train]

With ``--train`` each record also holds K4's f32 training kernels at
llama3.2-1b's and hymba-1.5b's training layers (the forward with lse,
dq and dkdv through the tree's wrappers) and the f32 ``launch.train
--full`` step of each (``chip_smoke.recording_train_steps`` of the
tree's ``chip_smoke.py``: three steps, the last two warm), on a seeded
uniform token corpus (the step's time does not depend on the tokens).

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
# the kernels whose SASS both trees hold: K1-K3, K4's forwards and its
# two backward pairs, K5 and its backward
SASS_LIBRARIES = ("fedagg", "flash_attention", "flash_attention_bwd",
                  "flash_attention_bwd_tc", "ssm_scan", "ssm_scan_bwd")
# (name, q shape, kv shape, window) of the f32 training layers, causal
TRAIN_LAYERS = (("llama", (2, 2048, 32, 64), (2, 2048, 8, 64), 0),
                ("hymba", (1, 2048, 25, 64), (1, 2048, 5, 64), 1024))
# K1 at the main path's width (full-width cnn-mnist): its cohort of 32
# and the widest cohort the path formed; and K1-K3 past 4,096 rows
FEDAGG_P = 1_630_090
FEDAGG_ROWS = (32, 5)
TILED = (8192, 131_072)
# (arch, batch, seq) of chip_smoke.py's f32 train steps (LM_TRAIN)
TRAIN_STEPS = (("llama3.2-1b", 2, 2048), ("hymba-1.5b", 1, 2048))
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


def fedagg_rows() -> dict:
    """ms of K1's single launch at ``FEDAGG_ROWS`` x ``FEDAGG_P`` and of
    K1-K3's tiled route at ``TILED``, through the tree's wrappers."""
    import torch
    from repro_torch.kernels import fedagg as fg
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for n in FEDAGG_ROWS:
        u = torch.randn(n, FEDAGG_P, generator=gen, device="cuda")
        w = torch.rand(n, generator=gen, device="cuda") + 0.1
        rows[f"fedagg_n{n}"] = _ms(lambda: fg.fedagg(u, w))
        del u
    n, p = TILED
    u = torch.randn(n, p, generator=gen, device="cuda")
    g = torch.randn(p, generator=gen, device="cuda")
    c = torch.rand(n, generator=gen, device="cuda") + 0.1
    rows["tiled_fedagg"] = _ms(lambda: fg.fedagg(u, c), per_run=5)
    rows["tiled_fedagg_fold"] = _ms(lambda: fg.fedagg_fold(u[:n - 1], g, c),
                                    per_run=5)
    rows["tiled_fedagg_partial"] = _ms(lambda: fg.fedagg_partial(u, c),
                                       per_run=5)
    del u
    torch.cuda.empty_cache()
    return rows


def train_kernels() -> dict:
    """ms of K4's f32 forward with lse, dq and dkdv at each training
    layer, through the tree's own wrappers."""
    import math
    import torch
    from repro_torch.kernels import flash_attention as fa
    rows = {}
    for name, qs, ks, window in TRAIN_LAYERS:
        gen = torch.Generator(device="cuda").manual_seed(23)
        q, do = (torch.randn(qs, generator=gen, device="cuda")
                 for _ in "qd")
        k, v = (torch.randn(ks, generator=gen, device="cuda")
                for _ in "kv")
        o, lse, _ = fa._kernel_forward(q, k, v, True, window, 0,
                                       with_lse=True)
        lib = fa._bwd_lib(torch.float32)
        b, s, h, d = qs
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty((b, h, s), device="cuda")
        args = (b, s, ks[1], h, ks[2], d, 1, window, 0, 1.0 / math.sqrt(d))
        stream = torch.cuda.current_stream().cuda_stream

        def dq_kernel():
            lib.flash_attention_bwd_dq_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), *args, stream, 0.0)

        def dkdv_kernel():
            lib.flash_attention_bwd_dkdv_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *args, stream, 0.0)

        dq_kernel()
        rows[name] = {
            "fwd_lse": _ms(lambda: fa._kernel_forward(
                q, k, v, True, window, 0, with_lse=True)),
            "dq": _ms(dq_kernel), "dkdv": _ms(dkdv_kernel)}
        rows[name]["pair"] = rows[name]["dq"] + rows[name]["dkdv"]
        del q, k, v, do, o, lse, dq, dk, dv
    return rows


def train_steps() -> dict:
    """Warm s/step of the f32 ``launch.train --full`` step of each
    ``TRAIN_STEPS`` arch (the median of steps 2 and 3)."""
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.launch import train as train_mod

    def corpus(vocab, n, seed=0, order=2):
        rng = np.random.default_rng(seed)
        return rng.integers(0, vocab, n).astype(np.int32)

    rows = {}
    for arch, b, s in TRAIN_STEPS:
        record = {}
        torch.cuda.empty_cache()
        with chip_smoke.recording_train_steps(record), chip_smoke.patched(
                train_mod, "make_token_dataset", corpus):
            train_mod.main(["--arch", arch, "--full", "--batch", str(b),
                            "--seq", str(s), "--steps", "3",
                            "--log-every", "1"])
        rows[arch] = {"step_s": record["step_s"],
                      "warm_s_per_step": statistics.median(
                          record["step_s"][1:])}
        record.clear()
        torch.cuda.empty_cache()
    return rows


def measure(out: Path, train: bool = False) -> None:
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
    rows.update(fedagg_rows())
    sizes = {f"{dt}_d{d}": fa.fwd_sizes(d, dtype) for d in fa.HEAD_DIMS
             for dt, dtype in (("f32", torch.float32),
                               ("bf16", torch.bfloat16))}
    extra = ({"train_ms": train_kernels(), "train_steps": train_steps()}
             if train else {})
    nvcc = _build._nvcc()
    sass = {lib: _sass(libs[lib], nvcc) for lib in SASS_LIBRARIES}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "build_s": build_s,
                               "ms": rows, "fwd_sizes": sizes,
                               "sass": sass, **extra}))
    print(json.dumps({"out": str(out), "card": card, "build_s": build_s,
                      "ms": rows, **extra}), flush=True)


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
    if "train_ms" in p1 and "train_ms" in c1:
        report["train"] = {}
        for name in p1["train_ms"]:
            for key in p1["train_ms"][name]:
                par = min(p1["train_ms"][name][key],
                          p2["train_ms"][name][key])
                chg = min(c1["train_ms"][name][key],
                          c2["train_ms"][name][key])
                report["train"][f"{name}.{key}"] = {
                    "parent": par, "change": chg,
                    "change_over_parent": chg / par}
        for arch in p1["train_steps"]:
            par, chg = (min(t["train_steps"][arch]["warm_s_per_step"]
                            for t in pair) for pair in ((p1, p2), (c1, c2)))
            report["train"][f"{arch}.s_per_step"] = {
                "parent": par, "change": chg, "change_over_parent": chg / par}
    for lib in SASS_LIBRARIES:
        if lib not in p1["sass"] or lib not in c1["sass"]:
            continue
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
    ap.add_argument("--train", action="store_true",
                    help="also K4's f32 training kernels and the f32 "
                         "train steps")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.compare)
    elif args.out:
        measure(args.out, args.train)
    else:
        ap.error("--out or --compare")
    return 0


if __name__ == "__main__":
    sys.exit(main())
