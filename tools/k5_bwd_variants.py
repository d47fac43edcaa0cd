#!/usr/bin/env python3
"""Where K5's f32 backward kernel spends its time, on one GPU: the
committed kernel and ablations of it, timed in turns.

    python3 tools/k5_bwd_variants.py [--only v0,pass1_only,...]

Each variant is the committed ``src/repro_torch/kernels/csrc/
ssm_scan_bwd.cu`` with text patches that leave parts of the kernel out,
built with ``nvcc -Xptxas -v`` into ``build/k5_bwd_variants/``, all at
once: registers and spills are printed.  ``v0`` is held against
``ssm_scan_bwd_plain`` at ``chip_smoke.py``'s ``BWD_RTOL`` /
``BWD_ATOL``; the ablations compute wrong gradients by design and are
only timed.  All are timed with ``chip_smoke.median_ms`` (launches
enqueued behind other device work, so the reading is device time) at
hymba's training shape (B=1, S=2048, D=3200, N=16, f32), launched
directly with the forward's chunk carries, in turns: the variants in
order, then reversed.  v0 less an ablation is what the part it leaves
out costs.  The last line of standard output is one JSON object of the
times.  Needs one CUDA card and nvcc; exits non-zero otherwise or when
v0 disagrees.

Variants:
  v0                   the committed kernel
  no_reduce_scatter    dB and dC without the reduce-scatter over the
                       warp's lanes (each writer stores two of its own
                       values)
  no_walk_back         the walk back's arithmetic and stores left out
                       (the checkpoint walk and the replays kept)
  pass1_only           the passes from zero, the carries and the folds;
                       no checkpoints, replays or walk back
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "k5_bwd_variants"
SOURCE = ROOT / "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu"

# name -> [(anchor, replacement)]; each anchor occurs once
VARIANTS = {
    "v0": [],
    "no_reduce_scatter": [(
        "const float part = sb_reduce_scatter<V>(vals, lane);",
        "const float part = vals[0] + vals[V - 1];")],
    "no_walk_back": [(
        "if (i >= cnt) continue;",
        "if (i >= cnt || S > 0) {\n"
        "                    dacc[0] += hs[i + 1][N - 1];   // keeps the "
        "replays\n"
        "                    continue;\n"
        "                }")],
    "pass1_only": [(
        "const int nb = te > tb ? (te - tb + SB_BLK - 1) / SB_BLK : 0;",
        "const int nb = 0;")],
}


def patched(name):
    """The variant's source text."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"k5_bwd_variants: {name}: anchor not found "
                             f"once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names):
    """name -> library path; prints each instantiation's registers and
    spills."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(patched(name))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k5_bwd_variants: {name} failed to build:\n"
                             f"{out}")
        kernels = re.findall(
            r"Compiling entry function '_Z\d+ssm_scan_bwd_kernelIfLi(\d+)EE"
            r".*?(\d+) bytes spill stores.*?Used (\d+) registers", out, re.S)
        print(json.dumps({"variant": name, "ptxas": [
            {"n": int(n), "spill_stores": int(sp), "registers": int(r)}
            for n, sp, r in kernels]}), flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    names = [n for n in args.only.split(",") if n]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"k5_bwd_variants: unknown {unknown}")
    for name in names:
        patched(name)
    import torch
    if not torch.cuda.is_available():
        print("k5_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch import set_full_f32
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as ss
    set_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(24)
    b, s, d, n = 1, 2048, 3200, 16
    x, dt, bi, co, al = smoke.ssm_inputs(gen, b, s, d, n, torch.float32)
    dy = torch.randn(b, s, d, generator=gen, device="cuda")
    carries = ss._kernel_forward(x, dt, bi, co, al, None)[2]

    def kernel(name):
        """The wrapper's backward on the variant's library."""
        lib = libs[name]
        lib.ssm_scan_bwd.argtypes = ss._BWD_ARGTYPES
        lib.ssm_scan_bwd.restype = ctypes.c_int
        lib.ssm_scan_bwd_sizes.argtypes = ss._BWD_SIZES_ARGTYPES
        lib.ssm_scan_bwd_sizes.restype = ctypes.c_longlong
        _build._LIBS["ssm_scan_bwd"] = lib
        return ss._kernel_backward(x, dt, bi, co, al, None, dy, None,
                                   carries)

    ok = True
    if "v0" in names:
        want = ss.ssm_scan_bwd_plain(x, dt, bi, co, al, None, dy)
        for tag, got, w in zip(("dx", "ddt", "db", "dc", "da_log"),
                               kernel("v0"), want):
            err, _, close = smoke._grad_close(f"v0.{tag}", got, w)
            print(json.dumps({"variant": "v0", "grad": tag,
                              "max_abs_err": err, "ok": close}), flush=True)
            ok = ok and close
    res = {name: [] for name in names}
    for name in names + names[::-1]:
        res[name].append(smoke.median_ms(lambda: kernel(name)))
    print(json.dumps({"card": card, "shape": [b, s, d, n],
                      "ms_turns": res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
