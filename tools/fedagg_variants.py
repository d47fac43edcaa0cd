#!/usr/bin/env python3
"""Variants of K1-K3's stream past 4,096 rows on one GPU, timed in turns.

    python3 tools/fedagg_variants.py [--only v0,ring32,...]
                                     [--baseline NAME=FILE.cu ...]

Each variant is the committed ``src/repro_torch/kernels/csrc/fedagg.cu``
with a text patch (and, with each ``--baseline``, another source of the
same entries -- an earlier commit's, say -- as the variant NAME), built
with ``nvcc -Xptxas -v`` into ``build/fedagg_variants/``: each stream
kernel's registers and spills are printed.  Two widths of 8,192 rows:
P = 131,072 (float4) and the P of the resnet8-cifar10 tree as the port
builds it (77,594 floats: an odd count of float2s, the vec = 2 path).
At each, every variant runs the three modes (``fedagg``, ``fedagg_fold``
on 8,191 rows, ``fedagg_partial``) through the wrappers and is held bit
for bit: against the single launch on the first 4,096 rows with zero
coefficients appended (rows of inf and nan among them), and against
v0 with every row live.  Then each mode is timed with
``chip_smoke.median_ms`` (launches enqueued behind other device work, so
the reading is device time), in turns: v0 first, each variant, then the
order reversed; beside it the mode's bound (``roofline/cost.py``, bytes
at 3.35 TB/s) and one PyTorch call of the same sum (``matmul``,
``addmv``, ``mv``).  The last line of standard output is one JSON object
of the times.  Needs one CUDA card and nvcc; exits non-zero otherwise or
when a variant's bits differ.

Variants:
  v0            the committed stream: a ring of 32 float4 (64 float2 or
                float) rows a thread in registers, the packed
                coefficients and indices in a warp's lanes, blocks sized
                to fill every SM in one wave
  ring32        a ring of 32 rows at every vector width
  ring64        a ring of 64 rows at every vector width
  ring128       128 rows of float2 or float (32 of float4)
  wide          v0's ring in blocks of 256 threads (as many as are
                resident, striding): the first design's grid
  NAME          a source given with --baseline NAME=FILE.cu, as it is
                (the first design: tiles of 2,048 coefficients staged in
                shared memory behind two block barriers, 16 rows a
                thread in flight a batch)
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

OUT = ROOT / "build" / "fedagg_variants"
SOURCE = ROOT / "src/repro_torch/kernels/csrc/fedagg.cu"
ROWS = 8192
WIDE_P = 131_072
SINGLE = 4096                    # FEDAGG_MAX_ROWS

RING = "static constexpr int ROWS = sizeof(V) == 16 ? 32 : 64;"
THREADS = "long long t = ((vectors + per - 1) / per + 31) / 32 * 32;"

# name -> [(anchor, replacement)]; each anchor occurs once
VARIANTS = {
    "v0": [],
    "ring32": [(RING, "static constexpr int ROWS = 32;")],
    "ring64": [(RING, "static constexpr int ROWS = 64;")],
    "ring128": [(RING, "static constexpr int ROWS = sizeof(V) == 16 ? 32 "
                       ": 128;")],
    "wide": [(THREADS, "long long t = FEDAGG_THREADS;")],
}


def patched(name):
    """The variant's source text."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"fedagg_variants: {name}: anchor not found "
                             f"once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(sources):
    """name -> library path, all built at once; prints each stream
    kernel's registers and spills."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"fedagg_variants: {name} failed to build:\n"
                             f"{out}")
        kernels = re.findall(
            r"Compiling entry function '_Z\d+(fedagg_ws_kernel)I(\w+?)Li"
            r"(\d)E.*?(\d+) bytes spill stores.*?Used (\d+) registers",
            out, re.S)
        print(json.dumps({"variant": name, "ptxas": [
            {"kernel": k, "vector": v, "mode": int(m),
             "spill_stores": int(sp), "registers": int(r)}
            for k, v, m, sp, r in kernels]}), flush=True)
        libs[name] = OUT / f"lib{name}.so"
    return libs


def use(path):
    """Route the wrappers to the library at ``path``."""
    from repro_torch.kernels import _build
    _build._LIBS["fedagg"] = ctypes.CDLL(str(path))


def inputs(p, seed):
    """(8,192, p) rows, the global row and each mode's coefficients: K1's
    weights and alphas, K2's (8,192,) global first, K3's summing to about
    one; rows 4,099 and 8,191 hold inf and nan."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(ROWS, p, generator=gen, device="cuda")
    u[SINGLE + 3] = float("inf")
    u[ROWS - 1] = float("nan")
    g = torch.randn(p, generator=gen, device="cuda")
    w = 40.0 + 40.0 * torch.rand(ROWS, generator=gen, device="cuda")
    a = torch.rand(ROWS, generator=gen, device="cuda")
    c = torch.rand(ROWS, generator=gen, device="cuda")
    c3 = c / c.sum()
    return u, g, w, a, c, c3


def calls(u, g, w, a, c, c3, live):
    """mode -> a call of its wrapper on ``live`` leading rows of 8,192
    (coefficients past them zero), rows 4,099 and 8,191 masked."""
    import torch
    from repro_torch.kernels import fedagg as fa
    keep = torch.zeros(ROWS, device="cuda")
    keep[:live] = 1.0
    keep[SINGLE + 3] = keep[ROWS - 1] = 0.0
    wk, ck, c3k = w * keep, c * keep, c3 * keep
    return {"fedagg": lambda: fa.fedagg(u, wk, alphas=a),
            "fedagg_fold": lambda: fa.fedagg_fold(u[:ROWS - 1], g, ck),
            "fedagg_partial": lambda: fa.fedagg_partial(u, c3k)}


def singles(u, g, w, a, c, c3):
    """mode -> the single launch on the first 4,096 rows (K2: 4,096
    coefficients)."""
    from repro_torch.kernels import fedagg as fa
    return {"fedagg": lambda: fa.fedagg(u[:SINGLE], w[:SINGLE],
                                        alphas=a[:SINGLE]),
            "fedagg_fold": lambda: fa.fedagg_fold(u[:SINGLE - 1], g,
                                                  c[:SINGLE]),
            "fedagg_partial": lambda: fa.fedagg_partial(u[:SINGLE],
                                                        c3[:SINGLE])}


def check(names, libs, ins):
    """Each variant's bits: the padded call against the single launch,
    the all-live call against v0's.  Returns the failures."""
    import torch
    from repro_torch.kernels import fedagg as fa
    bad, want_all = [], {}
    for name in names:
        use(libs[name])
        padded = calls(*ins, live=SINGLE)
        full = calls(*ins, live=ROWS)
        for mode, single in singles(*ins).items():
            before = fa.tiled_launches
            got, want = padded[mode](), single()
            every = full[mode]()
            torch.cuda.synchronize()
            if fa.tiled_launches - before != 2:
                bad.append(f"{name}/{mode}: {fa.tiled_launches - before} "
                           "tiled calls, expected 2")
            if not torch.equal(got, want):
                bad.append(f"{name}/{mode}: padded to 8,192 != the single "
                           "launch")
            if name == names[0]:
                want_all[mode] = every
            elif not torch.equal(every, want_all[mode]):
                bad.append(f"{name}/{mode}: 8,192 live rows != "
                           f"{names[0]}'s")
    return bad


def times(names, libs, ins, p):
    """mode -> {variant: [ms in turns]}, the bound, the library call."""
    import torch
    import chip_smoke as smoke
    from repro_torch.roofline import cost
    u, g, w, a, c, c3 = ins
    keep = torch.ones(ROWS, device="cuda")
    keep[SINGLE + 3] = keep[ROWS - 1] = 0.0
    wk, ck, c3k = w * keep, c * keep, c3 * keep
    eff = wk * a / (wk * a).sum()
    fold_c = ck / ck.sum()
    library = {"fedagg": (lambda: torch.matmul(eff, u), "matmul"),
               "fedagg_fold": (lambda: torch.addmv(
                   g * fold_c[0], u[:ROWS - 1].t(), fold_c[1:]), "addmv"),
               "fedagg_partial": (lambda: torch.mv(u.t(), c3k), "mv")}
    bounds = {"fedagg": cost.fedagg_bound_ms(wk * a, p),
              "fedagg_fold": cost.fold_bound_ms(ck, p),
              "fedagg_partial": cost.partial_bound_ms(c3k, p)}
    out = {}
    for mode in ("fedagg", "fedagg_fold", "fedagg_partial"):
        row = {"ms": {n: [] for n in names}}
        for name in names + names[::-1]:
            use(libs[name])
            fn = calls(*ins, live=ROWS)[mode]
            row["ms"][name].append(smoke.median_ms(fn, warmup=2, runs=5,
                                                   per_run=5))
        fn, lib_name = library[mode]
        row["library"] = lib_name
        row["library_ms"] = smoke.median_ms(fn, warmup=2, runs=5, per_run=5)
        row["bound_ms"], row["bound_by"] = bounds[mode]
        row["share_of_bound"] = {n: row["bound_ms"] / min(t)
                                 for n, t in row["ms"].items()}
        row["over_library"] = {n: min(t) / row["library_ms"]
                               for n, t in row["ms"].items()}
        out[mode] = row
        print(json.dumps({"p": p, "mode": mode, **row}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (v0 is always built)")
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=FILE.cu: another source as variant NAME")
    args = ap.parse_args(argv)
    names = ["v0"] + [n for n in args.only.split(",") if n and n != "v0"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"fedagg_variants: unknown variants {unknown}")
    sources = {n: patched(n) for n in names}
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        if not name or not path or name in sources:
            raise SystemExit(f"fedagg_variants: --baseline {spec!r}: want "
                             f"a new NAME=FILE.cu")
        sources[name] = Path(path).read_text()
    import torch
    if not torch.cuda.is_available():
        print("fedagg_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    libs = build(sources)
    names = list(sources)
    bad, res = [], {}
    import chip_smoke
    for p in (WIDE_P, chip_smoke.resnet8_p()):
        ins = inputs(p, seed=12)
        bad += [f"p={p}: {b}" for b in check(names, libs, ins)]
        print(json.dumps({"p": p, "bits": "equal" if not bad else bad}),
              flush=True)
        res[p] = times(names, libs, ins, p)
        del ins
        torch.cuda.empty_cache()
    print(card, flush=True)
    print(json.dumps({"card": card, "failed": bad, "times": res}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
