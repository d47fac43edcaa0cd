#!/usr/bin/env python3
"""Variants of K1-K3's stream past 4,096 rows on one GPU, timed in turns,
and the crossover grid of the single launch against the tiled route.

    python3 tools/fedagg_variants.py [--only v0,ring32,...]
                                     [--baseline NAME=FILE.cu ...]
                                     [--grid no|also|only]

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

With ``--grid also`` or ``only``, the crossover grid (``crossover``): at
each width of resnet8-cifar10 (77,594), 131,072 and cnn-mnist
(1,630,090), each row count of ``GRID_ROWS`` (8 to 4,096; K2 holds them:
rows - 1 rows) and each mode, the entries called directly: ``batch``,
v0's single launch (the batch loop of 16 rows a thread in flight: the
wrappers' route for every call up to 4,096 rows before the crossover),
``ring``, v0's tiled twin (preamble and ring stream), and each other
variant's single launch (``single_ring``), held bit for bit against
``batch`` and timed in turns, beside the bound and the route
``fedagg.tiled_route`` takes.  Calls rotate over the 4,096 // rows
windows of a 4,096-row buffer, so none finds its rows in the L2.

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
  single_ring   the single launch's three kernels folding their rows
                through v0's ring (coefficients and indices from their
                shared memory, no preamble launch), each grid sized by
                ws_grid's rule for that kernel: the other design of tall
                calls (the grid: slower than the tiled route in every
                cell from 256 rows on, PERF.md)
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

# single_ring: the single launch's row loop (three calls, one a mode)
# through a ring of rows a thread, as the tiled stream folds them, and
# each launch's grid sized as the stream's (ws_grid) for that kernel
SUM_CALL = "sum_live_rows<V>(u, p, col, "
RING_CALL = "ring_live_rows<V>(u, p, col, "
FIRST_KERNEL = ("template <typename V>\n__global__ void "
                "__launch_bounds__(FEDAGG_THREADS)\nfedagg_kernel(")
RING_ROWS = r"""// This thread's columns summed over the n_live live rows, in row order,
// through a ring of R row slots: folding row j frees its slot for row
// j + R, so R loads stay in flight with no gap between batches; the
// coefficients and row indices from the launch's shared memory.
template <typename V>
__device__ __forceinline__ V ring_live_rows(const float* __restrict__ u,
                                            long long p, long long col,
                                            int n, int n_live) {
    constexpr int R = sizeof(V) == 16 ? 32 : 64;
    const float* eff = fedagg_smem;
    const int* live = reinterpret_cast<const int*>(fedagg_smem + n);
    V acc = V();
    V x[R];
#pragma unroll
    for (int s = 0; s < R; ++s)
        if (s < n_live)
            x[s] = ldg(reinterpret_cast<const V*>(
                u + (long long)live[s] * p + col));
    for (int j0 = 0; j0 < n_live; j0 += R) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
            if (j0 + s < n_live) fma_into(eff[live[j0 + s]], x[s], acc);
            if (j0 + R + s < n_live)
                x[s] = ldg(reinterpret_cast<const V*>(
                    u + (long long)live[j0 + R + s] * p + col));
        }
    }
    return acc;
}

"""
FIRST_LAUNCH = "template <typename V>\nstatic int launch(const float* u,"
RING_GRID = r"""// ws_grid's rule for one single-launch kernel and its shared bytes
template <typename V, typename K>
static int ring_grid(K kernel, long long p, size_t smem, unsigned* blocks,
                     unsigned* threads) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const long long vectors = p / (long long)(sizeof(V) / sizeof(float));
    for (int k = 1;; ++k) {
        const long long per = (long long)sms * k;
        long long t = ((vectors + per - 1) / per + 31) / 32 * 32;
        t = t < 32 ? 32 : t > FEDAGG_THREADS ? FEDAGG_THREADS : t;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, (int)t, smem);
        if (err != cudaSuccess) return (int)err;
        const long long b = (vectors + t - 1) / t;
        const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
        if (b <= resident || t == 32 || per_sm < k) {
            *blocks = (unsigned)(b < resident ? b : resident);
            *threads = (unsigned)t;
            return 0;
        }
    }
}

"""
# each single launch's grid: (rows argument, kernel)
LAUNCH_GRID = re.compile(
    r"unsigned blocks = 0;\n    const int err = grid_blocks<V>\(p, &blocks\);"
    r"\n    if \(err != 0\) return err;\n    const size_t smem = \(size_t\)"
    r"(\w) \* \(sizeof\(float\) \+ sizeof\(int\)\);\n    (\w+)<V><<<"
    r"blocks, FEDAGG_THREADS, smem, stream>>>")
RING_LAUNCH = (r"unsigned blocks = 0, threads = 0;\n    const size_t smem = "
               r"(size_t)\1 * (sizeof(float) + sizeof(int));\n    const int "
               r"err = ring_grid<V>(\2<V>, p, smem, &blocks, &threads);\n"
               r"    if (err != 0) return err;\n    \2<V><<<blocks, threads, "
               r"smem, stream>>>")

# name -> [(anchor, replacement, occurrences)]
VARIANTS = {
    "v0": [],
    "ring32": [(RING, "static constexpr int ROWS = 32;", 1)],
    "ring64": [(RING, "static constexpr int ROWS = 64;", 1)],
    "ring128": [(RING, "static constexpr int ROWS = sizeof(V) == 16 ? 32 "
                       ": 128;", 1)],
    "wide": [(THREADS, "long long t = FEDAGG_THREADS;", 1)],
    "single_ring": [(SUM_CALL, RING_CALL, 3),
                    (FIRST_KERNEL, RING_ROWS + FIRST_KERNEL, 1),
                    (FIRST_LAUNCH, RING_GRID + FIRST_LAUNCH, 1),
                    (LAUNCH_GRID, RING_LAUNCH, 3)],
}


def patched(name):
    """The variant's source text."""
    src = SOURCE.read_text()
    for old, new, times in VARIANTS[name]:
        if isinstance(old, re.Pattern):
            src, found = old.subn(new, src)
        else:
            found = src.count(old)
            src = src.replace(old, new)
        if found != times:
            raise SystemExit(f"fedagg_variants: {name}: anchor found "
                             f"{found} times, not {times}: "
                             f"{str(old)[:60]!r}")
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
            r"Compiling entry function '_Z\d+(fedagg_\w*?kernel)I(\w+?)"
            r"(?:Li(\d)E)?E[^']*'.*?(\d+) bytes spill stores.*?Used (\d+) "
            r"registers", out, re.S)
        print(json.dumps({"variant": name, "ptxas": [
            {"kernel": k, "vector": v, "mode": int(m) if m else None,
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


GRID_ROWS = (8, 32, 64, 128, 256, 512, 1024, 2048, SINGLE)
MODES = ("fedagg", "fedagg_fold", "fedagg_partial")


def grid_inputs(p, seed):
    """(4,096, p) rows, the global row and each mode's coefficients (no
    row masked: the grid times live rows)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(SINGLE, p, generator=gen, device="cuda")
    g = torch.randn(p, generator=gen, device="cuda")
    w = 40.0 + 40.0 * torch.rand(SINGLE, generator=gen, device="cuda")
    a = torch.rand(SINGLE, generator=gen, device="cuda")
    c = torch.rand(SINGLE, generator=gen, device="cuda")
    return u, g, w, a, c


def entry_call(lib, mode, route, u, g, w, a, c, rows):
    """A call of the mode's entry on ``rows`` rows of ``u`` (K2: rows - 1
    rows and ``rows`` coefficients, so the call holds ``rows``), through
    the single launch (``route`` "batch") or the tiled twin ("ring");
    returns (fn, out)."""
    import torch
    import chip_smoke
    from repro_torch.kernels import fedagg as fa
    out = torch.empty(u.shape[1], device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    x, y = {"fedagg": (w, a), "fedagg_fold": (g, c),
            "fedagg_partial": (c, None)}[mode]
    entry, args = chip_smoke.fedagg_entry(
        mode, u[:rows - 1] if mode == "fedagg_fold" else u, x, y, out)
    n = args[-3]                        # (..., out, n, p, vec)
    ws = (torch.empty(int(lib.fedagg_ws_floats(n)), device="cuda")
          if route == "ring" else None)

    def fn():
        if fa._launch(lib, entry, ws, args, stream) != 0:
            raise SystemExit(f"fedagg_variants: {entry} ({route}) failed")
    return fn, out


def crossover(names, libs, p, seed=36):
    """For each mode and each row count of ``GRID_ROWS`` at width ``p``:
    the single launch's batch loop (``batch``: v0's single entry), the
    tiled route (``ring``: v0's ``*_ws`` entry), each other variant's
    single entry, bit for bit against ``batch`` and timed in turns; the
    route the wrappers take (``fedagg.tiled_route``) and the bound.
    Calls rotate over the 4,096 // rows windows of the rows (no window
    found in the L2 at a second call but at 4,096 rows, 1.3 GB and
    more)."""
    import itertools

    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import fedagg as fa
    from repro_torch.roofline import cost
    u, g, w, a, c = grid_inputs(p, seed)
    lib_of = {}
    for name in names:
        use(libs[name])
        lib_of[name] = fa._lib()
    routes = [("batch", "v0", "batch"), ("ring", "v0", "ring")] + [
        (n, n, "batch") for n in names if n != "v0"]
    out, bad = [], []
    for rows in GRID_ROWS:
        wins = [slice(i * rows, (i + 1) * rows)
                for i in range(max(1, SINGLE // rows))]
        for mode in MODES:
            fns, outs = {}, {}
            for label, lib_name, route in routes:
                calls = [entry_call(lib_of[lib_name], mode, route, u[k],
                                    g, w[k], a[k], c[k], rows)
                         for k in wins]
                fns[label] = (lambda it: lambda: next(it)())(
                    itertools.cycle([f for f, _ in calls]))
                calls[0][0]()
                outs[label] = calls[0][1]
            torch.cuda.synchronize()
            for label in outs:
                if not torch.equal(outs[label], outs["batch"]):
                    bad.append(f"p={p} rows={rows} {mode}: {label} != batch")
            ms = {label: [] for label in fns}
            order = list(fns)
            for label in order + order[::-1]:
                ms[label].append(smoke.median_ms(fns[label], warmup=2,
                                                 runs=5, per_run=5))
            k0 = wins[0]
            bound = {"fedagg": lambda: cost.fedagg_bound_ms(w[k0] * a[k0], p),
                     "fedagg_fold": lambda: cost.fold_bound_ms(c[k0], p),
                     "fedagg_partial": lambda: cost.partial_bound_ms(c[k0],
                                                                     p)}
            best = {label: min(t) for label, t in ms.items()}
            row = {"p": p, "rows": rows, "mode": mode, "windows": len(wins),
                   "ms": best, "ms_turns": ms,
                   "bound_ms": bound[mode]()[0],
                   "ring_over_batch": best["ring"] / best["batch"],
                   "route": "ring" if fa.tiled_route(rows) else "batch"}
            out.append(row)
            print(json.dumps(row), flush=True)
    del u
    torch.cuda.empty_cache()
    return out, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (v0 is always built)")
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=FILE.cu: another source as variant NAME")
    ap.add_argument("--grid", choices=("no", "also", "only"), default="no",
                    help="the crossover grid of the single launch and the "
                         "tiled route (GRID_ROWS at resnet8's, 131,072 and "
                         "cnn-mnist's widths): beside the 8,192-row "
                         "checks and times, or alone")
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
    bad, res, grid = [], {}, []
    import chip_smoke
    widths = (chip_smoke.resnet8_p(), WIDE_P, chip_smoke.MAIN_P)
    for p in widths[:2] if args.grid != "only" else ():
        ins = inputs(p, seed=12)
        bad += [f"p={p}: {b}" for b in check(names, libs, ins)]
        print(json.dumps({"p": p, "bits": "equal" if not bad else bad}),
              flush=True)
        res[p] = times(names, libs, ins, p)
        del ins
        torch.cuda.empty_cache()
    for p in widths if args.grid != "no" else ():
        rows, failed = crossover(names, libs, p)
        grid += rows
        bad += failed
    print(card, flush=True)
    print(json.dumps({"card": card, "failed": bad, "times": res,
                      "grid": grid}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
