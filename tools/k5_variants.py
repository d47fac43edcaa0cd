#!/usr/bin/env python3
"""Variants of the selective-scan kernel (K5) on one GPU, timed in turns.

    python3 tools/k5_variants.py [--only v0,w4,...] [--baseline NAME=FILE.cu]

Each variant is the committed ``src/repro_torch/kernels/csrc/
ssm_scan.cu`` with text patches (and, with each ``--baseline``, another
source of the same entry point ``ssm_scan_fwd`` -- an earlier commit's
kernel, say -- as the variant NAME), built with ``nvcc -Xptxas -v`` into
``build/k5_variants/``: registers, shared memory and spills are
printed.  Every variant is held against ``ssm_scan_plain`` at
``chip_smoke.SS_TOL`` on edge cases of ``chip_smoke.py``: f32 and bf16,
with and without h0, S = 1, 17, 1000 and 4096, N = 4, 8, 16.  Then all
are timed with ``chip_smoke.median_ms`` (launches enqueued behind other
device work, so the reading is device time) at the serving path's two
shapes -- hymba's prefill (B=2, S=4096, D=3200, N=16, bf16) and a decode
step (B=4, S=1, carried h0) -- in turns: v0 first, then each variant,
then the order reversed.  The last line of standard output is one JSON
object of the times.  Needs one CUDA card and nvcc; exits non-zero
otherwise or when a variant disagrees.

Variants:
  v0        the committed kernel
  lpc2      two lanes a channel (N/2 states each, 16 channels a CTA, y
            a shuffle sum; four CTAs an SM)
  lpc4      four lanes a channel (N/4 states each; 8 channels a CTA)
  tb8, tb16       8 or 16 steps staged at a time (4 in v0)
  w4, w12, w16    4, 12 or 16 warps (time segments) a CTA
  seg32, seg128   segments of at most 32 or 128 steps
  seg512    segments of at most 512 steps: at S = 4096 one chunk a row,
            200 CTAs at the prefill shape instead of 1600 (the balance
            of one CTA a whole sequence)
  NAME      a source given with --baseline NAME=FILE.cu, as it is (an
            earlier source that takes no scratch is handed none)
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

OUT = ROOT / "build" / "k5_variants"


def replace(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"k5_variants: patch anchor not found once: "
                         f"{old[:60]!r}")
    return src.replace(old, new)


def constant(name, value):
    """A patch that sets the source's ``constexpr int name``."""
    def patch(src):
        pat = rf"constexpr int {name} = \d+;"
        if len(re.findall(pat, src)) != 1:
            raise SystemExit(f"k5_variants: constant {name} not found once")
        return re.sub(pat, f"constexpr int {name} = {value};", src)
    return patch


def warps(w):
    """``w`` time segments a chunk, and the CTAs an SM the register
    budget is set for: 2 at 8 warps, as many as 16 warps fill."""
    return [constant("SS_WARPS", w), constant("SS_MIN_BLOCKS",
                                              max(1, 16 // w))]


def lanes_a_channel(lanes):
    """``lanes`` lanes share a channel, N/lanes states each: lane = sub
    * (32/lanes) + c; sub 0 stages x, sub 1 dt (through the lane's "x"
    pointer); y is a shuffle sum over the channel's lanes."""
    def patch(src):
        src = replace(src, "constexpr int SS_MIN_BLOCKS = 2;",
                      "constexpr int SS_MIN_BLOCKS = 4;")
        src = replace(src, "constexpr int SS_CH = 32;          "
                      "// channels a CTA: one a lane",
                      f"constexpr int SS_LPC = {lanes};   // lanes a channel\n"
                      f"constexpr int SS_CH = 32 / SS_LPC;  // channels a CTA")
        src = replace(src, "SLOT = (N + 1) * 32;",
                      "SLOT = (N / SS_LPC + 1) * 32;")
        src = replace(src, "    int c;\n    bool ok;",
                      "    int c, sub;\n    bool ok;")
        # run_segment
        src = replace(src, """float (&h)[N],
                                            const float (&a2)[N],""",
                      """float (&h)[N / SS_LPC],
                                            const float (&a2)[N / SS_LPC],""")
        src = replace(src, """    if (t_begin >= t_end) return;             // warp-uniform
""", """    constexpr int NH = N / SS_LPC;
    if (t_begin >= t_end) return;             // warp-uniform
""")
        src = replace(src, "T px[SS_TB], pd[SS_TB], pb[KB];",
                      "T px[SS_TB], pb[KB];")
        src = replace(src, """            const bool in = c.ok && t0 + i < t_end;
            px[i] = in ? xp[i * c.xs] : zero_of<T>();
            pd[i] = in ? dp[i * c.dts] : zero_of<T>();""",
                      """            const bool in = c.ok && c.sub < 2 && t0 + i < t_end;
            px[i] = in ? xp[i * c.xs] : zero_of<T>();""")
        src = replace(src, """        const T* dp = c.dt + (long long)t0 * c.dts;
""", "")
        src = replace(src, """            xs[i * SS_CH + c.c] = to_f32(px[i]);
            ds[i * SS_CH + c.c] = to_f32(pd[i]);""",
                      """            if (c.sub < 2)
                (c.sub == 1 ? ds : xs)[i * SS_CH + c.c] = to_f32(px[i]);""")
        src = replace(src, """            const float* row = bcs + i * 2 * N;
            float bv[N], cv[N];
            load_row<N>(row, bv);
            if (WITH_Y) load_row<N>(row + N, cv);
            float yv = 0.0f;
#pragma unroll
            for (int n = 0; n < N; ++n) {""",
                      """            const float* row = bcs + i * 2 * N + c.sub * NH;
            float bv[NH], cv[NH];
            load_row<NH>(row, bv);
            if (WITH_Y) load_row<NH>(row + N, cv);
            float yv = 0.0f;
#pragma unroll
            for (int n = 0; n < NH; ++n) {""")
        src = replace(src, """                if (c.ok && t0 + i < t_end)
                    store_as(""", """#pragma unroll
                for (int off = SS_CH; off < 32; off <<= 1)
                    yv += __shfl_xor_sync(0xffffffffu, yv, off);
                if (c.ok && c.sub == 0 && t0 + i < t_end)
                    store_as(""")
        # the scan kernel: NH states a lane, from the lane's first, n0
        i = src.index("ssm_scan_kernel(const T*")
        j = src.index("// S = 1: one step from h0")
        body = src[i:j]
        body = replace(body, "    using SM = SsSmem<N>;\n",
                       "    using SM = SsSmem<N>;\n"
                       "    constexpr int NH = N / SS_LPC;\n")
        body = replace(body, "    c.c = lane;\n",
                       "    c.c = lane % SS_CH;\n    c.sub = lane / SS_CH;\n"
                       "    const int n0 = c.sub * NH;\n")
        body = replace(body, "a_log[(long long)d * N + n]",
                       "a_log[(long long)d * N + n0 + n]")
        body = replace(body, """    c.x = x + b * st.x_b + dd * st.x_d;
    c.xs = st.x_s;""", """    const bool lane_dt = c.sub == 1;        // stages dt as "x"
    c.x = lane_dt ? dt + b * st.dt_b + dd * st.dt_d
                  : x + b * st.x_b + dd * st.x_d;
    c.xs = lane_dt ? st.dt_s : st.x_s;""")
        body = replace(body, "dd) * N;", "dd) * N + n0;")
        body = body.replace("[N];", "[NH];").replace("n < N;", "n < NH;")
        body = body.replace("* N * 32", "* NH * 32").replace(
            "[N * 32 + lane]", "[NH * 32 + lane]")
        src = src[:i] + body + src[j:]
        return replace(src, "return items * N * 32;",
                       "return items * (N / SS_LPC) * 32;")
    return [patch]


# name -> patches of the committed source
VARIANTS = {"v0": [],
            "lpc2": lanes_a_channel(2), "lpc4": lanes_a_channel(4),
            "tb8": [constant("SS_TB", 8)], "tb16": [constant("SS_TB", 16)],
            "w4": warps(4), "w12": warps(12), "w16": warps(16),
            "seg32": [constant("SS_SEG", 32)],
            "seg128": [constant("SS_SEG", 128)],
            "seg512": [constant("SS_SEG", 512)]}
# (name, b, s, d, n, dtype, with h0)
CASES = [("kernel-test-2x64x32x8", 2, 64, 32, 8, "float32", False),
         ("n16-s1-h0", 2, 1, 200, 16, "float32", True),
         ("n8-s1-h0-bf16", 2, 1, 200, 8, "bfloat16", True),
         ("s17-h0", 2, 17, 200, 16, "float32", True),
         ("s1000-h0", 2, 1000, 200, 16, "float32", True),
         ("s1000-h0-bf16", 2, 1000, 200, 16, "bfloat16", True),
         ("n4-2x300x3200-bf16", 2, 300, 3200, 4, "bfloat16", False),
         ("hymba-2x4096x3200x16-bf16", 2, 4096, 3200, 16, "bfloat16",
          False)]
SHAPES = {"prefill": (2, 4096, False), "decode": (4, 1, True)}


def patched(name, src):
    for patch in VARIANTS[name]:
        src = patch(src)
    return src


def build(sources):
    """Build every (name -> source file) in parallel; name -> (library,
    ptxas lines)."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
             "-o", str(OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k5_variants: {name} failed to build:\n{out}")
        keep = [ln.strip() for ln in out.splitlines()
                if "Compiling entry" in ln or "registers" in ln
                or "spill" in ln]
        libs[name] = (ctypes.CDLL(str(OUT / f"lib{name}.so")), keep)
    return libs


def use(lib):
    """Route ``ssm_scan`` to ``lib``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as ss
    lib.ssm_scan_fwd.argtypes = ss._ARGTYPES
    lib.ssm_scan_fwd.restype = ctypes.c_int
    try:
        lib.ssm_scan_scratch.argtypes = ss._SCRATCH_ARGTYPES
        lib.ssm_scan_scratch.restype = ctypes.c_longlong
    except AttributeError:      # an earlier source: no scratch
        lib.ssm_scan_scratch = lambda *args: 1
    _build._LIBS["ssm_scan"] = lib


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (v0 is always built)")
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="NAME=FILE.cu",
                    help="another ssm_scan.cu, built and timed as NAME "
                         "(repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device", file=sys.stderr)
        return 1
    names = ["v0"] + [n for n in args.only.split(",") if n and n != "v0"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"k5_variants: unknown variants {unknown}")
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as ss
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    committed = (_build.CSRC / "ssm_scan.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name in names:
        sources[name] = OUT / f"{name}.cu"
        sources[name].write_text(patched(name, committed))
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        if not path or name in sources:
            raise SystemExit(f"k5_variants: --baseline {spec!r}: want a "
                             f"new NAME=FILE.cu")
        sources[name] = Path(path)
        names.append(name)
    libs = build(sources)
    for name in names:
        print(json.dumps({"variant": name, "ptxas": libs[name][1]}),
              flush=True)
    bad = []
    for name in names:
        use(libs[name][0])
        gen = torch.Generator(device="cuda").manual_seed(12)
        worst = {}
        for cname, b, s, d, n, dtype, with_h0 in CASES:
            x, dt, bi, co, al = chip_smoke.ssm_inputs(
                gen, b, s, d, n, getattr(torch, dtype))
            h0 = (torch.randn(b, d, n, generator=gen, device="cuda")
                  if with_h0 else None)
            try:
                got = chip_smoke.check_ssm(cname, x, dt, bi, co, al, h0)
            except SystemExit as e:           # check_ssm's failure
                bad.append(f"{name}: {e}")
                continue
            worst[cname] = [got["max_abs_err"], got["h_end_max_abs_err"]]
        print(json.dumps({"variant": name, "max_abs_err_y_h": worst}),
              flush=True)
    times = {}
    for shape, (b, s, with_h0) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(13)
        x, dt, bi, co, al = chip_smoke.ssm_inputs(gen, b, s, 3200, 16,
                                                  torch.bfloat16)
        h0 = (torch.randn(b, 3200, 16, generator=gen, device="cuda")
              if with_h0 else None)
        times[shape] = {}
        for name in names + names[::-1]:
            use(libs[name][0])
            times[shape].setdefault(name, []).append(chip_smoke.median_ms(
                lambda: ss.ssm_scan(x, dt, bi, co, al, h0)))
        print(json.dumps({"shape": shape, "ms": times[shape]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "failed": bad, "ms": times}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
