#!/usr/bin/env python3
"""Variants of K4's f32 backward kernels (dq, dkdv) on one GPU, timed in
turns.

    python3 tools/k4_bwd_variants.py [--only v0,rna,rnahi]
                                     [--baseline NAME=FILE.cu ...]

Each variant is the committed ``src/repro_torch/kernels/csrc/
flash_attention_bwd.cu`` with text patches (and, with each
``--baseline``, another source of the same two entry points -- an
earlier commit's kernels, say -- as the variant NAME), built with ``nvcc
-Xptxas -v`` into ``build/k4_bwd_variants/``, all at once: registers and
spills are printed.  Every variant goes through the wrapper
(``FlashAttentionFn``) and ``chip_smoke.check_flash_bwd`` on edge cases
of ``chip_smoke.py`` (with its head dims 80, 128 and 192:
``WIDE_HEAD_CASES``, ``WIDE_BWD_EDGE_CASES``) and the two training
layers, at ``BWD_RTOL`` /
``BWD_ATOL``.  Then all are timed with
``chip_smoke.median_ms`` (launches enqueued behind other device work, so
the reading is device time) at ``chip_smoke.FA_BWD_LAYERS``, each kernel
launched directly, in turns: the variants in order, then reversed.  The
last line of standard output is one JSON object of the times and the
checks.  Needs one CUDA card and nvcc; exits non-zero otherwise or when
a variant disagrees.  (The one-TF32-product fault is a mutant of
``tools/block_grad_mutants.py``: ``fa_tf32_single``.)

Variants:
  v0        the committed kernels (hi = x with its low 13 mantissa bits
            cleared, lo = x - hi passed whole)
  rna       hi and lo each rounded by cvt.rna.tf32.f32 (the textbook
            split)
  rnahi     hi rounded to nearest by an integer add before the mask,
            lo = x - hi passed whole
  wu1, wu2  at D = 128 and 192, the S and dP products' k-steps of 16
            unrolled 1 or 2 at a time (the committed kernels: 4)
  kv32      dkdv at D = 128 on q tiles of 32 rows (16 a warp of the pair;
            152 KB of shared memory) in place of 48
  d80kv48   dkdv at D = 80 on q tiles of 48 rows in place of 64
  d80m32    both kernels at D = 80 on moving tiles of 32 rows
  NAME      a source given with --baseline NAME=FILE.cu, as it is
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "k4_bwd_variants"
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"

SPLIT = """    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));"""
RNA = """    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));"""
RNA_HI = """    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));"""

UNROLL = "#define FB_WIDE_UNROLL 4"
MROWS = "return D <= 80 ? 64 : D == 128 ? (DKDV ? 48 : 64) : 32;"

# name -> [(anchor, replacement)]; each anchor occurs once
VARIANTS = {
    "v0": [],
    "rna": [(SPLIT, RNA)],
    "rnahi": [(SPLIT, RNA_HI)],
    "wu1": [(UNROLL, "#define FB_WIDE_UNROLL 1")],
    "wu2": [(UNROLL, "#define FB_WIDE_UNROLL 2")],
    "kv32": [(MROWS, MROWS.replace("(DKDV ? 48 : 64)",
                                   "(DKDV ? 32 : 64)"))],
    # D = 80 (hubert): 48-row dkdv items, or 32-row moving tiles in both
    "d80kv48": [(MROWS, MROWS.replace(
        "D <= 80 ? 64 :", "D <= 64 ? 64 : D == 80 ? (DKDV ? 48 : 64) :"))],
    "d80m32": [(MROWS, MROWS.replace(
        "D <= 80 ? 64 :", "D <= 64 ? 64 : D == 80 ? 32 :"))],
}


def patched(name):
    """The variant's source text."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"k4_bwd_variants: {name}: anchor not found "
                             f"once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(sources):
    """name -> library path; prints each kernel's registers and spills."""
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
            raise SystemExit(f"k4_bwd_variants: {name} failed to build:\n"
                             f"{out}")
        kernels = re.findall(
            r"Compiling entry function '_Z\d+(fa_bwd_\w+?_kernel)I"
            r"((?:Li\d+E)+)E.*?(\d+) bytes spill stores.*?Used (\d+) "
            r"registers", out, re.S)
        print(json.dumps({"variant": name, "ptxas": [
            {"kernel": k, "template": re.findall(r"Li(\d+)E", args),
             "spill_stores": int(sp), "registers": int(r)}
            for k, args, sp, r in kernels]}), flush=True)
        libs[name] = OUT / f"lib{name}.so"
    return libs


def use(path):
    """Route the wrapper to the library at ``path``; return it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    lib = ctypes.CDLL(str(path))
    for fn in (lib.flash_attention_bwd_dq_f32,
               lib.flash_attention_bwd_dkdv_f32):
        fn.argtypes = fa._BWD_ARGTYPES
        fn.restype = ctypes.c_int
    _build._LIBS["flash_attention_bwd"] = lib
    return lib


# (name, (b, s, t, h, hkv, d), masks): edge cases of kernel_bwd_checks
# and the two training layers
CASES = (("group5-130-causal", (2, 130, 130, 5, 1, 64), {}),
         ("ragged-91x157-d16", (2, 91, 157, 6, 2, 16),
          {"window": 40, "q_offset": 66}),
         ("some-rows-see-no-key", (1, 64, 128, 4, 2, 64),
          {"causal": False, "window": 32, "q_offset": 140}),
         ("hymba-layer", (1, 2048, 2048, 25, 5, 64), {"window": 1024}),
         ("llama-layer", (2, 2048, 2048, 32, 8, 64), {}))


def check(smoke, names):
    """Each variant against autograd of the plain twin; returns name ->
    {case: errors or the failure}, and whether every variant passed."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(20)
    inputs = []
    for case, (b, s, t, h, hkv, d), kw in (CASES + smoke.WIDE_HEAD_CASES
                                           + smoke.WIDE_BWD_EDGE_CASES):
        def r(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        inputs.append((case, (r(b, s, h, d), r(b, t, hkv, d),
                              r(b, t, hkv, d), r(b, s, h, d)), kw))
    out, ok = {}, True
    for name in names:
        use(OUT / f"lib{name}.so")
        out[name] = {}
        for case, ins, kw in inputs:
            try:
                row = smoke.check_flash_bwd(case, *ins, **kw)
                out[name][case] = {k: row[k] for k in row
                                   if k.endswith("_max_abs_err")}
            except SystemExit as e:
                out[name][case] = {"failed": str(e)}
                ok = False
        print(json.dumps({"variant": name, "checks": out[name]}),
              flush=True)
    return out, ok


def times(smoke, names):
    """(dq ms, dkdv ms) of each variant at each training shape, in
    turns."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    res = {}
    for arch, qs, ks, window, causal in smoke.FA_BWD_LAYERS:
        gen = torch.Generator(device="cuda").manual_seed(23)
        q = torch.randn(qs, generator=gen, device="cuda")
        k = torch.randn(ks, generator=gen, device="cuda")
        v = torch.randn(ks, generator=gen, device="cuda")
        do = torch.randn(qs, generator=gen, device="cuda")
        o, lse, _ = fa._kernel_forward(q, k, v, causal, window, 0,
                                    with_lse=True)
        b, s, h, d = qs
        t, hkv = ks[1], ks[2]
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty((b, h, s), device="cuda")
        args = (b, s, t, h, hkv, d, int(causal), window, 0,
                1.0 / math.sqrt(d))
        res[arch] = {n: {"dq": [], "dkdv": []} for n in names}
        for name in list(names) + list(reversed(names)):
            lib = use(OUT / f"lib{name}.so")

            def dq_kernel():
                lib.flash_attention_bwd_dq_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), *args,
                    torch.cuda.current_stream().cuda_stream)

            def dkdv_kernel():
                lib.flash_attention_bwd_dkdv_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), *args,
                    torch.cuda.current_stream().cuda_stream)

            dq_kernel()                    # delta for the dkdv timing
            res[arch][name]["dq"].append(
                smoke.median_ms(dq_kernel, runs=5, per_run=3))
            res[arch][name]["dkdv"].append(
                smoke.median_ms(dkdv_kernel, runs=5, per_run=3))
        print(json.dumps({"arch": arch, "ms_turns": res[arch]}), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=FILE.cu: another source as variant NAME")
    args = ap.parse_args(argv)
    names = [n for n in args.only.split(",") if n]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"k4_bwd_variants: unknown {unknown}")
    sources = {n: patched(n) for n in names}
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        if not name or not path or name in sources:
            raise SystemExit(f"k4_bwd_variants: --baseline {spec!r}: want "
                             f"a new NAME=FILE.cu")
        sources[name] = Path(path).read_text()
    import torch
    if not torch.cuda.is_available():
        print("k4_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch import set_full_f32
    set_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    build(sources)
    checks, ok = check(smoke, list(sources))
    res = times(smoke, list(sources))
    print(json.dumps({"card": card, "checks": checks, "ms_turns": res}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
