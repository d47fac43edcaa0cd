#!/usr/bin/env python3
"""Variants of K4's f32 backward kernels (dq, dkdv) on one GPU, timed in
turns.

    python3 tools/k4_bwd_variants.py [--only v0,rna,rnahi] [--scaled]
                                     [--baseline NAME=FILE.cu ...]

Each variant is the committed ``src/repro_torch/kernels/csrc/
flash_attention_bwd.cu`` with text patches (and, with each
``--baseline``, another source of the same two entry points -- an
earlier commit's kernels, say -- as the variant NAME), built with ``nvcc
-Xptxas -v`` into ``build/k4_bwd_variants/``, all at once: registers and
spills are printed.  A source that declares the pair's softcap
instantiations (the committed one, and so each variant) carries them:
the launches of ``flash_attention_bwd_softcap.cu`` appended to its text
(one translation unit).  Every variant goes through the wrapper
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
``tools/block_grad_mutants.py``: ``fa_tf32_single``.)  With
``--scaled``, each variant's gradients at llama3.2-1b's training layer
(q (2,2048,32,64), kv 8, causal), with the cap of 50 and without, on
normal q scaled by 1 and by 100, through ``flash_attention`` (the
committed forward with lse, the variant's pair): each gradient's max
abs distance from autograd of the f32 twin and from an f64 answer, and
the twin's from that answer (reported, not gated).

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


# the pair's softcap launches (flash_attention_bwd_softcap.cu after its
# include of flash_attention_bwd.cu), appended to a variant's text
CAPPED = (SOURCE.parent / "flash_attention_bwd_softcap.cu").read_text() \
    .split('#include "flash_attention_bwd.cu"', 1)[1]


def with_softcap(src):
    """``src`` and, where it declares them, its softcap instantiations."""
    return src + CAPPED if "fb_dq_softcap" in src else src


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
        cu.write_text(with_softcap(text))
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
            r"((?:L[ib]\d+E)+)E.*?(\d+) bytes spill stores.*?Used (\d+) "
            r"registers", out, re.S)
        print(json.dumps({"variant": name, "ptxas": [
            {"kernel": k + ("+cap" if "Lb1E" in args else ""),
             "template": re.findall(r"Li(\d+)E", args),
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
                    torch.cuda.current_stream().cuda_stream, 0.0)

            def dkdv_kernel():
                lib.flash_attention_bwd_dkdv_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), *args,
                    torch.cuda.current_stream().cuda_stream, 0.0)

            dq_kernel()                    # delta for the dkdv timing
            res[arch][name]["dq"].append(
                smoke.median_ms(dq_kernel, runs=5, per_run=3))
            res[arch][name]["dkdv"].append(
                smoke.median_ms(dkdv_kernel, runs=5, per_run=3))
        print(json.dumps({"arch": arch, "ms_turns": res[arch]}), flush=True)
    return res


# llama3.2-1b's training layer: (b, s, h, hkv, d), causal
SCALED_SHAPE = (2, 2048, 32, 8, 64)
SCALED_FACTORS = (1.0, 100.0)
SCALED_CAPS = (50.0, 0.0)


def f64_grads(q, k, v, do, cap):
    """dq, dk, dv of causal GQA attention with the softcap ``cap`` (0:
    none) in f64, one batch row at a time."""
    import torch
    h, d = q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    out = ([], [], [])
    for i in range(q.shape[0]):
        qi, ki, vi = (x[i].double().movedim(1, 0).requires_grad_(True)
                      for x in (q, k, v))
        sc = torch.einsum("hsd,htd->hst", qi,
                          ki.repeat_interleave(rep, 0)) / math.sqrt(d)
        if cap > 0:
            sc = torch.tanh(sc / cap) * cap
        keep = torch.ones(sc.shape[1:], dtype=torch.bool,
                          device=q.device).tril()
        p = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
        o = torch.einsum("hst,htd->hsd", p, vi.repeat_interleave(rep, 0))
        g = torch.autograd.grad(o, (qi, ki, vi),
                                do[i].double().movedim(1, 0))
        for acc, x in zip(out, g):
            acc.append(x.movedim(0, 1))
        del sc, p, o, g
    return [torch.stack(x) for x in out]


def scaled(smoke, names):
    """Per variant, cap and q factor: each gradient's max abs distance
    from the f32 twin's (autograd of ``gqa_plain``) and from an f64
    answer, and the twin's from it."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, s, h, hkv, d = SCALED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(45)
    q, do = (torch.randn(b, s, h, d, generator=gen, device="cuda")
             for _ in "qd")
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
            for _ in "kv")
    res = {}
    for factor in SCALED_FACTORS:
        qs = q * factor
        for cap in SCALED_CAPS:
            exact = f64_grads(qs, k, v, do, cap)
            ref = [x.detach().requires_grad_(True) for x in (qs, k, v)]
            twin = torch.autograd.grad(fa.gqa_plain(*ref, softcap=cap), ref,
                                       do)
            key = f"q_x{factor:g}_cap{cap:g}"
            res[key] = {"twin_vs_f64": {
                t: float((a.double() - e).abs().max())
                for t, a, e in zip(("dq", "dk", "dv"), twin, exact)},
                "f64_max": {t: float(e.abs().max())
                            for t, e in zip(("dq", "dk", "dv"), exact)}}
            for name in names:
                use(OUT / f"lib{name}.so")
                ins = [x.detach().requires_grad_(True) for x in (qs, k, v)]
                got = torch.autograd.grad(
                    fa.flash_attention(*ins, softcap=cap), ins, do)
                res[key][name] = {
                    t: {"vs_twin": float((a - w).abs().max()),
                        "vs_f64": float((a.double() - e).abs().max())}
                    for t, a, w, e in zip(("dq", "dk", "dv"), got, twin,
                                          exact)}
            print(json.dumps({"scaled": key, **res[key]}), flush=True)
            del exact, twin
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=FILE.cu: another source as variant NAME")
    ap.add_argument("--scaled", action="store_true",
                    help="the gradients on q x 1 and x 100 at llama's "
                         "training layer, with and without the cap, "
                         "against the twin and an f64 answer")
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
    sc = scaled(smoke, list(sources)) if args.scaled else {}
    print(card, flush=True)
    print(json.dumps({"card": card, "checks": checks, "ms_turns": res,
                      "scaled": sc}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
