#!/usr/bin/env python3
"""Variants of K4's f32 backward kernels (dq, dkdv) on one GPU, timed in
turns.

    python3 tools/k4_bwd_variants.py [--only v0,one_sum,rna] [--scaled]
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
``tools/block_grad_mutants.py``: ``fa_tf32_single``.)

With ``--scaled`` each variant's pair goes with a forward built with the
same patch (``csrc/flash_attention.cu`` and its softcap launches, the
variant's patch of the split or of the split product applied to it too;
the committed forward for the other variants), so the pair recomputes S
as the forward that summed its lse formed it.  Each variant then also
runs the capped forward (cap 50) on normal q x 1 and x 100 at
llama3.2-1b's serving layer (q (2,4096,32,64), kv 8, causal; three
draws of q x 100) and on q x 100 at every head dim under
``chip_smoke.SOFTCAP_MASKS``: the output's max abs distance from the f32
twin and from an f64 answer, the twin's, and their ratio (the gate of
``chip_smoke.check_against_f64``); its gradients at the training layer
(q (2,2048,32,64), kv 8, causal), with the cap of 50 and without, on q x
1 and x 100, against autograd of the twin and an f64 answer (reported,
not gated); and the forward with lse is timed beside the pair at
``FA_BWD_LAYERS``.  ``tools/k4_variants.py --scaled`` runs this same
mode on its f32 split variants.

Variants (each of the first five also patches the forward under
--scaled):
  v0        the committed kernels: csrc/tf32_split.cuh (hi and lo each
            rounded to nearest by an integer add and a mask), the score
            products (S, dP) summed from zero a k-step and added in f32,
            above D = 64 the odd k-steps in a second sum
            (csrc/tf32_mma.cuh: score_step), their k-steps of 16
            unrolled 2 at a time there
  rna       hi and lo each rounded by cvt.rna.tf32.f32 (the textbook
            split)
  rnahi     hi rounded to nearest by an integer add before the mask,
            lo = x - hi passed whole (truncated by the product)
  one_sum   the score sums of one running sum at every D, unrolled 4
  chained   the score products chained on the tensor cores, every
            k-step added to the running sum there, unrolled 4
  trunc_chained
            chained, with the first split (hi = x with its low 13
            mantissa bits cleared, lo = x - hi passed whole): the
            arithmetic of the kernels before the shared split
  wu1       above D = 64, the S and dP products' k-steps of 16 unrolled
            1 at a time
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

FWD_SOURCE = SOURCE.parent / "flash_attention.cu"
# each f32 source's include of the shared split (csrc/tf32_split.cuh),
# which a split variant replaces with its own tf32_split
SPLIT_INCLUDE = {
    "pair": '#include "tf32_split.cuh"    // tf32_split: the forward\'s split\n',
    "forward": '#include "tf32_split.cuh"    // tf32_split: the f32 '
               'kernels\' operands\n'}
# tf32_split's bodies: the first split (hi truncated, lo passed whole and
# truncated by the product), cvt.rna for both parts, and hi alone
# rounded by an integer add
TRUNC = """    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));"""
RNA = """    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));"""
RNA_HI = """    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));"""


def own_split(body, where="pair"):
    """(anchor, replacement): the source's include of the shared split
    replaced by a tf32_split of ``body``."""
    return (SPLIT_INCLUDE[where],
            "__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,"
            "\n                                           uint32_t& lo) {\n"
            f"{body}\n}}\n")


# each f32 source's include of the shared split products
# (csrc/tf32_mma.cuh), which a variant of the score sums replaces with the
# header's text patched, in the forward and the pair alike
MMA_HEADER = SOURCE.parent / "tf32_mma.cuh"
MMA_INCLUDE = {
    "pair": '#include "tf32_mma.cuh"      // mma3, score_step: the '
            'forward\'s products\n',
    "forward": '#include "tf32_mma.cuh"      // mma3, score_step: their '
               'products\n'}
# score_step's body: the two k-steps' sums, the odd ones apart above D = 64
SCORE_STEP = """    mma3_from_zero(even, a0h, a0l, bh[0], bh[1], bl[0], bl[1]);
    if constexpr (D > 64)
        mma3_from_zero(odd, a1h, a1l, bh[2], bh[3], bl[2], bl[3]);
    else
        mma3_from_zero(even, a1h, a1l, bh[2], bh[3], bl[2], bl[3]);
"""
# the score sums of the first design (both k-steps chained on the tensor
# cores into one running sum) and of one sum at every D (each k-step from
# zero, added in f32)
CHAINED = """    mma3(even, a0h, a0l, bh[0], bh[1], bl[0], bl[1]);
    mma3(even, a1h, a1l, bh[2], bh[3], bl[2], bl[3]);
"""
ONE_SUM = """    mma3_from_zero(even, a0h, a0l, bh[0], bh[1], bl[0], bl[1]);
    mma3_from_zero(even, a1h, a1l, bh[2], bh[3], bl[2], bl[3]);
"""


def own_sums(body, where="pair"):
    """(anchor, replacement): the source's include of the shared products
    replaced by the header's text with score_step's body ``body``."""
    text = MMA_HEADER.read_text()
    if text.count(SCORE_STEP) != 1:
        raise SystemExit("k4_bwd_variants: score_step's body not found "
                         "once in tf32_mma.cuh")
    return (MMA_INCLUDE[where], text.replace(SCORE_STEP, body))


UNROLL = "#define FB_WIDE_UNROLL 2"
# the S (and the pair's dP) products' k-steps of 16 unrolled u at a time
# above D = 64 (v0: 2; the first design's 4 spill beside two sums)
WIDE_UNROLL = {
    "pair": lambda u: (UNROLL, f"#define FB_WIDE_UNROLL {u}"),
    "forward": lambda u: ("#define FA_WIDE_UNROLL 2",
                          f"#define FA_WIDE_UNROLL {u}")}
MROWS = "return D <= 80 ? 64 : D == 128 ? (DKDV ? 48 : 64) : 32;"


def split_variants(where):
    """name -> the patches of the variants of the split and of the score
    sums, on the pair's or the forward's source."""
    return {"rna": [own_split(RNA, where)],
            "rnahi": [own_split(RNA_HI, where)],
            "chained": [own_sums(CHAINED, where), WIDE_UNROLL[where](4)],
            "trunc_chained": [own_split(TRUNC, where),
                              own_sums(CHAINED, where),
                              WIDE_UNROLL[where](4)],
            "one_sum": [own_sums(ONE_SUM, where), WIDE_UNROLL[where](4)]}


# name -> [(anchor, replacement)]; each anchor occurs once
VARIANTS = {
    "v0": [],
    **split_variants("pair"),
    "wu1": [(UNROLL, "#define FB_WIDE_UNROLL 1")],
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


# the forward's text for each variant that changes the split or the
# score sums: the same patch, so the pair recomputes S as the forward
# that summed its lse formed it; every other variant takes the committed
# forward
FWD_VARIANTS = split_variants("forward")
# the forward's softcap launches (flash_attention_softcap.cu after its
# include of flash_attention.cu), appended to a forward's text
FWD_CAPPED = (SOURCE.parent / "flash_attention_softcap.cu").read_text() \
    .split('#include "flash_attention.cu"', 1)[1]


def _apply(name, src, patches):
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"k4_bwd_variants: {name}: anchor not found "
                             f"once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def patched(name):
    """The variant's source text."""
    return _apply(name, SOURCE.read_text(), VARIANTS[name])


def patched_forward(name):
    """The forward's source text that goes with the variant's pair."""
    return _apply(name, FWD_SOURCE.read_text(), FWD_VARIANTS.get(name, []))


def build(sources, forwards=None):
    """name -> library path; prints each kernel's registers and spills.
    ``forwards`` (name -> forward text), each built beside as
    ``libfwd_<name>.so`` with its softcap launches."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    units = {**{n: with_softcap(t) for n, t in sources.items()},
             **{f"fwd_{n}": t + FWD_CAPPED
                for n, t in (forwards or {}).items()}}
    for name, text in units.items():
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
            r"Compiling entry function '_Z\d+(fa_(?:bwd_\w+?|fwd_f32)_kernel)I"
            r"((?:L[ib]\d+E)+)E.*?(\d+) bytes spill stores.*?Used (\d+) "
            r"registers", out, re.S)
        print(json.dumps({"variant": name, "ptxas": [
            {"kernel": k + ("+cap" if "Lb1E" in args else ""),
             "template": re.findall(r"Li(\d+)E", args),
             "spill_stores": int(sp), "registers": int(r)}
            for k, args, sp, r in kernels]}), flush=True)
        libs[name] = OUT / f"lib{name}.so"
    return libs


def use(path, forward=None):
    """Route the wrapper to the pair's library at ``path`` (and, given
    one, to the forward's at ``forward``); return the pair's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    if forward is not None:
        _build._LIBS["flash_attention"] = ctypes.CDLL(str(forward))
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


# name -> the forward library built with the variant's split (--scaled)
FORWARDS = {}


def route(name):
    """Route the wrapper to the variant's pair (and, under --scaled, its
    forward); return the pair's library."""
    return use(OUT / f"lib{name}.so", FORWARDS.get(name))


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
        route(name)
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
    turns; under --scaled also its forward with lse (fwd ms)."""
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
        res[arch] = {n: {"dq": [], "dkdv": [],
                         **({"fwd": []} if n in FORWARDS else {})}
                     for n in names}
        for name in list(names) + list(reversed(names)):
            lib = route(name)

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
            if name in FORWARDS:
                res[arch][name]["fwd"].append(smoke.median_ms(
                    lambda: fa._kernel_forward(q, k, v, causal, window, 0,
                                               with_lse=True),
                    runs=5, per_run=3))
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


# llama3.2-1b's serving layer: (b, s, h, hkv, d), causal, the cap 50
SERVE_SHAPE = (2, 4096, 32, 8, 64)


def _vs_f64(got, twin, exact):
    """The kernel's and the twin's max abs and root-mean-square distances
    from the f64 answer, and their ratios."""
    kd, td = got.double() - exact, twin.double() - exact
    row = {"kernel_vs_twin": float((got.float() - twin).abs().max()),
           "kernel_vs_f64": float(kd.abs().max()),
           "twin_vs_f64": float(td.abs().max()),
           "kernel_rms_vs_f64": float(kd.square().mean().sqrt()),
           "twin_rms_vs_f64": float(td.square().mean().sqrt())}
    row["kernel_over_twin_vs_f64"] = (row["kernel_vs_f64"]
                                      / max(row["twin_vs_f64"], 1e-30))
    row["kernel_over_twin_rms"] = (row["kernel_rms_vs_f64"]
                                   / max(row["twin_rms_vs_f64"], 1e-30))
    return row


def exact_scores_twin(q, k, v, cap, **kw):
    """``gqa_plain``'s f32 arithmetic from the raw scores q.k computed in
    f64 and rounded once to f32: how far the twin's own f32 scores move
    its distance from the f64 answer."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, s, h, d = q.shape
    kx, vx = (fa.repeat_kv_heads(x, h) for x in (k, v))
    sc = torch.einsum("bshd,bthd->bhst", q.double(), kx.double()).float()
    sc = fa.softcap_scores(sc / math.sqrt(d), cap)
    m = fa._mask(s, k.shape[1], kw.get("causal", True), kw.get("window", 0),
                 kw.get("q_offset", 0), q.device)
    sc = torch.where(m, sc, torch.full((), fa.NEG, device=q.device))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(sc, dim=-1),
                        vx.float())


def smoke_cases(smoke):
    """The f32 cases on q x 100 (cap 50) that ``chip_smoke.py``'s
    ``softcap_checks`` and ``softcap_bwd_checks`` hold against f64, on
    those phases' own draws (their generators replayed, the bf16 draws
    skipped): (name, q, k, v, masks)."""
    import torch
    cap = smoke.SERVE_SOFTCAP
    cases = []
    for phase, seed, names in (("softcap_checks", 13, "qkv"),
                               ("softcap_bwd_checks", 41, "qdkv")):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for d in smoke.HEAD_DIMS:
            for dtype in (torch.float32, torch.bfloat16):
                for b, s, t, h, hkv, causal, window, off in \
                        smoke.SOFTCAP_MASKS:
                    x = {n: torch.randn(b, s if n in "qd" else t,
                                        h if n in "qd" else hkv, d,
                                        generator=gen, device="cuda")
                         for n in names}
                    if dtype == torch.float32:
                        cases.append((
                            f"{phase}-d{d}-{'causal' if causal else 'full'}"
                            f"-w{window}-off{off}-q_x100",
                            x["q"] * (2 * cap), x["k"], x["v"],
                            dict(causal=causal, window=window,
                                 q_offset=off)))
    return cases


def scaled_forward(smoke, names, draws=1):
    """Per variant: the capped forward (cap 50) on normal q x 1 and x 100
    at llama's serving layer (three draws of q x 100), and on q x 100 at
    every head dim under ``chip_smoke.SOFTCAP_MASKS`` (the cases of
    ``softcap_checks``; ``draws`` draws of each): its max abs distance
    from the f32 twin and from an f64 answer, the twin's from it, and
    their ratio (the chip_smoke gate: at most ``F32_LARGE_TERM_RATIO`` on
    q x 100)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    cap = smoke.SERVE_SOFTCAP
    cases = []
    b, s, h, hkv, d = SERVE_SHAPE
    for seed, factors in ((10, SCALED_FACTORS), (11, (100.0,)),
                          (12, (100.0,))):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn(b, s, h, d, generator=gen, device="cuda")
        k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
                for _ in "kv")
        cases += [(f"llama-serve-seed{seed}-q_x{f:g}", q * f, k, v,
                   dict(causal=True)) for f in factors]
    cases += smoke_cases(smoke)
    gen = torch.Generator(device="cuda").manual_seed(14)
    for draw in range(1, draws):
        for d in smoke.HEAD_DIMS:
            for b, s, t, h, hkv, causal, window, off in smoke.SOFTCAP_MASKS:
                q = torch.randn(b, s, h, d, generator=gen, device="cuda")
                k, v = (torch.randn(b, t, hkv, d, generator=gen,
                                    device="cuda") for _ in "kv")
                cases.append((f"d{d}-{'causal' if causal else 'full'}"
                              f"-w{window}-off{off}-draw{draw}-q_x100",
                              q * 100.0, k, v,
                              dict(causal=causal, window=window,
                                   q_offset=off)))
    truth, ideal = [], {}
    for case, q, k, v, kw in cases:
        twin = fa.gqa_plain(q, k, v, softcap=cap, **kw)
        exact = smoke.f64_attention(q, k, v, cap, **kw)
        truth.append((twin, exact))
        ideal[case] = float((exact_scores_twin(q, k, v, cap, **kw).double()
                             - exact).abs().max())
    res = {}
    for name in names:
        route(name)
        res[name] = {}
        for (case, q, k, v, kw), (twin, exact) in zip(cases, truth):
            got = fa.flash_attention(q, k, v, softcap=cap, **kw)
            res[name][case] = {**_vs_f64(got, twin, exact),
                               "exact_scores_twin_vs_f64": ideal[case]}
        gated = sorted(r["kernel_over_twin_vs_f64"]
                       for c, r in res[name].items() if "q_x100" in c)
        res[name]["worst_ratio_on_q_x100"] = gated[-1]
        res[name]["cases_over_1_5"] = sum(x > 1.5 for x in gated)
        res[name]["cases_on_q_x100"] = len(gated)
        print(json.dumps({"variant": name, "forward": res[name]}),
              flush=True)
    return res


def scaled(smoke, names):
    """Per variant, cap and q factor: each gradient's max abs distance
    from the f32 twin's (autograd of ``gqa_plain``) and from an f64
    answer, and the twin's from it (through ``flash_attention``: the
    variant's forward with lse and its pair)."""
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
                route(name)
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


def run(names, baselines=None, with_scaled=False, draws=1):
    """Build, check and time the variants ``names`` (and each baseline
    NAME -> source text); with ``with_scaled``, each variant's forward
    built with its split too, and the scaled errors.  Returns the
    result and whether every check passed."""
    import torch
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"k4_bwd_variants: unknown {unknown}")
    sources = {n: patched(n) for n in names}
    for name, text in (baselines or {}).items():
        if name in sources:
            raise SystemExit(f"k4_bwd_variants: --baseline {name}: want a "
                             f"new NAME")
        sources[name] = text
    if not torch.cuda.is_available():
        print("k4_bwd_variants: no CUDA device", file=sys.stderr)
        return None, False
    import chip_smoke as smoke
    from repro_torch import set_full_f32
    set_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    forwards = ({n: patched_forward(n) if n in VARIANTS
                 else FWD_SOURCE.read_text() for n in sources}
                if with_scaled else None)
    libs = build(sources, forwards)
    FORWARDS.clear()
    FORWARDS.update({n: libs[f"fwd_{n}"] for n in forwards or {}})
    checks, ok = check(smoke, list(sources))
    res = times(smoke, list(sources))
    sc = ({"forward": scaled_forward(smoke, list(sources), draws),
           "gradients": scaled(smoke, list(sources))}
          if with_scaled else {})
    print(card, flush=True)
    return {"card": card, "checks": checks, "ms_turns": res,
            "scaled": sc}, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=FILE.cu: another source as variant NAME")
    ap.add_argument("--scaled", action="store_true",
                    help="each variant's forward built with its split "
                         "too; the capped forward on q x 1 and x 100 at "
                         "llama's serving layer and the gradients at its "
                         "training layer, with and without the cap, "
                         "against the twin and an f64 answer")
    ap.add_argument("--draws", type=int, default=1,
                    help="--scaled: draws of each small forward case")
    args = ap.parse_args(argv)
    baselines = {}
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        if not name or not path:
            raise SystemExit(f"k4_bwd_variants: --baseline {spec!r}: want "
                             f"a new NAME=FILE.cu")
        baselines[name] = Path(path).read_text()
    out, ok = run([n for n in args.only.split(",") if n], baselines,
                  args.scaled, args.draws)
    if out is None:
        return 1
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
