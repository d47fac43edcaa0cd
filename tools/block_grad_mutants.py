#!/usr/bin/env python3
"""Planted faults in the kernels of K4 (forward and backward) and K5's
backward, read by ``chip_smoke.py``'s checks on one GPU.

    python3 tools/block_grad_mutants.py [--only sound,ssm_da_no_a,...]

Each mutant is a copy of ``src/repro_torch`` and ``chip_smoke.py`` under
``build/block_grad_mutants/NAME/`` with one text patch in a kernel's
source or header (``sound``: none).  The unpatched sources are built once
into ``build/`` and their libraries copied into every copy; each copy
builds its patched source itself, all copies at once.  Each copy then
runs, in its own process:

* ``chip_smoke.lm_block_grads_vs_plain()`` -- one full-width hymba-1.5b
  block (B=1, S=2048) through the kernels against the plain twins --
  with the tolerance lifted, so that it reports each leaf's max abs
  error over the leaf's largest gradient whatever it is;
* ``chip_smoke.kernel_bwd_checks()``, which passes or names its first
  failure;
* ``chip_smoke.check_flash_bwd`` on every case of K4's head dims 128
  and 192 (``WIDE_HEAD_CASES``, ``WIDE_BWD_EDGE_CASES``), each on its
  own, so that the reading names every wide case a fault fails (the
  kernel checks stop at their first, a narrow case);
* ``chip_smoke.check_flash`` (the forward kernels against the plain
  twin) on the same cases and ``FWD_HEAD_EDGE_CASES``, in f32 and bf16,
  each on its own.

A mutant line gives the block's largest reading and its leaf, whether
``chip_smoke.BLOCK_GRAD_RTOL`` catches it, the kernel checks' verdict,
and the wide backward and forward cases that fail.  The last line of standard output is one
JSON object of all mutants.  Needs one CUDA card and nvcc; exits
non-zero otherwise, or when the sound copy fails, fails a wide case or
reads above the tolerance.

Mutants:
  sound                  the committed kernels
  ssm_da_no_a            K5: dA_log without its factor A
  ssm_ddt_no_decay       K5: ddt without its A a_t h_{t-1} term
  ssm_dc_prev_state      K5: dC from h_{t-1} instead of h_t
  ssm_chunk_carry_no_decay
                         K5: a chunk's reverse carry (and dh0) passed
                         without the decay over its first segment
  fa_window_edge         K4: the backward's band one key short at the
                         window's far edge (the forward's lse unchanged)
  fa_no_key_zero         K4: a row that sees no key gives P = 0, not 1/T
                         (no such row in a causal block: the block check
                         cannot see it, the kernel checks can)
  fa_tf32_single         K4: every split product of the f32 forward and
                         both backward kernels one TF32 product (hi . hi)
                         without its two correction terms (their shared
                         csrc/tf32_mma.cuh)
  fa_fwd_band_short      K4's f32 forward: every row's band one key
                         short at the window's far edge
  fa_tc_window_edge      K4's bf16 forward: the window's far edge one key
                         short on the tiles that take the masks
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "block_grad_mutants"
SOURCES = ("flash_attention", "flash_attention_bwd", "ssm_scan",
           "ssm_scan_bwd")

# name -> (source, anchor, replacement): a source is csrc/<source>.cu or,
# named with its suffix, a header there; the anchor occurs once
MUTANTS = {
    "sound": None,
    "ssm_da_no_a": ("ssm_scan_bwd",
                    "drow[n] = A[n] * sum;",
                    "drow[n] = sum;"),
    "ssm_ddt_no_decay": ("ssm_scan_bwd",
                         "sdt = fmaf(gr[n], fmaf(xv, bn, ha), sdt);",
                         "sdt = fmaf(gr[n], xv * bn + 0.0f * ha, sdt);"),
    "ssm_dc_prev_state": ("ssm_scan_bwd",
                          "vals[N + n] = hc * dyv;",
                          "vals[N + n] = hp * dyv;"),
    "ssm_chunk_carry_no_decay": ("ssm_scan_bwd",
                                 "fmaf(sb_ex2(a2[n] * s0), gr[n],",
                                 "fmaf(1.0f, gr[n],"),
    "fa_window_edge": ("flash_attention_bwd",
                       "lo = window > 0 ? max(0, p - window + 1) : 0;",
                       "lo = window > 0 ? max(0, p - window + 2) : 0;"),
    "fa_no_key_zero": ("flash_attention_bwd",
                       "p = inv_t;",
                       "p = 0.0f * inv_t;"),
    "fa_tf32_single": ("tf32_mma.cuh",
                       "    mma_tf32(d, al, bh0, bh1);\n"
                       "    mma_tf32(d, ah, bl0, bl1);\n"
                       "    mma_tf32(d, ah, bh0, bh1);\n",
                       "    mma_tf32(d, ah, bh0, bh1);\n"),
    "fa_fwd_band_short": ("flash_attention",
                          "lo = window > 0 ? max(0, p - window + 1) : 0;",
                          "lo = window > 0 ? max(0, p - window + 2) : 0;"),
    "fa_tc_window_edge": ("flash_attention",
                          "&& (window <= 0 || key > p - window);",
                          "&& (window <= 0 || key > p - window + 1);"),
}

# run in each copy: the copy's chip_smoke and repro_torch, its tolerance
# lifted for the block reading
CHILD = r"""
import json, math, sys
import chip_smoke as c
from repro_torch import set_full_f32
set_full_f32()
rtol = c.BLOCK_GRAD_RTOL
c.BLOCK_GRAD_RTOL = math.inf
block = c.lm_block_grads_vs_plain()
worst = max(block["rel_err_by_leaf"], key=block["rel_err_by_leaf"].get)
try:
    c.kernel_bwd_checks()
    checks = "passed"
except SystemExit as e:
    checks = str(e)
import torch
gen = torch.Generator(device="cuda").manual_seed(30)
wide_failed = []
for name, (b, s, t, h, hkv, d), kw in c.WIDE_HEAD_CASES + \
        c.WIDE_BWD_EDGE_CASES:
    ins = [torch.randn(*shape, generator=gen, device="cuda") for shape in
           ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d))]
    try:
        c.check_flash_bwd(name, *ins, **kw)
    except SystemExit:
        wide_failed.append(name)
fwd = torch.Generator(device="cuda").manual_seed(31)
fwd_failed = []
for name, (b, s, t, h, hkv, d), kw in c.WIDE_HEAD_CASES + \
        c.WIDE_BWD_EDGE_CASES + c.FWD_HEAD_EDGE_CASES:
    for dtype in (torch.float32, torch.bfloat16):
        ins = [torch.randn(*shape, generator=fwd, device="cuda").to(dtype)
               for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))]
        try:
            c.check_flash(name, *ins, **kw)
        except SystemExit:
            fwd_failed.append(f"{name}-{str(dtype).removeprefix('torch.')}")
print(json.dumps({"max_rel_err": block["max_rel_err"], "worst_leaf": worst,
                  "rtol": rtol, "caught": block["max_rel_err"] > rtol,
                  "kernel_bwd_checks": checks,
                  "wide_cases_failed": wide_failed,
                  "wide_fwd_cases_failed": fwd_failed}))
"""


def source_file(source):
    """A mutant's source's file name in csrc/."""
    return source if "." in source else f"{source}.cu"


def patched_source(name):
    """(source, the text of the mutant's patched source); None for
    ``sound``."""
    spec = MUTANTS[name]
    if spec is None:
        return None
    source, old, new = spec
    path = ROOT / "src/repro_torch/kernels/csrc" / source_file(source)
    src = path.read_text()
    if src.count(old) != 1:
        raise SystemExit(f"block_grad_mutants: {name}: anchor not found "
                         f"once in {path.name}: {old!r}")
    return source, src.replace(old, new)


def make_copy(name, libs):
    """``build/block_grad_mutants/NAME/`` with the package, the script,
    the mutant's source and the unpatched sources' libraries."""
    dest = OUT / name
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "src/repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dest / "chip_smoke.py")
    (dest / "build").mkdir()
    patch = patched_source(name)
    if patch is not None:
        source, text = patch
        (dest / "src/repro_torch/kernels/csrc" /
         source_file(source)).write_text(text)
    for source, lib in libs.items():
        if patch is None or source != patch[0]:
            shutil.copy2(lib, dest / "build" / lib.name)
    return dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated mutants (default: all)")
    args = ap.parse_args(argv)
    names = [n for n in args.only.split(",") if n] or list(MUTANTS)
    unknown = set(names) - set(MUTANTS)
    if unknown:
        raise SystemExit(f"block_grad_mutants: unknown {sorted(unknown)}")
    for name in names:
        patched_source(name)           # every anchor, before any build
    import torch
    if not torch.cuda.is_available():
        print("block_grad_mutants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    libs = _build.build(SOURCES)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = {}
    for name in names:
        dest = make_copy(name, libs)
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", CHILD], cwd=dest, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    results, ok = {}, True
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            results[name] = {"error": err.strip().splitlines()[-20:]}
            ok = False
        else:
            results[name] = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"mutant": name, "patch": MUTANTS[name] and
                          list(MUTANTS[name]), **results[name]}),
              flush=True)
    sound = results.get("sound")
    if sound is not None and ("error" in sound or sound["caught"]
                              or sound["kernel_bwd_checks"] != "passed"
                              or sound["wide_cases_failed"]
                              or sound["wide_fwd_cases_failed"]):
        ok = False
    print(json.dumps({"mutants": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
