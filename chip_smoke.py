#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's
paths through those kernels — the sync path
(``repro_torch.launch.fl_train``: FedDCT on full-width ``cnn-mnist``, 50
clients, 5 rounds; kernel ``fedagg``), the async path (semi-async
FedDCT and FedBuff over the client-state store; kernel
``fedagg_fold``), the client-mesh path (``--mesh-clients 4`` over
four virtual shards of the card; kernel ``fedagg_partial`` once per
shard) and LM serving (``launch/steps.py``: prefill of full-width
``hymba-1.5b`` and ``llama3.2-1b``, decode of ``hymba-1.5b``; kernels
``flash_attention`` and ``ssm_scan``; ``flash_attention`` is the
``wgmma`` kernel on these bf16 paths and the split-TF32 one in the f32
consistency run) — then traces the sync and async paths through
``fl_train --trace`` (JSONL and Chrome; the port's ``repro_torch.obs``:
traced == untraced bit for bit, the split of a warm round by span on
the host and the card, the tracing overhead) and runs the async path
with int8 client rows (``--quant-bits 8``, with and without error
feedback; every quantized row held to the numpy oracle exactly) and
over tiered client-state residency (``--hot-rows``, ``--cold-dir``:
hot rows on the card, cold rows in pinned host memory or npz chunks;
every history, final model and stored row equal to the dense store's,
randomized store interleavings on the card, and 2,000 full-width
clients against a dense store's peak memory) — holds the f32 backward
kernels of ``flash_attention`` and ``ssm_scan`` against autograd of
their plain twins, trains full-width ``hymba-1.5b`` and ``llama3.2-1b``
in f32 through ``repro_torch.launch.train --full`` (every attention and
SSM layer's forward and backward through the kernels; two seeded runs
bit for bit) and runs ``fl_train`` over reduced LM clients; serves and
trains the MoE and xLSTM families and the wide heads (mixtral, arctic,
phi4-mini, nemotron, chameleon), encodes and trains the audio family's
``hubert-xlarge`` at full width and depth (K4 at head dim 80), and runs
the LM mesh (context-parallel attention, K4 once a model shard, in the
bf16 prefills of phi4-mini and hymba and an f32 llama step under meshes
of virtual shards of the card; ``LMTrainer`` on a client mesh;
``launch.train --mesh``), runs secure aggregation on the main path's
widest round (pairwise-masked uploads, the server's sum through
``fedagg_partial``) and puts each timed train step beside its
compiler-free cost (``repro_torch.roofline.cost``: the bound, ``mfu``)
— and prints
one JSON object per phase.  Each path runs with
every launch count set to 0 just before it and read just after.  Any
failure exits non-zero; there is no CPU path.  The last line of
standard output is ``{"ok": true, "device": {"platform": "gpu", "kind":
..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (the yardsticks of ``bound_ms``) and the
# kernels' bounds: the port's work model, ``repro_torch.roofline.cost``
# (``HBM_BYTES_PER_S`` and ``visible_pairs`` are read from this module by
# the tests that check the bounds it prints)
from repro_torch.roofline.cost import (  # noqa: E402,F401
    BF16_TENSOR_FLOPS_PER_S, FA_BWD_BF16_WORK, FA_BWD_WORK, FA_FWD_BF16_WORK,
    FA_FWD_WORK, HBM_BYTES_PER_S, SFU_EXP_PER_S, SOFTCAP_SFU_PER_PAIR,
    SOFTCAP_TC_SFU_PER_PAIR, fedagg_bound_ms, sfu_floor_ms,
    flash_bound_ms, flash_bwd_bf16_bound_ms, flash_bwd_bound_ms,
    flash_softcap_bound_ms, fold_bound_ms, partial_bound_ms, ssm_bound_ms,
    ssm_bwd_bound_ms, visible_pairs)

# sequential f32 row sum in the kernel vs torch's reduction order
RTOL, ATOL = 1e-5, 1e-6
# full-width cnn-mnist: conv 32/64, FC 512 -> 10
MAIN_P = 1_630_090
MAIN_N = 32
MAIN_ARGV = ["--arch", "cnn-mnist", "--method", "feddct", "--clients", "50",
             "--tiers", "5", "--tau", "5", "--rounds", "5", "--seed", "0"]
# The async path at the same width.  Round 1's window merges 1
# completion and carries 4; round 2's selection moves the tier pointer
# up whatever the accuracy (it starts from 0), and its window merges
# the 4 carried completions with 2 new ones: 2 rounds are the fewest
# that reach the kernel (a window of 6 rows, padded to 8).
ASYNC_ROUNDS = 2
ASYNC_ARGV = ["--arch", "cnn-mnist", "--method", "feddct_async",
              "--clients", "50", "--tiers", "5", "--tau", "5",
              "--rounds", str(ASYNC_ROUNDS), "--seed", "0"]
FOLD_K = 32
# The client-mesh path: the same runs over four virtual shards of the
# card (the port's counterpart of the JAX package's forced host devices)
MESH_SHARDS = 4
PARTIAL_R = 8
# first round's sharded model against the plain engine's on the same
# cohort: the shards train their rows in smaller batched products, and
# Adam's normalized step turns their summation-order noise in tiny
# gradients into a fraction of one lr=1e-3 step (as in cpu_agreement)
MESH_ROUND_ATOL = 2e-4
# the async mesh path's store merge (fedagg_fold, coefficients
# normalised in f32 on the card) against its dict merge (fedagg_partial
# per shard, coefficients normalised in f64 on the host): reassociated
# f32 sums of parameters of magnitude < 1
MESH_MERGE_ATOL = 1e-5
MESH_ACC_ATOL = 5e-3
# meta keys that name the snapshot path, and so differ store vs dict
STORE_KEYS = {"store", "store_path", "store_reason", "residency",
              "hot_rows", "store_bytes_hot", "store_bytes_cold",
              "store_bytes_ef"}


# host clock when the script was loaded (before torch is imported) and
# at the last phase line
_CLOCK = {"start": time.perf_counter()}
_CLOCK["last"] = _CLOCK["start"]


def emit(obj) -> None:
    """One JSON line; a phase line also carries its seconds since the
    previous phase line (``phase_s``) and since the script was loaded
    (``elapsed_s``)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "phase_s": now - _CLOCK["last"],
               "elapsed_s": now - _CLOCK["start"]}
        _CLOCK["last"] = now
    print(json.dumps(obj), flush=True)


def zero_counts() -> None:
    from repro_torch.kernels import fedagg as fedagg_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssm_scan as ss_mod
    fedagg_mod.launches = 0
    fedagg_mod.fold_launches = 0
    fedagg_mod.partial_launches = 0
    fedagg_mod.tiled_launches = 0
    fa_mod.launches = 0
    fa_mod.tc_launches = 0
    fa_mod.softcap_launches = 0
    fa_mod.softcap_bwd_launches = 0
    fa_mod.bwd_dq_launches = 0
    fa_mod.bwd_dkdv_launches = 0
    fa_mod.bwd_dq_bf16_launches = 0
    fa_mod.bwd_dkdv_bf16_launches = 0
    ss_mod.launches = 0
    ss_mod.bwd_launches = 0
    ss_mod.bwd_bf16_launches = 0


def counts() -> dict:
    from repro_torch.kernels import fedagg as fedagg_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssm_scan as ss_mod
    return {"fedagg": fedagg_mod.launches,
            "fedagg_fold": fedagg_mod.fold_launches,
            "fedagg_partial": fedagg_mod.partial_launches,
            "fedagg_tiled": fedagg_mod.tiled_launches,
            "flash_attention": fa_mod.launches,
            "flash_attention_tc": fa_mod.tc_launches,
            "flash_attention_softcap": fa_mod.softcap_launches,
            "flash_attention_softcap_bwd": fa_mod.softcap_bwd_launches,
            "flash_attention_bwd_dq": fa_mod.bwd_dq_launches,
            "flash_attention_bwd_dkdv": fa_mod.bwd_dkdv_launches,
            "flash_attention_bwd_dq_bf16": fa_mod.bwd_dq_bf16_launches,
            "flash_attention_bwd_dkdv_bf16": fa_mod.bwd_dkdv_bf16_launches,
            "ssm_scan": ss_mod.launches,
            "ssm_scan_bwd": ss_mod.bwd_launches,
            "ssm_scan_bwd_bf16": ss_mod.bwd_bf16_launches}


def only(**launched) -> dict:
    """The launch counts of a run that launched ``launched`` and no
    other kernel."""
    return {**dict.fromkeys(counts(), 0), **launched}


@contextlib.contextmanager
def patched(obj, name, fn):
    """``obj.name = fn`` for the duration of the block."""
    real = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield real
    finally:
        setattr(obj, name, real)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


_BUSY = []
MAX_BUSY_PRODUCTS = 64


def _keep_card_busy(products: int):
    """Device work in front of a timed run (``products`` 4096^2 f32
    products, about 2.5 ms each), so that the host can enqueue the
    whole run before the card reaches it.  Returns an event recorded
    behind that work."""
    import torch
    if not _BUSY:
        _BUSY.append(torch.ones(4096, 4096, device="cuda"))
    for _ in range(products):
        torch.mm(_BUSY[0], _BUSY[0])
    ahead = torch.cuda.Event()
    ahead.record()
    return ahead


def median_ms(fn, *, hide_host: bool = True, warmup: int = 5, runs: int = 7,
              per_run: int = 20) -> float:
    """Time of one ``fn()``: CUDA events around a run of ``per_run``
    back-to-back calls, over the count; the median of ``runs`` such
    runs, warmed and synchronized.  With ``hide_host`` the run is
    enqueued behind other device work, so the reading is device time
    alone: a run whose host enqueue outlasted that work (the card sat
    waiting for the host inside the timed window) is thrown away and
    made again behind twice as much, up to ``MAX_BUSY_PRODUCTS``; only
    a call that is host-bound by far (the plain versions' Python loops)
    gets there, and its reading then includes host time.  Without
    ``hide_host`` the reading includes whatever the host adds between
    launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, products = [], 2
    while len(times) < runs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ahead = _keep_card_busy(products) if hide_host else None
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        starved = ahead is not None and ahead.query()
        end.synchronize()
        if starved and products < MAX_BUSY_PRODUCTS:
            products *= 2
            continue
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def check_fedagg(name, u, w, a=None, *, exact_zero=False):
    """Kernel vs plain version on the same card tensors."""
    import torch
    from repro_torch.kernels.fedagg import fedagg, fedagg_plain
    got = fedagg(u, w, alphas=a)
    torch.cuda.synchronize()
    want = fedagg_plain(u, w, a)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"fedagg[{name}]: shape/dtype {got.shape} {got.dtype}")
    if not bool(torch.isfinite(got).all()):
        fail(f"fedagg[{name}]: non-finite output")
    if exact_zero and bool((got != 0).any()):
        fail(f"fedagg[{name}]: expected exact zeros")
    abs_err = float((got - want).abs().max())
    rel_err = float(((got - want).abs()
                     / want.abs().clamp(min=1e-12)).max())
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"fedagg[{name}]: disagrees with fedagg_plain, "
             f"max abs err {abs_err}")
    return {"case": name, "n": int(u.shape[0]), "p": int(u.shape[1]),
            "max_abs_err": abs_err, "max_rel_err": rel_err}


def fedagg_cases():
    import torch
    from repro_torch.kernels.fedagg import fedagg
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def sizes(n):
        return 40.0 + 40.0 * torch.rand(n, generator=gen, device="cuda")

    cases = []
    u, w = randn(MAIN_N, MAIN_P), sizes(MAIN_N)
    cases.append(check_fedagg("main", u, w))
    cases.append(check_fedagg("alphas", u, w,
                              torch.rand(MAIN_N, generator=gen,
                                         device="cuda")))
    cases.append(check_fedagg("n=1", randn(1, MAIN_P), sizes(1)))
    cases.append(check_fedagg("odd-p-under-a-block", randn(7, 331),
                              sizes(7)))
    cases.append(check_fedagg("p-multiple-of-4", randn(5, 4096), sizes(5)))
    # zero-weight rows holding inf/nan contribute nothing
    ub, wb = randn(8, 10_001), sizes(8)
    ub[2] = float("inf")
    ub[5] = float("nan")
    wb[2] = 0.0
    wb[5] = 0.0
    cases.append(check_fedagg("masked-inf-nan", ub, wb))
    cases.append(check_fedagg("all-zero-weights", ub, torch.zeros_like(wb),
                              exact_zero=True))
    # padded duplicate rows of weight 0: bitwise no-op
    base = fedagg(u[:20], w[:20])
    padded = fedagg(u, torch.cat([w[:20], torch.zeros(MAIN_N - 20,
                                                      device="cuda")]))
    torch.cuda.synchronize()
    if not torch.equal(base, padded):
        fail("fedagg: zero-weight padding rows changed the result's bits")
    cases.append({"case": "zero-weight-padding-bitwise", "n": MAIN_N,
                  "p": MAIN_P, "max_abs_err": 0.0, "max_rel_err": 0.0})
    return cases


L2_BYTES = 50e6


def fedagg_times(n: int, p: int):
    """Kernel, plain version and the one-call library yardstick at one
    shape, in turns on the same inputs.  Calls rotate over enough
    copies of the buffer (three L2 capacities' worth) that each finds
    its rows in device memory, not in the cache."""
    import itertools

    import torch
    from repro_torch.kernels.fedagg import fedagg, fedagg_plain
    gen = torch.Generator(device="cuda").manual_seed(1)
    u = torch.randn(n, p, generator=gen, device="cuda")
    w = 40.0 + 40.0 * torch.rand(n, generator=gen, device="cuda")
    eff = w / w.sum()
    err = check_fedagg(f"timed-{n}x{p}", u, w)
    copies = max(1, -(-int(3 * L2_BYTES) // (4 * n * p)))
    ring = itertools.cycle([u] + [u.clone() for _ in range(copies - 1)])
    plain_a = median_ms(lambda: fedagg_plain(next(ring), w))
    kernel_a = median_ms(lambda: fedagg(next(ring), w))
    # yardstick only: the port never computes the row sum this way
    library = median_ms(lambda: torch.matmul(eff, next(ring)))
    kernel_b = median_ms(lambda: fedagg(next(ring), w))
    plain_b = median_ms(lambda: fedagg_plain(next(ring), w))
    # the same call as the host makes it, with an idle card in front
    call = median_ms(lambda: fedagg(next(ring), w), hide_host=False)
    # what a plain read of the buffer reaches on this card
    read = median_ms(lambda: next(ring).sum())
    bound, bound_by = fedagg_bound_ms(w, p)
    return {"n": n, "p": p, "buffers": copies,
            "ms": min(kernel_a, kernel_b), "call_ms_with_host": call,
            "plain_ms": min(plain_a, plain_b), "library_ms": library,
            "read_only_ms": read, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err["max_abs_err"]}


def k1_against_library(first, runs: int = 3):
    """K1 and its one-call yardstick ``eff @ updates`` at the full
    cohort, ``runs`` times (``first`` is one): whether K1 reads slower
    than the library call by more than K1's own spread between runs."""
    rs = [first] + [fedagg_times(MAIN_N, MAIN_P) for _ in range(runs - 1)]
    k1 = [r["ms"] for r in rs]
    lib = [r["library_ms"] for r in rs]
    gap = statistics.median(k1) - statistics.median(lib)
    spread = max(k1) - min(k1)
    return {"k1_ms": k1, "library_ms": lib, "median_gap_ms": gap,
            "k1_spread_ms": spread, "k1_slower_beyond_spread": gap > spread}


def torch_f32(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu()
    return torch.as_tensor(x, dtype=torch.float32)


def check_fold(name, u, g, coef, *, exact_zero=False):
    """Folded-merge kernel vs its plain version on the same card
    tensors."""
    import torch
    from repro_torch.kernels import fedagg as fedagg_mod
    got = fedagg_mod.fedagg_fold(u, g, coef)
    torch.cuda.synchronize()
    want = fedagg_mod.fedagg_fold_plain(u, g, coef)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"fedagg_fold[{name}]: shape/dtype {got.shape} {got.dtype}")
    if not bool(torch.isfinite(got).all()):
        fail(f"fedagg_fold[{name}]: non-finite output")
    if exact_zero and bool((got != 0).any()):
        fail(f"fedagg_fold[{name}]: expected exact zeros")
    abs_err = float((got - want).abs().max())
    rel_err = float(((got - want).abs()
                     / want.abs().clamp(min=1e-12)).max())
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"fedagg_fold[{name}]: disagrees with fedagg_fold_plain, "
             f"max abs err {abs_err}")
    k, p = u.shape
    return {"case": name, "k": int(k), "p": int(p),
            "vec": fedagg_mod._vector_width(p, u, g, got),
            "max_abs_err": abs_err, "max_rel_err": rel_err}


def fold_cases():
    import numpy as np
    import torch
    from repro_torch.core.aggregation import staleness_merge_coefficients
    from repro_torch.kernels.fedagg import fedagg_fold
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def coefs(k):
        return staleness_merge_coefficients(rng.uniform(0.1, 0.9, k))

    cases = []
    for k in (8, FOLD_K):
        cases.append(check_fold(f"k={k}", randn(k, MAIN_P), randn(MAIN_P),
                                coefs(k)))
    cases.append(check_fold("k=1", randn(1, MAIN_P), randn(MAIN_P),
                            coefs(1)))
    cases.append(check_fold("odd-p-under-a-block", randn(7, 331),
                            randn(331), coefs(7)))
    cases.append(check_fold("p-multiple-of-4", randn(5, 4096), randn(4096),
                            coefs(5)))
    # zero-coefficient rows holding inf/nan contribute nothing
    ub, gb, cb = randn(8, 10_001), randn(10_001), coefs(8)
    ub[2] = float("inf")
    ub[5] = float("nan")
    cb[3] = 0.0
    cb[6] = 0.0
    cases.append(check_fold("masked-inf-nan", ub, gb, cb))
    # c0 = 0: the global row, inf here, is never read
    g_inf = gb.clone()
    g_inf[::7] = float("inf")
    c0 = coefs(8)
    c0[0] = 0.0
    cases.append(check_fold("c0=0-inf-global", randn(8, 10_001), g_inf, c0))
    c_nan = coefs(8)
    c_nan[4] = float("nan")
    cases.append(check_fold("nan-coefficient", randn(8, 10_001), gb,
                            c_nan))
    cases.append(check_fold("all-zero-coefficients", ub, g_inf,
                            np.zeros(9, np.float32), exact_zero=True))
    # a window of 5 rows padded to 8 with zero coefficients (the
    # engine's pow2 cohort) is bitwise the unpadded window
    u8, g8, c5 = randn(8, MAIN_P), randn(MAIN_P), coefs(5)
    u8[5:] = u8[4]                          # pad rows repeat the last
    base = fedagg_fold(u8[:5].contiguous(), g8, c5)
    padded = fedagg_fold(u8, g8, np.concatenate(
        [c5, np.zeros(3, np.float32)]))
    torch.cuda.synchronize()
    if not torch.equal(base, padded):
        fail("fedagg_fold: zero-coefficient padding rows changed the "
             "result's bits")
    cases.append({"case": "window-5-padded-to-8-bitwise", "k": 8,
                  "p": MAIN_P, "max_abs_err": 0.0, "max_rel_err": 0.0})
    return cases


def fedagg_fold_times(k: int, p: int, coef):
    """Folded-merge kernel, its plain version and the one-call library
    yardstick ``addmv`` (the same function without the masking) at one
    shape, in turns on the same inputs rotated past the L2."""
    import itertools

    import torch
    from repro_torch.kernels.fedagg import (fedagg_fold, fedagg_fold_plain,
                                            fold_coefficients)
    gen = torch.Generator(device="cuda").manual_seed(3)
    u = torch.randn(k, p, generator=gen, device="cuda")
    g = torch.randn(p, generator=gen, device="cuda")
    err = check_fold(f"timed-{k}x{p}", u, g, coef)
    copies = max(1, -(-int(3 * L2_BYTES) // (4 * (k + 1) * p)))
    ring = itertools.cycle([(u, g)] + [(u.clone(), g.clone())
                                       for _ in range(copies - 1)])
    c = fold_coefficients(coef, "cuda")
    c0, c_rows = float(c[0]), c[1:].contiguous()
    # the kernel alone reads its coefficients from the card; the path's
    # call (``call_ms_with_host``) uploads them from the host each time
    c_dev = torch.as_tensor(coef, dtype=torch.float32, device="cuda")

    def kernel():
        return fedagg_fold(*next(ring), c_dev)

    def as_called():
        return fedagg_fold(*next(ring), coef)

    def plain():
        return fedagg_fold_plain(*next(ring), c_dev)

    def library():
        # yardstick only: the port never computes the merge this way
        uu, gg = next(ring)
        return torch.addmv(gg, uu.t(), c_rows, beta=c0)

    plain_a = median_ms(plain)
    kernel_a = median_ms(kernel)
    lib = median_ms(library)
    kernel_b = median_ms(kernel)
    plain_b = median_ms(plain)
    call = median_ms(as_called, hide_host=False)
    bound, bound_by = fold_bound_ms(coef, p)
    return {"k": k, "p": p, "k_live": int((torch_f32(coef)[1:] > 0).sum()),
            "buffers": copies, "ms": min(kernel_a, kernel_b),
            "call_ms_with_host": call, "plain_ms": min(plain_a, plain_b),
            "library_ms": lib, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err["max_abs_err"]}


def main_path():
    """The port's CLI twice with one seed, then one timed run."""
    import torch
    from repro_torch.config.base import FLConfig
    from repro_torch.core import run_method
    from repro_torch.fl.client import build_fl_clients
    from repro_torch.fl.network import WirelessNetwork
    from repro_torch.kernels import fedagg as fedagg_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import fl_train
    from repro_torch.tree import tree_leaves

    # shapes the main path hands the kernel (a recording pass-through)
    shapes = []
    real = ops.fedagg

    def recording(updates, weights, *, alphas=None):
        shapes.append((int(updates.shape[0]), int(updates.shape[1]),
                       updates.device.type))
        return real(updates, weights, alphas=alphas)

    ops.fedagg = recording
    try:
        zero_counts()
        t0 = time.perf_counter()
        hist = fl_train.main(MAIN_ARGV)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = fedagg_mod.launches
        path_counts = counts()
    finally:
        ops.fedagg = real

    live_rounds = sum(1 for s, g in zip(hist.n_selected, hist.n_stragglers)
                      if s - g > 0)
    if len(hist.rounds) != 5:
        fail(f"main path recorded {len(hist.rounds)} rounds, not 5")
    if launches != live_rounds or launches < 1:
        fail(f"fedagg launched {launches} times on the main path, "
             f"{live_rounds} rounds had survivors")
    if path_counts["fedagg_fold"] or path_counts["fedagg_partial"]:
        fail(f"the sync path launched other kernels: {path_counts}")
    if any(dev != "cuda" or p != MAIN_P for _, p, dev in shapes):
        fail(f"main path gave fedagg unexpected buffers: {shapes}")
    if hist.meta.get("kernel_agg") is not True:
        fail(f"meta['kernel_agg'] is {hist.meta.get('kernel_agg')!r}")
    if not all(0.0 <= a <= 1.0 for a in hist.accuracy):
        fail(f"accuracies not finite in [0,1]: {hist.accuracy}")

    # the second run also hands secure_agg_path each round's survivors:
    # ids, round seed, trained models, sample counts
    from repro_torch.core.engine import BatchedClientEngine

    def recording_round(engine, params, client_ids, rnd_seed):
        stacked, sizes = real_train(engine, params, client_ids, rnd_seed)
        if stacked is not None:
            PATH_ROUNDS.append({"ids": [int(c) for c in client_ids],
                                "rnd": int(rnd_seed), "stacked": stacked,
                                "sizes": [float(x) for x in sizes]})
        return stacked, sizes

    with patched(BatchedClientEngine, "train_clients",
                 recording_round) as real_train:
        again = fl_train.main(MAIN_ARGV)
    if again.to_json() != hist.to_json():
        fail("two runs with one seed gave different histories")

    # timed run on the warmed process, through the same entry points
    fl = FLConfig(n_clients=50, n_tiers=5, tau=5, rounds=5, seed=0, lr=1e-3)
    net = WirelessNetwork(fl.n_clients, fl.tier_delay_means, fl.delay_std,
                          fl.mu, fl.failure_delay, fl.seed)
    trainer = build_fl_clients("cnn-mnist", fl)
    devices = set()
    evaluate = trainer.evaluate

    def watching(params):
        devices.update(l.device.type for l in tree_leaves(params))
        return evaluate(params)

    trainer.evaluate = watching
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = run_method("feddct", trainer, net, fl)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if devices != {"cuda"}:
        fail(f"parameters live on {devices}, not on the card")
    if timed.to_json() != hist.to_json():
        fail("the timed run's history differs from the CLI run's")
    n_params = sum(l.numel() for l in tree_leaves(trainer.init_params(0)))
    if n_params != MAIN_P:
        fail(f"cnn-mnist has {n_params} parameters, expected {MAIN_P}")
    return {"argv": MAIN_ARGV, "rounds": hist.rounds,
            "accuracy": hist.accuracy, "n_selected": hist.n_selected,
            "n_stragglers": hist.n_stragglers, "times": hist.times,
            "fedagg_launches": launches, "launches": path_counts,
            "fedagg_shapes": [[n, p] for n, p, _ in shapes],
            "first_run_s": first_s, "warm_run_s": run_s,
            "warm_s_per_round": run_s / fl.rounds,
            "two_runs_identical": True}, launches, shapes, hist


# The main path's rounds with survivors, recorded in its second run
PATH_ROUNDS = []
# the mask scales of secure_agg_path: tests/test_secure_agg.py's 1 and 50
SECURE_SCALES = (1.0, 50.0)
SECURE_TOL = 1e-4


def secure_agg_path():
    """Secure aggregation (``core/secure_agg.py``) on the survivors of the
    main path's widest round (full-width cnn-mnist, P = 1,630,090, at
    most 5 survivors, their sample counts as weights; the first of the
    widest), at mask scales 1 and 50: every client's
    pairwise-masked upload, the server's sum through K3
    (``fedagg_partial`` with unit coefficients) counted, then gated: (a)
    K3's sum of the uploads equals ``fedagg_partial_plain``'s bit for bit
    on the same card tensors; (b) the secure average within rtol = atol
    = 1e-4 of K1's (``fedagg_pytree``) weighted average of the unmasked
    models; (c) at scale 50 an upload differs from its raw update by
    more than 10; (d) a second seeded masking gives the same uploads bit
    for bit.  Prints the masking ms, K3's ms and its bound."""
    import itertools

    import torch
    from repro_torch.core import secure_agg as sa
    from repro_torch.kernels import fedagg as fedagg_mod
    from repro_torch.kernels.ops import fedagg_pytree, flatten_params_row
    from repro_torch.tree import tree_leaves, tree_map
    if not PATH_ROUNDS:
        fail("secure_agg_path: the main path recorded no round")
    widest = max(PATH_ROUNDS, key=lambda r: len(r["ids"]))
    ids, rnd = widest["ids"], widest["rnd"]
    stacked, sizes = widest["stacked"], widest["sizes"]
    PATH_ROUNDS.clear()
    models = [tree_map(lambda l, i=i: l[i], stacked)
              for i in range(len(ids))]
    if not 2 <= len(ids) <= 5 or sum(
            l[0].numel() for l in tree_leaves(stacked)) != MAIN_P:
        fail(f"secure_agg_path: survivors {ids} of {MAIN_P} parameters?")
    dev = tree_leaves(stacked)[0].device
    plain_avg = fedagg_pytree(stacked, torch.tensor(sizes, dtype=torch.float32,
                                                    device=dev))

    def uploads(scale):
        return [sa.mask_update(m, c, ids, rnd, weight=w, scale=scale)
                for m, c, w in zip(models, ids, sizes)]

    out = {"survivors": ids, "round_seed": rnd, "sizes": sizes,
           "p": MAIN_P, "tol": SECURE_TOL, "scales": {}}
    zero_counts()
    ups = {}
    for scale in SECURE_SCALES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ups[scale] = uploads(scale)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        agg = sa.secure_aggregate(ups[scale], sizes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        err = max(float((a - b).abs().max()) for a, b in
                  zip(tree_leaves(agg), tree_leaves(plain_avg)))
        ok = all(bool(((a - b).abs() <= SECURE_TOL
                       + SECURE_TOL * b.abs()).all())
                 for a, b in zip(tree_leaves(agg), tree_leaves(plain_avg)))
        if not ok:
            fail(f"secure_agg_path (b): scale {scale}: the secure average "
                 f"is {err} from K1's weighted average")
        out["scales"][str(scale)] = {"masking_ms": (t1 - t0) * 1e3,
                                     "aggregate_ms": (t2 - t1) * 1e3,
                                     "max_abs_err_vs_k1": err}
    launched = counts()
    if launched != only(fedagg_partial=len(SECURE_SCALES)):
        fail(f"secure_agg_path: launches {launched}, expected one K3 "
             "launch a secure aggregate")
    # (a) K3's sum of the uploads against its plain twin, bit for bit
    rows = torch.stack([flatten_params_row(u) for u in ups[50.0]])
    ones = torch.ones(len(ids), dtype=torch.float32, device=dev)
    k3 = fedagg_mod.fedagg_partial(rows, ones)
    if not torch.equal(k3, fedagg_mod.fedagg_partial_plain(rows, ones)):
        fail("secure_agg_path (a): K3's sum differs from its plain twin")
    # (c) an upload at scale 50 is masked
    raw = [l.float() * sizes[0] for l in tree_leaves(models[0])]
    masked_by = max(float((u - r).abs().max())
                    for u, r in zip(tree_leaves(ups[50.0][0]), raw))
    if masked_by <= 10.0:
        fail(f"secure_agg_path (c): an upload is {masked_by} from its raw "
             "update")
    # (d) seeded masks repeat
    if not all(torch.equal(a, b) for u, v in zip(ups[50.0], uploads(50.0))
               for a, b in zip(tree_leaves(u), tree_leaves(v))):
        fail("secure_agg_path (d): two seeded maskings differ")
    # K3 timed on copies of the rows rotated past the L2 (a cold read)
    ring = itertools.cycle([rows] + [rows.clone() for _ in range(
        max(1, -(-int(3 * L2_BYTES) // (4 * rows.numel()))) - 1)])
    k3_ms = median_ms(lambda: fedagg_mod.fedagg_partial(next(ring), ones),
                      warmup=2, runs=5, per_run=10)
    # yardstick only: the same unit sum as one library call
    library_ms = median_ms(lambda: torch.mv(next(ring).t(), ones),
                           warmup=2, runs=5, per_run=10)
    plain_ms = median_ms(
        lambda: fedagg_mod.fedagg_partial_plain(next(ring), ones),
        warmup=2, runs=5, per_run=10)
    bound, bound_by = partial_bound_ms(ones, MAIN_P)
    out.update({"k3_launches": launched["fedagg_partial"],
                "k3_equals_plain_bit_for_bit": True,
                "upload_masked_by": masked_by, "uploads_repeat": True,
                "k3_ms": k3_ms, "k3_plain_ms": plain_ms,
                "k3_library_ms": library_ms, "k3_library": "torch.mv",
                "k3_bound_ms": bound, "k3_bound_by": bound_by,
                "k3_rows": list(rows.shape)})
    return out


def cpu_agreement():
    """One round of full-width cnn-mnist from the same parameters: the
    card's batched round through the kernel against the port's own
    looped per-leaf round on the CPU.  Tolerance 2e-4 absolute: Adam's
    normalized step turns conv/GEMM summation-order noise in tiny
    gradients into a fraction of one lr=1e-3 step."""
    import torch
    from repro_torch.config import get_arch
    from repro_torch.config.base import FLConfig
    from repro_torch.core.engine import make_engine
    from repro_torch.fl.client import CNNTrainer
    from repro_torch.tree import tree_leaves
    fl = FLConfig(n_clients=4, n_tiers=2, tau=2, rounds=1, seed=3, lr=1e-3)
    cfg = get_arch("cnn-mnist")
    on_card = CNNTrainer(cfg, fl, "mnist", scale=0.005, device="cuda")
    on_cpu = CNNTrainer(cfg, fl, "mnist", scale=0.005, device="cpu")
    got = make_engine(on_card).train_round(on_card.init_params(3),
                                           [0, 1, 3], 1)
    want = make_engine(on_cpu, engine="looped").train_round(
        on_cpu.init_params(3), [0, 1, 3], 1)
    torch.cuda.synchronize()
    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if g.device.type != "cuda" or g.shape != w.shape:
            fail("train_round: wrong device or shape")
        if not bool(torch.isfinite(g).all()):
            fail("train_round: non-finite parameters")
        worst = max(worst, float((g.cpu() - w).abs().max()))
    if worst > 2e-4:
        fail(f"train_round on the card is {worst} from the CPU round")
    return {"train_round_vs_cpu_max_abs": worst, "atol": 2e-4}


def _without_store_keys(hist):
    out = hist.to_json()
    out["meta"] = {k: v for k, v in out["meta"].items()
                   if k not in STORE_KEYS}
    return out


def async_path():
    """The async main path through the CLI: semi-async FedDCT over the
    client-state store with the fold-launch count read around it, the
    same run again, the same run on the dict path, and FedBuff; then a
    timed run on the warmed process."""
    import torch
    from repro_torch.config.base import FLConfig
    from repro_torch.core import run_method
    from repro_torch.fl.client import build_fl_clients
    from repro_torch.fl.network import WirelessNetwork
    from repro_torch.kernels import fedagg as fedagg_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import fl_train
    from repro_torch.runtime import async_loop

    # what the path hands the kernel, and the size of every window
    calls, windows = [], []
    real_fold = ops.fedagg_fold
    real_store, real_dict = (async_loop._merge_window_store,
                             async_loop._merge_window)

    def recording_fold(updates, g, coef):
        calls.append((int(updates.shape[0]), int(updates.shape[1]),
                      updates.device.type, g.device.type,
                      [float(x) for x in coef]))
        return real_fold(updates, g, coef)

    def recording_store(eng, store, params, batch, fl, version):
        windows.append(len(batch))
        return real_store(eng, store, params, batch, fl, version)

    def recording_dict(eng, params, snapshots, batch, fl, version):
        windows.append(len(batch))
        return real_dict(eng, params, snapshots, batch, fl, version)

    def drive(argv):
        calls.clear()
        windows.clear()
        zero_counts()
        t0 = time.perf_counter()
        hist = fl_train.main(argv)
        torch.cuda.synchronize()
        return (hist, time.perf_counter() - t0, fedagg_mod.fold_launches,
                list(calls), list(windows))

    ops.fedagg_fold = recording_fold
    async_loop._merge_window_store = recording_store
    async_loop._merge_window = recording_dict
    try:
        hist, first_s, launches, seen, wins = drive(ASYNC_ARGV)
        multi = sum(1 for w in wins if w >= 2)
        if launches != multi or launches < 1:
            fail(f"fedagg_fold launched {launches} times on the async "
                 f"path, which drained windows {wins}")
        if len(seen) != launches or any(
                k < 2 or p != MAIN_P or du != "cuda" or dg != "cuda"
                for k, p, du, dg, _ in seen):
            fail(f"async path gave fedagg_fold unexpected buffers: "
                 f"{[s[:4] for s in seen]}")
        meta = hist.meta
        if meta.get("store_path") != "store" or meta.get(
                "kernel_agg") is not True:
            fail(f"async path ran store_path={meta.get('store_path')!r} "
                 f"kernel_agg={meta.get('kernel_agg')!r}")
        if len(hist.rounds) != ASYNC_ROUNDS or not all(
                0.0 <= a <= 1.0 for a in hist.accuracy):
            fail(f"async path history: rounds {hist.rounds}, accuracy "
                 f"{hist.accuracy}")
        again = drive(ASYNC_ARGV)[0]
        if again.to_json() != hist.to_json():
            fail("two async runs with one seed gave different histories")
        on_dict, _, dict_launches, dict_seen, dict_wins = drive(
            ASYNC_ARGV + ["--no-store"])
        if on_dict.meta.get("store_path") != "dict":
            fail("--no-store did not take the dict path")
        if _without_store_keys(on_dict) != _without_store_keys(hist):
            fail("the store and dict paths gave different histories")
        if dict_launches != sum(1 for w in dict_wins if w >= 2):
            fail(f"dict path: {dict_launches} fold launches for windows "
                 f"{dict_wins}")
        buff_argv = [a if a != "feddct_async" else "fedbuff"
                     for a in ASYNC_ARGV]
        buff, _, buff_launches, buff_seen, buff_wins = drive(buff_argv)
        if (buff_launches != len(buff_wins) or buff_launches < 1
                or any(w != 5 for w in buff_wins)
                or any(k != 8 or p != MAIN_P or du != "cuda"
                       for k, p, du, _, _ in buff_seen)):
            fail(f"fedbuff: {buff_launches} fold launches, windows "
                 f"{buff_wins}, buffers {[s[:3] for s in buff_seen]}")
    finally:
        ops.fedagg_fold = real_fold
        async_loop._merge_window_store = real_store
        async_loop._merge_window = real_dict

    # timed run on the warmed process, through the same entry points
    fl = FLConfig(n_clients=50, n_tiers=5, tau=5, rounds=ASYNC_ROUNDS,
                  seed=0, lr=1e-3)
    net = WirelessNetwork(fl.n_clients, fl.tier_delay_means, fl.delay_std,
                          fl.mu, fl.failure_delay, fl.seed)
    trainer = build_fl_clients("cnn-mnist", fl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = run_method("feddct_async", trainer, net, fl)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if timed.to_json() != hist.to_json():
        fail("the timed async run's history differs from the CLI run's")
    summary = {"argv": ASYNC_ARGV, "rounds": hist.rounds,
               "accuracy": hist.accuracy, "times": hist.times,
               "n_selected": hist.n_selected,
               "n_stragglers": hist.n_stragglers, "windows": wins,
               "fold_launches": launches,
               "fold_shapes": [[k, p] for k, p, *_ in seen],
               "store_path": meta["store_path"],
               "store_reason": meta["store_reason"],
               "kernel_agg": meta["kernel_agg"],
               "dict_path_windows": dict_wins,
               "dict_path_fold_shapes": [[k, p] for k, p, *_ in dict_seen],
               "store_equals_dict": True, "two_runs_identical": True,
               "fedbuff_windows": buff_wins,
               "fedbuff_fold_launches": buff_launches,
               "fedbuff_fold_shapes": [[k, p] for k, p, *_ in buff_seen],
               "fedbuff_accuracy": buff.accuracy,
               "first_run_s": first_s, "warm_run_s": run_s,
               "warm_s_per_round": run_s / ASYNC_ROUNDS}
    return summary, launches, seen + buff_seen


# ---------------------------------------------------------------------
# Telemetry (repro_torch/obs) and int8 client rows, traced on the card
# ---------------------------------------------------------------------

TRACE_DIR = ROOT / "build" / "traces"
# spans a round of each path must show in a trace
SYNC_SPANS = {"run", "round.select", "round.train", "round.aggregate",
              "eval"}
ASYNC_SPANS = {"run", "round.select", "window.merge", "window.gather",
               "window.train", "window.merge_scatter", "store.merge",
               "store.scatter", "eval"}
# the reference's q8 convergence gate: best accuracy within one point
Q8_ACC_ATOL = 0.01
# untraced and traced runs of a path, in turns, for the overhead
OVERHEAD_TURNS = 5
# the reference's q8 convergence task (tests/test_state.py:
# test_feddct_async_quant8_cnn_convergence_gate): reduced cnn-mnist
Q8_TASK = dict(n_clients=8, n_tiers=2, tau=2, rounds=40, mu=0.0,
               primary_frac=0.7, seed=0, lr=0.003)


def _untraced_json(hist):
    """A history's JSON without the additive ``meta["telemetry"]``."""
    out = hist.to_json()
    out["meta"] = {k: v for k, v in out["meta"].items() if k != "telemetry"}
    return out


def read_spans(path):
    """The span records of a JSONL trace."""
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("type") == "span"]


def round_split(spans, first_warm: int = 2):
    """Where the warm rounds' time goes, from a run's spans: a round runs
    from its ``round.select`` to the next (the last to the end of the
    ``run`` span); rounds ``first_warm..`` are the warm ones.  Per span
    name in them: count, host seconds, device seconds (CUDA events).
    ``covered`` is the share of their wall time that the outermost spans
    (those inside no other span but ``run``) take on the host."""
    run = next(s for s in spans if s["name"] == "run")
    starts = sorted(s["ts_us"] for s in spans if s["name"] == "round.select")
    bounds = starts + [run["ts_us"] + run["dur_us"]]
    lo, hi = bounds[first_warm - 1], bounds[-1]
    inside = [s for s in spans
              if s["name"] != "run" and lo <= s["ts_us"] < hi]
    per = {}
    for s in inside:
        e = per.setdefault(s["name"], {"count": 0, "host_s": 0.0,
                                       "dev_s": 0.0})
        e["count"] += 1
        e["host_s"] += s["dur_us"] / 1e6
        e["dev_s"] += (s["dev_us"] or 0.0) / 1e6
    if any(s["dev_us"] is None for s in inside):
        fail("a span on the card carries no device time")

    def within(a, b):
        return (a is not b and b["ts_us"] <= a["ts_us"]
                and a["ts_us"] + a["dur_us"] <= b["ts_us"] + b["dur_us"])

    top = [s for s in inside if not any(within(s, o) for o in inside)]
    n_warm = len(bounds) - first_warm
    wall_s = (hi - lo) / 1e6
    return {"warm_rounds": n_warm, "warm_wall_s": wall_s,
            "warm_s_per_round": wall_s / n_warm,
            "covered": sum(s["dur_us"] for s in top) / (hi - lo),
            "outermost": sorted({s["name"] for s in top}),
            "spans": per}


def _check_trace(path, fmt, needed):
    """The port's validator accepts the trace and its spans cover
    ``needed``; the report renders from it."""
    from repro_torch.obs import report as obs_report
    from repro_torch.obs import validate as obs_validate
    if fmt == "chrome":
        errors, found = obs_validate.validate_chrome_file(str(path))
        with open(path) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X"}
    else:
        errors, found = obs_validate.validate_file(str(path))
        names = {s["name"] for s in read_spans(path)}
    if errors:
        fail(f"{path.name} ({fmt}) does not validate: {errors[:5]}")
    if not needed <= names:
        fail(f"{path.name} misses spans {sorted(needed - names)}")
    summary, history = obs_report.load_source(str(path))
    text = obs_report.format_report(obs_report.build_report(summary,
                                                            history))
    if "FL run report" not in text:
        fail(f"the report of {path.name} did not render")
    return {"format": fmt, "records": found, "report_lines":
            len(text.splitlines())}


def _drive(argv):
    """One ``fl_train`` run with the launch counts set to 0 just before
    it: (history, host seconds of its ``run_method`` call, launch
    counts, final model).  The run's seconds end in a synchronize and
    take in what tracing adds inside the run (its summary's readback),
    not the trainer's set-up or the trace's export."""
    import torch
    from repro_torch.launch import fl_train
    from repro_torch.obs import telemetry as obs_tel
    models, run_s = [], []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
        return out

    def timed_summary(self):
        t0 = time.perf_counter()
        out = real_summary(self)
        SUMMARY_S.append(time.perf_counter() - t0)
        return out

    with recording_evaluations(models), \
            patched(fl_train, "run_method", timed) as real, \
            patched(obs_tel.Telemetry, "summary",
                    timed_summary) as real_summary:
        zero_counts()
        hist = fl_train.main(argv)
    return hist, run_s[0], counts(), models[-1]


# seconds of every ``Telemetry.summary`` call in ``_drive``'s runs
SUMMARY_S = []


def span_cost_us(n: int = 2000):
    """Host microseconds of one empty ``with TEL.span(...)`` on the card:
    tracing off (the no-op), and on (two CUDA events recorded), the
    median of 9 runs of ``n`` each; and of one ``resolve`` of those
    events."""
    import torch
    from repro_torch.obs import telemetry as obs_tel
    out = {}
    for mode in ("off", "on"):
        runs = []
        for _ in range(9):
            tel = obs_tel.Telemetry() if mode == "on" else obs_tel.NOOP
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                with tel.span("x"):
                    pass
            runs.append((time.perf_counter() - t0) / n * 1e6)
            if mode == "on":
                t0 = time.perf_counter()
                tel.resolve()
                out["resolve_us_per_span"] = ((time.perf_counter() - t0)
                                              / n * 1e6)
        out[mode] = statistics.median(runs)
    return out


def device_busy(argv):
    """One more warm run of ``argv`` under ``torch.profiler``: the share
    of its ``run_method`` wall time in which a kernel ran on the card
    (the union of the kernels' intervals), and the five kernels with
    the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import fl_train
    wall = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        return out

    with patched(fl_train, "run_method", timed) as real, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        fl_train.main(argv)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = union_s((e.time_range.start, e.time_range.end) for e in kernels)
    per = {}
    for e in kernels:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return {"run_s": wall[0], "kernels": len(kernels),
            "busy_s": busy / 1e6,
            "busy_share": busy / 1e6 / wall[0] if kernels else None,
            "top_kernels_s": [[n[:80], t / 1e6] for n, t in top]}


def traced_path(argv, needed, tag: str, rounds: int):
    """One FL path untraced and traced in turns, ``OVERHEAD_TURNS``
    each (``fl_train --trace <jsonl>``, the first with ``--report``),
    then once traced in the chrome format: every traced history and
    final model must equal the untraced ones bit for bit and launch the
    same kernels, both formats validate and report, the warm rounds'
    spans give the split, and the median seconds a round give the
    tracing overhead.  Returns (summary, untraced history, its final
    model, the first traced run's telemetry summary)."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    jpath = TRACE_DIR / f"{tag}.jsonl"
    cpath = TRACE_DIR / f"{tag}.json"
    runs = {"untraced": [], "traced": []}
    SUMMARY_S.clear()
    for turn in range(OVERHEAD_TURNS):
        runs["untraced"].append(_drive(argv))
        extra = ["--report"] if turn == 0 else []
        runs["traced"].append(_drive(argv + ["--trace", str(jpath)]
                                     + extra))
        if turn == 0:
            first_spans = read_spans(jpath)
    chrome = _drive(argv + ["--trace", str(cpath), "--trace-format",
                            "chrome"])
    plain, _, plain_counts, plain_model = runs["untraced"][0]
    if "telemetry" in plain.meta:
        fail(f"{tag}: the untraced run carries telemetry")
    for hist, _, launched, model in (runs["untraced"] + runs["traced"]
                                     + [chrome]):
        traced = "telemetry" in hist.meta
        if _untraced_json(hist) != plain.to_json() or not _models_equal(
                model, plain_model):
            fail(f"{tag}: a {'traced' if traced else 'untraced'} run's "
                 f"history or final model differs")
        if launched != plain_counts:
            fail(f"{tag}: launch counts differ: {launched} "
                 f"{plain_counts}")
    tel = runs["traced"][0][0].meta["telemetry"]
    per_round = {m: [r[1] / rounds for r in rs] for m, rs in runs.items()}
    med = {m: statistics.median(t) for m, t in per_round.items()}
    low = {m: min(t) for m, t in per_round.items()}
    summary = {"argv": argv, "accuracy": plain.accuracy,
               "traced_equals_untraced": True,
               "traces": [_check_trace(jpath, "jsonl", needed),
                          _check_trace(cpath, "chrome", needed)],
               "launches": plain_counts,
               "warm_split": round_split(first_spans),
               "run_span": tel["spans"]["run"],
               "kernel_builds": tel["counters"].get("kernel.builds", 0),
               "s_per_round": per_round,
               "median_untraced_s_per_round": med["untraced"],
               "median_traced_s_per_round": med["traced"],
               "tracing_overhead": med["traced"] / med["untraced"] - 1.0,
               "tracing_overhead_of_minima": (low["traced"]
                                              / low["untraced"] - 1.0),
               "summary_s": list(SUMMARY_S),
               "device_busy_untraced": device_busy(argv),
               "trace_files": [str(p.relative_to(ROOT))
                               for p in (jpath, cpath)]}
    return summary, plain, plain_model, tel


def traced_main_path():
    summary, plain, _, _ = traced_path(MAIN_ARGV, SYNC_SPANS, "main", 5)
    live = sum(1 for s, g in zip(plain.n_selected, plain.n_stragglers)
               if s - g > 0)
    if summary["launches"] != only(fedagg=live) or live < 1:
        fail(f"traced main path launched {summary['launches']}, "
             f"{live} rounds had survivors")
    summary["span_cost_us"] = span_cost_us()
    return summary


def traced_async_path():
    summary, plain, model, tel = traced_path(ASYNC_ARGV, ASYNC_SPANS,
                                             "async", ASYNC_ROUNDS)
    if summary["launches"]["fedagg_fold"] < 1 or any(
            n for k, n in summary["launches"].items() if k != "fedagg_fold"):
        fail(f"traced async path launched {summary['launches']}")
    if "fl.cohort.update_norm" not in tel["hists"]:
        fail("the traced async run recorded no cohort update norm")
    summary["update_norm"] = tel["hists"]["fl.cohort.update_norm"]
    return summary, (plain, model, tel)


def _host(t):
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def recording_quantization(record):
    """What the q8 store is given and keeps, copied to the host: per
    ``_quantize_for`` call the client ids, the global row, the rows the
    quantizer was given (row + residual), its int8 rows and meta and
    the residuals kept after it; and the store (``record["store"]``)."""
    from repro_torch.core import state as state_mod
    from repro_torch.runtime import async_loop
    record.update(calls=[], store=None)
    last = {}

    def quantize(x, segs):
        q, m = real_q(x, segs)
        last.update(x=_host(x), q=_host(q), m=_host(m))
        return q, m

    def quantize_for(self, ids, frow):
        last.clear()
        out = real_for(self, ids, frow)
        kept = [self.ef_residual(c) for c in ids]
        record["calls"].append({
            "ids": [int(c) for c in ids], "frow": _host(frow), **last,
            "ef": [None if r is None else _host(r) for r in kept]})
        return out

    def resolve(*a, **kw):
        store, reason = real_resolve(*a, **kw)
        record["store"] = store
        return store, reason

    with patched(state_mod, "quantize_rows", quantize) as real_q, \
            patched(state_mod.ClientStateStore, "_quantize_for",
                    quantize_for) as real_for, \
            patched(async_loop, "_resolve_store", resolve) as real_resolve:
        yield


def check_quantization(record, error_feedback: bool):
    """Every row the q8 store quantized, held to the numpy oracle
    exactly: the rows the quantizer was given are the global row plus
    the client's last residual (or the row alone); its int8 rows and
    meta equal ``quantize_rows_ref`` of them; the card's dequantized
    rows equal ``dequantize_rows_ref``; each kept residual is ``x -
    dq(q(x))`` of the oracle.  Then the store's buffers, ``gather`` and
    ``gather_one`` at the end of the run against the last write of each
    client."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import dequantize_rows
    from repro_torch.kernels.ref import dequantize_rows_ref, quantize_rows_ref
    from repro_torch.tree import tree_leaves
    store = record["store"]
    segs = store._fsegs
    if not record["calls"] or store.quant_bits != 8:
        fail(f"the q8 run quantized nothing ({len(record['calls'])} calls)")
    if store.error_feedback is not error_feedback:
        fail(f"store.error_feedback is {store.error_feedback}")
    prev, last = {}, {}
    rows = 0
    for call in record["calls"]:
        x = call["x"]
        for j, c in enumerate(call["ids"]):
            want = call["frow"] + prev[c] if c in prev else call["frow"]
            if not np.array_equal(x[j], want):
                fail(f"client {c}: the quantizer was not given row + "
                     f"residual")
        qr, mr = quantize_rows_ref(x, segs)
        if not (np.array_equal(call["q"], qr)
                and np.array_equal(call["m"], mr)):
            fail(f"q8 rows of clients {call['ids']} differ from the oracle")
        dqr = dequantize_rows_ref(qr, mr, segs)
        dq = _host(dequantize_rows(torch.from_numpy(call["q"]).cuda(),
                                   torch.from_numpy(call["m"]).cuda(),
                                   segs))
        if not np.array_equal(dq, dqr):
            fail("the card's dequantized rows differ from the oracle")
        for j, c in enumerate(call["ids"]):
            r = call["ef"][j]
            if error_feedback:
                if r is None or not np.array_equal(r, x[j] - dqr[j]):
                    fail(f"client {c}: residual != x - dq(q(x))")
                prev[c] = r
            elif r is not None:
                fail(f"client {c}: a residual kept with EF off")
            last[c] = (qr[j], mr[j], dqr[j])
        rows += len(call["ids"])
    qbuf, mbuf = _host(store.bufs[0]), _host(store.bufs[1])
    ids = sorted(last)
    stacked = store.gather(ids)
    flat = torch.cat([l.reshape(len(ids), -1).float()
                      for l in tree_leaves(stacked)], 1)
    flat = _host(flat)
    for i, c in enumerate(ids):
        q, m, dq = last[c]
        one = _host(store.flatten(store.gather_one(c)))
        if not (np.array_equal(qbuf[c], q) and np.array_equal(mbuf[c], m)
                and np.array_equal(one, dq) and np.array_equal(flat[i], dq)):
            fail(f"client {c}: the store's row differs from its last write")
    return {"quantize_calls": len(record["calls"]), "rows_checked": rows,
            "clients_checked": len(ids), "oracle_exact": True}


def q8_convergence():
    """The reference's q8 convergence gate on its own task, on the card:
    f32 store, int8 + EF and int8 without EF; int8 + EF's best accuracy
    within ``Q8_ACC_ATOL`` of f32's, trajectories that differ (the rows
    are quantized, EF is live) and fewer uplink bytes."""
    from repro_torch.config import get_arch
    from repro_torch.config.base import FLConfig
    from repro_torch.fl.client import CNNTrainer
    from repro_torch.fl.network import WirelessNetwork
    from repro_torch.runtime.async_loop import run_feddct_async
    fl = FLConfig(**Q8_TASK)
    runs = {}
    for name, kw in (("f32", dict(use_store=True)),
                     ("q8", dict(quant_bits=8)),
                     ("q8_no_ef", dict(quant_bits=8,
                                       error_feedback=False))):
        zero_counts()
        trainer = CNNTrainer(get_arch("cnn-mnist").reduced(), fl, "mnist",
                             scale=0.05)
        net = WirelessNetwork(fl.n_clients, fl.tier_delay_means,
                              fl.delay_std, fl.mu, fl.failure_delay, fl.seed)
        runs[name] = (run_feddct_async(trainer, net, fl, **kw), counts())
    (h32, _), (h8, c8), (h8n, _) = (runs["f32"], runs["q8"],
                                    runs["q8_no_ef"])
    gap = abs(max(h32.accuracy) - max(h8.accuracy))
    if gap > Q8_ACC_ATOL or h8.accuracy == h32.accuracy \
            or h8.accuracy == h8n.accuracy \
            or h8.meta["bytes_up"] >= h32.meta["bytes_up"]:
        fail(f"q8 convergence on the reference's task: best "
             f"{max(h8.accuracy)} vs f32 {max(h32.accuracy)}, no-EF "
             f"{max(h8n.accuracy)}, bytes {h8.meta['bytes_up']} vs "
             f"{h32.meta['bytes_up']}")
    if c8["fedagg_fold"] < 1:
        fail(f"q8 convergence run launched {c8}")
    return {"config": Q8_TASK, "arch": h8.arch,
            "best_accuracy": {n: max(h.accuracy) for n, (h, _) in
                              runs.items()},
            "final_accuracy": {n: h.accuracy[-1] for n, (h, _) in
                               runs.items()},
            "best_acc_gap": gap, "atol": Q8_ACC_ATOL,
            "bytes_up": {n: h.meta["bytes_up"] for n, (h, _) in
                         runs.items()},
            "q8_fold_launches": c8["fedagg_fold"]}


def quant_async_path(f32):
    """``ASYNC_ARGV --quant-bits 8`` traced, with error feedback (twice,
    the second recorded and held to the oracle) and without it
    (recorded); ``--quant-bits 32`` against the default; the
    reference's q8 gates against the f32 run of ``traced_async_path``."""
    import numpy as np
    from repro_torch.tree import tree_leaves
    f32_plain, f32_model, f32_tel = f32
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    q8 = ASYNC_ARGV + ["--quant-bits", "8"]
    paths = {t: TRACE_DIR / f"q8_{t}.jsonl" for t in ("ef", "ef2", "noef")}
    a, a_s, a_counts, a_model = _drive(q8 + ["--trace", str(paths["ef"])])
    rec = {}
    with recording_quantization(rec):
        b, _, b_counts, b_model = _drive(
            q8 + ["--trace", str(paths["ef2"])])
    if _untraced_json(a) != _untraced_json(b) or not _models_equal(
            a_model, b_model):
        fail("two seeded q8 runs differ")
    ef_check = check_quantization(rec, error_feedback=True)
    rec.clear()
    rec_n = {}
    with recording_quantization(rec_n):
        c, _, c_counts, _ = _drive(q8 + ["--no-error-feedback", "--trace",
                                         str(paths["noef"])])
    noef_check = check_quantization(rec_n, error_feedback=False)
    rec_n.clear()
    d, _, _, d_model = _drive(ASYNC_ARGV + ["--quant-bits", "32"])
    if d.to_json() != f32_plain.to_json() or not _models_equal(
            d_model, f32_model):
        fail("--quant-bits 32 differs from the default run")
    for name, counts_ in (("ef", a_counts), ("ef2", b_counts),
                          ("noef", c_counts)):
        if counts_["fedagg_fold"] < 1 or any(
                n for k, n in counts_.items() if k != "fedagg_fold"):
            fail(f"q8 {name} run launched {counts_}")
    traces = [_check_trace(paths[t], "jsonl", ASYNC_SPANS) for t in paths]
    # the reference's formulas: int8 rows + (scale, snap) f32 a float
    # leaf; no int32 sidecar in the CNN
    p = sum(x.numel() for x in a_model)
    n_leaves = len(a_model)
    if p != MAIN_P:
        fail(f"q8 model has {p} parameters")
    for h, ef in ((a, True), (c, False)):
        m = h.meta
        if (m["quant_bits"], m["error_feedback"], m["store_path"]) != (
                8, ef, "store"):
            fail(f"q8 meta: {m['quant_bits']} {m['error_feedback']} "
                 f"{m['store_path']}")
        if m["wire_bytes_per_update"] != p + 8 * n_leaves:
            fail(f"wire_bytes_per_update {m['wire_bytes_per_update']}")
        n_clients = int(q8[q8.index("--clients") + 1])
        if m["store_bytes_hot"] != n_clients * (p + 8 * n_leaves):
            fail(f"store_bytes_hot {m['store_bytes_hot']}")
        if m["bytes_up"] >= f32_plain.meta["bytes_up"]:
            fail(f"q8 bytes_up {m['bytes_up']} not below f32's")
    if a.meta["store_bytes_ef"] <= 0 or c.meta["store_bytes_ef"] != 0:
        fail(f"store_bytes_ef {a.meta['store_bytes_ef']} / "
             f"{c.meta['store_bytes_ef']}")
    acc_gap = abs(max(a.accuracy) - max(f32_plain.accuracy))
    if acc_gap > Q8_ACC_ATOL:
        fail(f"q8 best accuracy {max(a.accuracy)} is {acc_gap} from "
             f"f32's {max(f32_plain.accuracy)}")
    tel = a.meta["telemetry"]
    task = q8_convergence()

    def cost(t, name):
        s = t["spans"].get(name, {})
        return {k: s.get(k) for k in ("count", "total_s", "dev_total_s")}

    split_names = ("store.scatter", "window.gather", "store.merge",
                   "window.train", "round.select")
    return {"argv": q8, "accuracy": a.accuracy,
            "accuracy_no_ef": c.accuracy,
            "reference_task": task,
            "f32_accuracy": f32_plain.accuracy, "best_acc_gap": acc_gap,
            "atol": Q8_ACC_ATOL, "two_runs_identical": True,
            "quant32_equals_default": True,
            "ef_oracle": ef_check, "no_ef_oracle": noef_check,
            "launches": a_counts, "traces": traces,
            "meta": {k: a.meta[k] for k in (
                "quant_bits", "error_feedback", "wire_bytes_per_update",
                "bytes_up", "store_bytes_hot", "store_bytes_cold",
                "store_bytes_ef", "store_reason")},
            "f32_meta": {k: f32_plain.meta[k] for k in (
                "wire_bytes_per_update", "bytes_up", "store_bytes_hot")},
            "run_s": a_s,
            "q8_vs_f32": {n: {"q8": cost(tel, n), "f32": cost(f32_tel, n)}
                          for n in split_names},
            "warm_split": round_split(read_spans(paths["ef"]))}


# ---------------------------------------------------------------------
# Tiered client-state residency (core/residency.py) on the card
# ---------------------------------------------------------------------

# the at-size runs: semi-async FedDCT over 2,000 full-width clients
# (synthetic MNIST at the paper's 60,000 samples, 30 a client), a hot
# tier of 8 rows; a dense f32 store would hold 2,000 x 6,520,360 B
TIER_N = 2000
TIER_ROUNDS = 6
TIER_HOT = 8
TIER_ARGV = ["--arch", "cnn-mnist", "--method", "feddct_async",
             "--clients", str(TIER_N), "--tiers", "5", "--tau", "5",
             "--rounds", str(TIER_ROUNDS), "--seed", "0", "--scale", "1.0"]
# dense - tiered peak device memory (GB) the at-size runs must show:
# (2,000 - 8) rows are 12.99 GB in f32 and 3.25 GB in int8
TIER_SAVED_GB = {32: 12.0, 8: 3.0}
# the on-card interleavings: clients, steps, and a float leaf wide
# enough (512 KB) that a copy left unordered would be caught mid-flight
CARD_N = 6
CARD_STEPS = 40
CARD_WIDE = 1 << 17
# spans of a tiered round read beside the dense round's
TIER_SPANS = ("window.stage", "window.prefetch", "window.gather",
              "window.train", "store.merge", "store.scatter",
              "round.select", "residency.promote", "residency.write_behind",
              "residency.host_gather")


def _buff(argv, window: int):
    return [a if a != "feddct_async" else "fedbuff" for a in argv] + [
        "--window", str(window)]


@contextlib.contextmanager
def recording_stores(stores):
    """Every client-state store an async run builds, into ``stores``."""
    from repro_torch.runtime import async_loop

    def resolve(*a, **kw):
        store, reason = real(*a, **kw)
        stores.append(store)
        return store, reason

    with patched(async_loop, "_resolve_store", resolve) as real:
        yield


def _same_history(a, b) -> bool:
    """Two histories equal in everything but the snapshot path's keys
    and the additive telemetry block."""
    drop = STORE_KEYS | {"telemetry"}

    def js(h):
        out = h.to_json()
        out["meta"] = {k: v for k, v in out["meta"].items()
                       if k not in drop}
        return out

    return js(a) == js(b)


def _trees_equal(a, b) -> bool:
    import torch
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def check_tiered_store(tiered, dense, capacity: int, cold: str,
                       block: int = 64):
    """A tiered store at the end of a run against the dense store of the
    same run: every client's row served bit for bit (``block`` clients
    at a time; the cohort-wider-than-capacity path when ``block`` >
    capacity), the same residuals and residual bytes, at most
    ``capacity`` residuals on the card and the rest pinned, and the
    host tier's rows pinned."""
    import torch
    from repro_torch.core.residency import TieredClientStateStore
    if not isinstance(tiered, TieredClientStateStore) or \
            tiered.residency != f"tiered-{cold}" or tiered.rows != capacity:
        fail(f"a --hot-rows {capacity} run built {type(tiered).__name__} "
             f"({getattr(tiered, 'residency', None)}, "
             f"{getattr(tiered, 'rows', None)} rows)")
    for lo in range(0, dense.n, block):
        ids = list(range(lo, min(lo + block, dense.n)))
        if not _trees_equal(tiered.gather(ids), dense.gather(ids)):
            fail(f"tiered-{cold} at {capacity} hot rows serves rows "
                 f"{ids[0]}..{ids[-1]} unlike the dense store")
    ef_t, ef_d = tiered.bytes_by_tier()["ef"], dense.bytes_by_tier()["ef"]
    if ef_t != ef_d or len(tiered._ef) > capacity or not all(
            r.is_cuda for r in tiered._ef.values()) or not all(
            r.is_pinned() for r in tiered._ef_cold.values()):
        fail(f"residuals: {len(tiered._ef)} on the card, "
             f"{len(tiered._ef_cold)} on the host, {ef_t} B vs dense "
             f"{ef_d} B")
    for c in dense._ef:
        if not torch.equal(tiered.ef_residual(c).cuda(),
                           dense.ef_residual(c)):
            fail(f"client {c}: its residual differs from the dense store's")
    # (a zero-width segment, the CNN's empty sidecar, has no memory)
    if cold == "host" and not all(
            t.is_pinned() or t.numel() == 0
            for row in list(tiered.cold._rows.values()) + [tiered.cold._t]
            for t in row):
        fail("the host cold tier holds pageable rows")
    return {"hot_clients": len(tiered.hot_clients),
            "promoted": tiered.n_promoted, "demoted": tiered.n_demoted,
            "cold_rows": len(tiered.cold) if cold == "host" else None,
            "ef_on_card": len(tiered._ef), "ef_on_host": len(tiered._ef_cold),
            "bytes": tiered.bytes_by_tier()}


def check_disk_reload(tiered, dense):
    """The disk tier flushed and reloaded into a fresh ``DiskColdTier``
    over the same directory: the fresh tier's rows equal the flushed
    tier's, and the cold clients' rows equal the dense store's."""
    import torch
    from repro_torch.core.residency import DiskColdTier
    tiered.cold.flush()
    fresh = DiskColdTier(tiered.cold.dir, tiered.n,
                         *[b[0] for b in tiered.bufs],
                         chunk=tiered.cold.chunk)
    everyone = list(range(tiered.n))
    got, kept = fresh.read(everyone, "cuda"), tiered.cold.read(everyone,
                                                               "cuda")
    if not all(torch.equal(a, b) for a, b in zip(got, kept)):
        fail("the reloaded disk tier differs from the flushed one")
    cold = [c for c in everyone if c not in set(tiered.hot_clients)]
    rows = fresh.read(cold, "cuda")
    if not _trees_equal(tiered._rows_to_tree(rows, len(cold)),
                        dense.gather(cold)):
        fail("the reloaded disk rows differ from the dense store's")
    return {"files": sorted(f for f in os.listdir(tiered.cold.dir)
                            if f.endswith(".npz")),
            "cold_clients_checked": len(cold)}


def tiered_parity():
    """ASYNC_ARGV's semi-async FedDCT and FedBuff (window 4), dense
    against tiered host (50, 8, 1 hot rows) and disk (8, 1), and int8
    rows dense against tiered host and disk at 8: histories, final
    models, fold launches and residual bytes equal; the stores' rows
    equal; one disk run flushed and reloaded."""
    import tempfile
    n = int(ASYNC_ARGV[ASYNC_ARGV.index("--clients") + 1])
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for method, argv in (("feddct_async", ASYNC_ARGV),
                             ("fedbuff", _buff(ASYNC_ARGV, 4))):
            for bits, variants in (
                    (32, [("host", n), ("host", 8), ("host", 1),
                          ("disk", 8), ("disk", 1)]),
                    (8, [("host", 8), ("disk", 8)])):
                quant = ["--quant-bits", "8"] if bits == 8 else []
                stores = []
                with recording_stores(stores):
                    d_hist, d_s, d_counts, d_model = _drive(argv + quant)
                dense = stores[-1]
                if d_hist.meta["residency"] != "dense" or \
                        d_counts["fedagg_fold"] < 1:
                    fail(f"{method} q{bits} dense: {d_hist.meta['residency']}"
                         f", {d_counts}")
                for cold, hot in variants:
                    extra = ["--hot-rows", str(hot)]
                    if cold == "disk":
                        extra += ["--cold-dir",
                                  os.path.join(tmp, f"{method}{bits}_{hot}")]
                    stores.clear()
                    with recording_stores(stores):
                        hist, run_s, launched, model = _drive(argv + quant
                                                              + extra)
                    tag = f"{method} q{bits} tiered-{cold} {hot}"
                    m = hist.meta
                    if (m["residency"], m["hot_rows"]) != (f"tiered-{cold}",
                                                           hot):
                        fail(f"{tag}: meta {m['residency']} {m['hot_rows']}")
                    if not _same_history(hist, d_hist) or \
                            not _models_equal(model, d_model):
                        fail(f"{tag}: history or final model differs from "
                             f"the dense run's")
                    if launched != d_counts:
                        fail(f"{tag}: launches {launched} vs {d_counts}")
                    if m["store_bytes_ef"] != d_hist.meta["store_bytes_ef"]:
                        fail(f"{tag}: store_bytes_ef {m['store_bytes_ef']} "
                             f"vs {d_hist.meta['store_bytes_ef']}")
                    store = check_tiered_store(stores[-1], dense, hot, cold)
                    if method == "feddct_async" and bits == 32 and \
                            cold == "disk" and hot == 8:
                        store["reload"] = check_disk_reload(stores[-1],
                                                            dense)
                    runs.append({
                        "method": method, "quant_bits": bits, "cold": cold,
                        "hot_rows": hot, "fold_launches":
                            launched["fedagg_fold"],
                        "s_per_round": run_s / ASYNC_ROUNDS,
                        "dense_s_per_round": d_s / ASYNC_ROUNDS,
                        "store_bytes": {k: m[k] for k in (
                            "store_bytes_hot", "store_bytes_cold",
                            "store_bytes_ef")},
                        "store": store})
                stores.clear()
    return runs


def _card_trees(int_sidecar: bool):
    """A template and a draw of random trees of its structure on the
    card, from a seed: a 512 KB f32 leaf, a bf16, an f16 and a scalar
    leaf; or (int sidecar) the wide leaf, a bf16 leaf and int32, bool
    and int8 leaves."""
    import torch

    def draw(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)

        def normal(*shape):
            return torch.randn(shape, generator=g, device="cuda")

        def ints(lo, hi, *shape):
            return torch.randint(lo, hi, shape, generator=g, device="cuda")

        if int_sidecar:
            return {"w": normal(CARD_WIDE),
                    "b": normal(4).to(torch.bfloat16),
                    "step": ints(0, 1000).to(torch.int32),
                    "mask": ints(0, 2, 5).to(torch.bool),
                    "i8": ints(-128, 128, 3).to(torch.int8)}
        return {"w": normal(CARD_WIDE // 2, 2),
                "b": normal(5).to(torch.bfloat16),
                "h": normal(3).to(torch.float16), "s": normal()}

    return draw


def card_interleaving(capacity: int, int_sidecar: bool, use_kernel: bool,
                      quant_bits: int):
    """``tests/test_residency.py``'s randomized interleaving on the card,
    with prefetch (side-stream copies, right or wrong lookahead, a
    pinned cohort) among the ops: every value the tiered store serves
    equals the dense store's bit for bit."""
    import numpy as np
    from repro_torch.core.aggregation import staleness_merge_coefficients
    from repro_torch.core.residency import TieredClientStateStore
    from repro_torch.core.state import ClientStateStore
    draw = _card_trees(int_sidecar)
    tpl = draw(0)
    dense = ClientStateStore(tpl, CARD_N, quant_bits=quant_bits)
    tiered = TieredClientStateStore(tpl, CARD_N, capacity=capacity,
                                    quant_bits=quant_bits)
    rng = np.random.default_rng(100 + capacity)
    tag = (f"capacity {capacity}, {'int' if int_sidecar else 'float'}, "
           f"{'kernel' if use_kernel else 'plain'}, q{quant_bits}")
    ops = [0] * 5
    for step in range(CARD_STEPS):
        op = int(rng.integers(0, 5))
        ops[op] += 1
        if op == 0:
            ids = rng.integers(0, CARD_N, size=rng.integers(1, 7)).tolist()
            same = _trees_equal(dense.gather(ids), tiered.gather(ids))
        elif op == 1:
            ids = rng.choice(CARD_N, size=rng.integers(1, 4),
                             replace=False).tolist()
            t = draw(int(rng.integers(1 << 20)))
            same = _trees_equal(dense.scatter_params(ids, t),
                                tiered.scatter_params(ids, t))
        elif op == 2:
            ids = rng.choice(CARD_N, size=rng.integers(1, 3),
                             replace=False).tolist()
            flat = dense.flatten(draw(int(rng.integers(1 << 20))))
            dense.scatter(ids, flat)
            tiered.scatter(ids, flat)
            same = True
        elif op == 3:
            k = int(rng.integers(1, 6))
            ids = rng.choice(CARD_N, size=k, replace=False).tolist()
            coef = staleness_merge_coefficients(
                rng.random(k).astype(np.float32))
            g = draw(int(rng.integers(1 << 20)))
            na, _ = dense.merge_scatter(ids, dense.gather(ids), coef, g,
                                        use_kernel=use_kernel)
            nb, _ = tiered.merge_scatter(ids, tiered.gather(ids), coef, g,
                                         use_kernel=use_kernel)
            same = _trees_equal(na, nb)
        else:
            tiered.prefetch(rng.integers(0, CARD_N, size=3).tolist(),
                            keep=rng.integers(0, CARD_N, size=1).tolist())
            same = True
        c = int(rng.integers(0, CARD_N))
        if not same or not _trees_equal(dense.gather_one(c),
                                        tiered.gather_one(c)):
            fail(f"on-card interleaving ({tag}) differs from dense at step "
                 f"{step} (op {op})")
    everyone = list(range(CARD_N))
    if not _trees_equal(dense.gather(everyone), tiered.gather(everyone)):
        fail(f"on-card interleaving ({tag}): final rows differ")
    if tiered.bytes_by_tier()["ef"] != dense.bytes_by_tier()["ef"] or \
            len(tiered._ef) > capacity:
        fail(f"on-card interleaving ({tag}): residuals")
    if capacity < CARD_N and tiered.n_promoted == 0:
        fail(f"on-card interleaving ({tag}): nothing was promoted")
    return {"ops": ops, "promoted": tiered.n_promoted,
            "demoted": tiered.n_demoted}


def card_interleavings():
    out = {}
    for bits in (32, 8):
        for int_sidecar in (False, True):
            for use_kernel in (False, True):
                for cap in (CARD_N, CARD_N // 2, 1):
                    key = (f"q{bits}/{'int' if int_sidecar else 'float'}/"
                           f"{'kernel' if use_kernel else 'plain'}/{cap}")
                    out[key] = card_interleaving(cap, int_sidecar,
                                                 use_kernel, bits)
    return out


def _peak_run(argv):
    """``_drive`` of ``argv`` with the stores recorded and the card's
    peak allocated memory read around it."""
    import gc
    import torch
    stores = []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with recording_stores(stores):
        out = _drive(argv)
    peak = torch.cuda.max_memory_allocated()
    return out, stores[-1], {"before_bytes": before, "peak_bytes": peak}


def tiered_at_size():
    """``TIER_ARGV`` tiered (host tier, ``TIER_HOT`` rows) then dense in
    one process, f32 and int8 rows, traced; FedBuff (window 4) the same
    way.  Histories, final models and launches equal; the stores' rows
    equal; dense - tiered peak device memory at least
    ``TIER_SAVED_GB``; the residency counters; s/round and, per span,
    the split of the warm rounds."""
    from repro_torch.fl import client as fl_client
    from repro_torch.launch import fl_train
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    built = {}

    def build_once(arch, fl, **kw):
        # one synthetic MNIST of 60,000 samples serves every run
        key = (arch, fl, tuple(sorted(kw.items())))
        if key not in built:
            built[key] = fl_client.build_fl_clients(arch, fl, **kw)
        return built[key]

    out = {"argv": TIER_ARGV, "hot_rows": TIER_HOT, "runs": {}}
    with patched(fl_train, "build_fl_clients", build_once):
        for name, argv in (("feddct_async", TIER_ARGV),
                           ("feddct_async_q8",
                            TIER_ARGV + ["--quant-bits", "8"]),
                           ("fedbuff", _buff(TIER_ARGV, 4))):
            res = {}
            # tiered first: the dense store must not be alive while the
            # tiered run's peak is read
            for tag, extra in (("tiered", ["--hot-rows", str(TIER_HOT)]),
                               ("dense", [])):
                path = TRACE_DIR / f"tiered_{name}_{tag}.jsonl"
                run, store, mem = _peak_run(argv + extra
                                            + ["--trace", str(path)])
                res[tag] = (*run, store, mem, path)
            hist, run_s, launched, model, tiered, mem, path = res.pop(
                "tiered")
            d_hist, d_s, d_counts, d_model, dense, d_mem, d_path = res.pop(
                "dense")
            if hist.meta["residency"] != "tiered-host" or \
                    d_hist.meta["residency"] != "dense":
                fail(f"{name}: residency {hist.meta['residency']} / "
                     f"{d_hist.meta['residency']}")
            if not _same_history(hist, d_hist) or not _models_equal(
                    model, d_model) or launched != d_counts:
                fail(f"{name} at {TIER_N} clients: the tiered history, "
                     f"final model or launches ({launched} vs {d_counts}) "
                     f"differ from dense")
            store = check_tiered_store(tiered, dense, TIER_HOT, "host")
            del dense, tiered
            bits = 8 if name.endswith("q8") else 32
            saved = d_mem["peak_bytes"] - mem["peak_bytes"]
            floor = TIER_SAVED_GB[bits] if name != "fedbuff" else None
            if floor is not None and saved < floor * 1e9:
                fail(f"{name}: dense - tiered peak {saved / 1e9:.3f} GB < "
                     f"{floor} GB")
            tel, d_tel = hist.meta["telemetry"], d_hist.meta["telemetry"]
            row = {
                "accuracy": hist.accuracy, "launches": launched,
                "dense_peak_bytes": d_mem["peak_bytes"],
                "tiered_peak_bytes": mem["peak_bytes"],
                "before_bytes": [mem["before_bytes"], d_mem["before_bytes"]],
                "saved_bytes": saved, "saved_gb_floor": floor,
                "dense_s_per_round": d_s / TIER_ROUNDS,
                "tiered_s_per_round": run_s / TIER_ROUNDS,
                "counters": {k: v for k, v in tel["counters"].items()
                             if k.startswith(("residency.", "lookahead."))},
                "rates": tel.get("rates", {}),
                "meta": {k: hist.meta[k] for k in (
                    "store_bytes_hot", "store_bytes_cold",
                    "store_bytes_ef", "bytes_up")},
                "dense_meta": {k: d_hist.meta[k] for k in (
                    "store_bytes_hot", "store_bytes_ef")},
                "store": store,
                "spans": {n: {"tiered": tel["spans"].get(n),
                              "dense": d_tel["spans"].get(n)}
                          for n in TIER_SPANS}}
            if name.startswith("feddct_async"):
                # rounds 2.. of semi-async FedDCT, split by span
                split_t = round_split(read_spans(path))
                split_d = round_split(read_spans(d_path))
                row["warm_s_per_round"] = {
                    "tiered": split_t["warm_s_per_round"],
                    "dense": split_d["warm_s_per_round"]}
                row["covered"] = split_t["covered"]
                row["warm_split"] = {n: {"tiered": split_t["spans"].get(n),
                                         "dense": split_d["spans"].get(n)}
                                     for n in TIER_SPANS}
            out["runs"][name] = row
    built.clear()
    fd = out["runs"]["feddct_async"]["counters"]
    fb = out["runs"]["fedbuff"]["counters"]
    # semi-async FedDCT's lookahead stages every window row before the
    # window needs it (the tier deadline is known when the window
    # opens), so its demand promotions are FedBuff's to show
    if not (fd.get("residency.write_behind", 0) > 0
            and fd.get("residency.write_around", 0) > 0
            and fb.get("residency.demand_promote", 0) > 0):
        fail(f"residency counters at {TIER_N} clients: feddct_async {fd}, "
             f"fedbuff {fb}")
    return out


def oversubscribed_gather():
    """``fedbuff --window 4 --hot-rows 2`` traced: windows wider than the
    hot tier gather from both tiers, and the history equals dense."""
    argv = _buff(ASYNC_ARGV, 4)
    d_hist, _, d_counts, d_model = _drive(argv)
    path = TRACE_DIR / "tiered_oversubscribed.jsonl"
    hist, _, launched, model = _drive(argv + ["--hot-rows", "2", "--trace",
                                              str(path)])
    c = hist.meta["telemetry"]["counters"]
    if c.get("residency.oversubscribed_gather", 0) < 1:
        fail(f"fedbuff at 2 hot rows gathered no wide window: {c}")
    if not _same_history(hist, d_hist) or not _models_equal(
            model, d_model) or launched != d_counts:
        fail("fedbuff at 2 hot rows differs from dense")
    return {"counters": {k: v for k, v in c.items()
                         if k.startswith("residency.")},
            "host_gather": hist.meta["telemetry"]["spans"].get(
                "residency.host_gather")}


def pinned_row_ms(p: int, rows: int = 16):
    """Host milliseconds to allocate one pinned (p,) f32 row: fresh (run
    before the tiered runs pin any block of this size; all kept, so
    none is a reuse), then again after freeing them (the caching host
    allocator's reuse); and to copy a row from the card into pinned
    memory.  Medians over ``rows``."""
    import torch

    def alloc(keep):
        out = []
        for _ in range(rows):
            t0 = time.perf_counter()
            keep.append(torch.empty(p, pin_memory=True))
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    keep = []
    fresh = alloc(keep)
    src = torch.ones(p, device="cuda")
    copy = []
    for row in keep:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        copy.append((time.perf_counter() - t0) * 1e3)
    keep.clear()
    reused = alloc(keep)
    return {"row_bytes": 4 * p, "fresh_alloc_ms": statistics.median(fresh),
            "reused_alloc_ms": statistics.median(reused),
            "d2h_ms": statistics.median(copy)}


def tiered_async_path():
    pinned = pinned_row_ms(MAIN_P)
    t0 = time.perf_counter()
    parity = tiered_parity()
    t1 = time.perf_counter()
    card = card_interleavings()
    t2 = time.perf_counter()
    wide = oversubscribed_gather()
    t3 = time.perf_counter()
    at_size = tiered_at_size()
    t4 = time.perf_counter()
    return {"parity": parity, "card_interleavings": card,
            "oversubscribed": wide, "at_size": at_size,
            "pinned_row": pinned,
            "tiered_path_launches":
                at_size["runs"]["feddct_async"]["launches"]["fedagg_fold"],
            "seconds": {"parity": t1 - t0, "interleavings": t2 - t1,
                        "oversubscribed": t3 - t2, "at_size": t4 - t3}}


# ---------------------------------------------------------------------
# fedagg_partial (K3) and the client-mesh path
# ---------------------------------------------------------------------

def check_partial(name, u, coef, *, exact_zero=False):
    """Partial-sum kernel vs its plain version on the same card
    tensors."""
    import torch
    from repro_torch.kernels import fedagg as fedagg_mod
    got = fedagg_mod.fedagg_partial(u, coef)
    torch.cuda.synchronize()
    want = fedagg_mod.fedagg_partial_plain(u, coef)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"fedagg_partial[{name}]: shape/dtype {got.shape} {got.dtype}")
    if not bool(torch.isfinite(got).all()):
        fail(f"fedagg_partial[{name}]: non-finite output")
    if exact_zero and bool((got != 0).any()):
        fail(f"fedagg_partial[{name}]: expected exact zeros")
    abs_err = float((got - want).abs().max())
    rel_err = float(((got - want).abs()
                     / want.abs().clamp(min=1e-12)).max())
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"fedagg_partial[{name}]: disagrees with "
             f"fedagg_partial_plain, max abs err {abs_err}")
    r, p = u.shape
    return {"case": name, "r": int(r), "p": int(p),
            "vec": fedagg_mod._vector_width(p, u, got),
            "max_abs_err": abs_err, "max_rel_err": rel_err}


def partial_cases():
    import torch
    from repro_torch.kernels.fedagg import fedagg_partial
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def coefs(r):
        return 0.05 + torch.rand(r, generator=gen, device="cuda")

    cases = [check_partial(f"r={r}", randn(r, MAIN_P), coefs(r))
             for r in (1, 2, PARTIAL_R)]
    cases.append(check_partial("odd-p-under-a-block", randn(7, 331),
                               coefs(7)))
    cases.append(check_partial("p-multiple-of-4", randn(5, 4096), coefs(5)))
    # zero-coefficient rows holding inf/nan contribute nothing
    ub, cb = randn(8, 10_001), coefs(8)
    ub[2] = float("inf")
    ub[5] = float("nan")
    cb[2] = 0.0
    cb[5] = -1.0
    cases.append(check_partial("masked-inf-nan", ub, cb))
    c_nan = coefs(8)
    c_nan[4] = float("nan")
    ub_nan = randn(8, 10_001)
    ub_nan[4] = float("inf")
    cases.append(check_partial("nan-coefficient", ub_nan, c_nan))
    cases.append(check_partial("all-zero-coefficients", ub,
                               torch.zeros(8, device="cuda"),
                               exact_zero=True))
    # 5 live rows padded to 8 with zero coefficients (the plan's zero
    # rows) is bitwise the unpadded call
    u8, c5 = randn(8, MAIN_P), coefs(5)
    u8[5:] = 0.0
    base = fedagg_partial(u8[:5].contiguous(), c5)
    padded = fedagg_partial(u8, torch.cat([c5, torch.zeros(3,
                                                           device="cuda")]))
    torch.cuda.synchronize()
    if not torch.equal(base, padded):
        fail("fedagg_partial: zero-coefficient padding rows changed the "
             "result's bits")
    cases.append({"case": "5-live-padded-to-8-bitwise", "r": 8,
                  "p": MAIN_P, "max_abs_err": 0.0, "max_rel_err": 0.0})
    return cases


def fedagg_partial_times(r: int, p: int, coef):
    """Partial-sum kernel, its plain version and the one-call library
    yardstick ``torch.mv(u.t(), c)`` (the same sum without the masking)
    at one shard shape, in turns on the same inputs rotated past the
    L2.  The path's coefficients (sample counts in a sync round) are
    scaled to sum 1: the time depends only on which rows are live, and
    the stated tolerance is for sums of order one."""
    import itertools

    import numpy as np
    import torch
    from repro_torch.kernels.fedagg import (fedagg_partial,
                                            fedagg_partial_plain)
    gen = torch.Generator(device="cuda").manual_seed(6)
    u = torch.randn(r, p, generator=gen, device="cuda")
    coef = np.asarray(coef, np.float32)
    if (coef > 0).any():
        coef = np.where(coef > 0, coef / coef[coef > 0].sum(), coef) \
            .astype(np.float32)
    c = torch.as_tensor(coef, dtype=torch.float32, device="cuda")
    err = check_partial(f"timed-{r}x{p}", u, c)
    copies = max(1, -(-int(3 * L2_BYTES) // (4 * r * p)))
    ring = itertools.cycle([u] + [u.clone() for _ in range(copies - 1)])

    def kernel():
        return fedagg_partial(next(ring), c)

    def plain():
        return fedagg_partial_plain(next(ring), c)

    def library():
        # yardstick only: the port never computes the sum this way
        return torch.mv(next(ring).t(), c)

    plain_a = median_ms(plain)
    kernel_a = median_ms(kernel)
    lib = median_ms(library)
    kernel_b = median_ms(kernel)
    plain_b = median_ms(plain)
    call = median_ms(kernel, hide_host=False)
    bound, bound_by = partial_bound_ms(coef, p)
    return {"r": r, "p": p, "r_live": int((torch_f32(coef) > 0).sum()),
            "buffers": copies, "ms": min(kernel_a, kernel_b),
            "call_ms_with_host": call, "plain_ms": min(plain_a, plain_b),
            "library_ms": lib, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err["max_abs_err"]}


@contextlib.contextmanager
def forced_shards(n: int):
    """``n`` virtual client shards of the card for the block: the forced
    count ``make_client_mesh`` reads (``REPRO_TORCH_FLAGS``)."""
    from repro_torch.distributed import hostdevices
    before = os.environ.get(hostdevices.ENV_VAR)
    if hostdevices.forced_host_device_count() is not None:
        fail(f"{hostdevices.ENV_VAR} already forces a shard count: "
             f"{before!r}")
    hostdevices.ensure_host_device_count(n)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(hostdevices.ENV_VAR, None)
        else:
            os.environ[hostdevices.ENV_VAR] = before


@contextlib.contextmanager
def recording_evaluations(models):
    """Every model the trainers evaluate, as copies, into ``models``:
    the last one of a run is its final model."""
    from repro_torch.fl import client as fl_client
    from repro_torch.tree import tree_leaves
    cls = fl_client.CNNTrainer

    def recording(self, params, *a, **kw):
        models.append([l.detach().clone() for l in tree_leaves(params)])
        return real(self, params, *a, **kw)

    with patched(cls, "evaluate", recording) as real:
        yield


def _models_equal(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _models_max_abs(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


HISTORY_KEYS = ("rounds", "times", "accuracy", "tier", "n_selected",
                "n_stragglers")


def _first_difference(h1, h2):
    """The round of the first record where two histories differ, or
    None."""
    a, b = h1.to_json(), h2.to_json()
    for i in range(max(len(a["rounds"]), len(b["rounds"]))):
        if any(a[k][i:i + 1] != b[k][i:i + 1] for k in HISTORY_KEYS):
            return (a["rounds"] if i < len(a["rounds"]) else b["rounds"])[i]
    return None


def mesh_path(main_hist):
    """The client-mesh path through the CLI: FedDCT over four virtual
    shards of the card (K3 once per shard in every round with
    survivors), the same run again, a 1-shard mesh against the sync
    path's history, the first round against the plain engine, and a
    timed run on the warmed process."""
    import torch
    from repro_torch.config.base import FLConfig
    from repro_torch.core import run_method
    from repro_torch.core.engine import make_engine
    from repro_torch.distributed import aggregate as aggregate_mod
    from repro_torch.distributed import engine as dist_engine
    from repro_torch.distributed import make_client_mesh
    from repro_torch.fl.client import build_fl_clients
    from repro_torch.fl.network import WirelessNetwork
    from repro_torch.launch import fl_train
    from repro_torch.tree import tree_leaves

    argv = MAIN_ARGV + ["--mesh-clients", str(MESH_SHARDS)]
    calls, first_round = [], []

    def recording_partial(updates, coef):
        calls.append((int(updates.shape[0]), int(updates.shape[1]),
                      updates.device.type, [float(x) for x in coef]))
        return real_partial(updates, coef)

    def recording_round(self, params, client_ids, rnd_seed, weights=None):
        out = real_round(self, params, client_ids, rnd_seed, weights)
        if not first_round and client_ids:
            first_round.append((self, params, list(client_ids), rnd_seed,
                                out))
        return out

    models = []
    with forced_shards(MESH_SHARDS), \
            patched(aggregate_mod, "fedagg_partial_op",
                    recording_partial) as real_partial, \
            patched(dist_engine.ShardedClientEngine, "train_round",
                    recording_round) as real_round, \
            recording_evaluations(models):
        zero_counts()
        t0 = time.perf_counter()
        hist = fl_train.main(argv)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        path_counts = counts()
        final = models[-1]
        seen = list(calls)
        again = fl_train.main(argv)
        final_again = models[-1]
        one = fl_train.main(MAIN_ARGV + ["--mesh-clients", "1"])

        live_rounds = sum(1 for s, g in zip(hist.n_selected,
                                            hist.n_stragglers) if s - g > 0)
        if len(hist.rounds) != 5 or hist.meta.get("mesh_devices") != \
                MESH_SHARDS:
            fail(f"mesh path: rounds {hist.rounds}, mesh_devices "
                 f"{hist.meta.get('mesh_devices')}")
        if path_counts["fedagg_partial"] != MESH_SHARDS * live_rounds \
                or live_rounds < 1:
            fail(f"fedagg_partial launched {path_counts['fedagg_partial']} "
                 f"times on the mesh path; {live_rounds} rounds had "
                 f"survivors over {MESH_SHARDS} shards")
        if path_counts["fedagg"] or path_counts["fedagg_fold"]:
            fail(f"the mesh path launched other kernels: {path_counts}")
        if len(seen) != path_counts["fedagg_partial"] or any(
                p != MAIN_P or dev != "cuda" for _, p, dev, _ in seen):
            fail(f"mesh path gave fedagg_partial unexpected buffers: "
                 f"{[c[:3] for c in seen]}")
        if not all(0.0 <= a <= 1.0 for a in hist.accuracy):
            fail(f"mesh path accuracies: {hist.accuracy}")
        if again.to_json() != hist.to_json() or not _models_equal(
                final_again, final):
            fail("two seeded mesh runs differ")
        if one.to_json() != main_hist.to_json():
            fail("a 1-shard mesh run differs from the sync path's")

        # the first round: sharded against the plain engine, same inputs
        eng, params, ids, seed, got = first_round[0]
        want = make_engine(eng.trainer).train_round(params, ids, seed)
        torch.cuda.synchronize()
        round_err = _models_max_abs(tree_leaves(got), tree_leaves(want))
        if round_err > MESH_ROUND_ATOL:
            fail(f"the first sharded round is {round_err} from the plain "
                 f"engine's (atol {MESH_ROUND_ATOL})")

    # timed run on the warmed process, through the same entry points,
    # with no recording wrapper in the way (four shards of the card
    # named explicitly, as the forced count gives them)
    fl = FLConfig(n_clients=50, n_tiers=5, tau=5, rounds=5, seed=0,
                  lr=1e-3)
    net = WirelessNetwork(fl.n_clients, fl.tier_delay_means,
                          fl.delay_std, fl.mu, fl.failure_delay,
                          fl.seed)
    trainer = build_fl_clients("cnn-mnist", fl)
    mesh = make_client_mesh(devices=["cuda"] * MESH_SHARDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = run_method("feddct", trainer, net, fl, mesh=mesh)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if timed.to_json() != hist.to_json():
        fail("the timed mesh run's history differs from the CLI run's")
    return {"argv": argv, "shards": MESH_SHARDS, "rounds": hist.rounds,
            "accuracy": hist.accuracy, "times": hist.times,
            "n_selected": hist.n_selected,
            "n_stragglers": hist.n_stragglers, "launches": path_counts,
            "rounds_with_survivors": live_rounds,
            "partial_shapes": [[r, p] for r, p, _, _ in seen],
            "partial_live_rows": [sum(1 for x in c if x > 0)
                                  for _, _, _, c in seen],
            "two_runs_identical": True, "one_shard_equals_main_path": True,
            "first_round_vs_plain_engine_max_abs": round_err,
            "first_round_atol": MESH_ROUND_ATOL,
            "differs_from_sync_path_at_round": _first_difference(
                hist, main_hist),
            "sync_path_accuracy": main_hist.accuracy,
            "first_run_s": first_s, "warm_run_s": run_s,
            "warm_s_per_round": run_s / fl.rounds}, path_counts, seen


def mesh_async_path():
    """Semi-async FedDCT over four virtual shards: on the store path the
    cohort trains sharded and the window merges through K2; with
    ``--no-store`` the merge is the sharded reduction through K3.  The
    two agree within tolerance (their sums are reassociated)."""
    import torch
    from repro_torch.launch import fl_train
    from repro_torch.runtime import async_loop

    argv = ASYNC_ARGV + ["--mesh-clients", str(MESH_SHARDS)]
    windows, models = [], []

    def recording_store(eng, store, params, batch, fl, version):
        windows.append(len(batch))
        return real_store(eng, store, params, batch, fl, version)

    def recording_dict(eng, params, snapshots, batch, fl, version):
        windows.append(len(batch))
        return real_dict(eng, params, snapshots, batch, fl, version)

    def drive(extra):
        windows.clear()
        zero_counts()
        hist = fl_train.main(argv + extra)
        torch.cuda.synchronize()
        return hist, counts(), list(windows), models[-1]

    with forced_shards(MESH_SHARDS), \
            patched(async_loop, "_merge_window_store",
                    recording_store) as real_store, \
            patched(async_loop, "_merge_window",
                    recording_dict) as real_dict, \
            recording_evaluations(models):
        store, store_counts, store_wins, store_final = drive([])
        on_dict, dict_counts, dict_wins, dict_final = drive(["--no-store"])
    multi = sum(1 for w in store_wins if w >= 2)
    if store.meta.get("store_path") != "store" or store.meta.get(
            "mesh_devices") != MESH_SHARDS or multi < 1:
        fail(f"mesh async store run: meta {store.meta}, windows "
             f"{store_wins}")
    if store_counts != only(fedagg_fold=multi):
        fail(f"mesh async store run launched {store_counts} for windows "
             f"{store_wins}")
    if on_dict.meta.get("store_path") != "dict" or dict_wins != store_wins:
        fail(f"mesh async dict run: {on_dict.meta.get('store_path')}, "
             f"windows {dict_wins} vs {store_wins}")
    if dict_counts != only(fedagg_partial=MESH_SHARDS * multi):
        fail(f"mesh async dict run launched {dict_counts} for windows "
             f"{dict_wins}")
    merge_err = _models_max_abs(store_final, dict_final)
    if merge_err > MESH_MERGE_ATOL:
        fail(f"mesh async store and dict final models differ by "
             f"{merge_err} (atol {MESH_MERGE_ATOL})")
    a, b = store.to_json(), on_dict.to_json()
    for k in HISTORY_KEYS:
        if k != "accuracy" and a[k] != b[k]:
            fail(f"mesh async store and dict runs differ in {k}")
    acc_err = max(abs(x - y) for x, y in zip(store.accuracy,
                                             on_dict.accuracy))
    if acc_err > MESH_ACC_ATOL:
        fail(f"mesh async accuracies differ by {acc_err}")
    return {"argv": argv, "windows": store_wins,
            "store_launches": store_counts, "dict_launches": dict_counts,
            "accuracy_store": store.accuracy,
            "accuracy_dict": on_dict.accuracy,
            "final_model_max_abs": merge_err,
            "final_model_atol": MESH_MERGE_ATOL,
            "accuracy_max_abs": acc_err, "accuracy_atol": MESH_ACC_ATOL}


# ---------------------------------------------------------------------
# flash_attention (K4) and ssm_scan (K5)
# ---------------------------------------------------------------------

# (rtol, atol), kernel against plain twin on the same card tensors.  f32:
# the JAX kernel tests' (tests/test_kernels.py: 2e-5 for attention, 1e-4
# for the scan), sums in another order.  bf16: both sides compute in f32
# from the same bf16 inputs and round the output once, at most 2^-7 of
# the value: rtol 8e-3 (attention) and 1e-2 (scan); atol 1e-3 for
# outputs near zero.  The attention kernel's tensor-core operands are
# bf16, but it takes the unnormalised P into P.V as two bf16 parts, P to
# about 2^-16 as the reference's f32 P, and exp through exp2: a CPU
# emulation of its arithmetic stays within these bounds
# (tests/test_torch_attention.py), and P rounded to bf16 once would not.
# A kernel off by a few percent fails.
FA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (8e-3, 1e-3)}
SS_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}


def _tol(table, dtype):
    return table[str(dtype).removeprefix("torch.")]


def _close(got, want, tol):
    import torch
    rtol, atol = tol
    return torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)


def check_flash(name, q, k, v, *, causal=True, window=0, q_offset=0):
    """Attention kernel vs its plain twin on the same card tensors; the
    kernel twice, bit for bit."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    again = fa.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"flash_attention[{name}]: two runs differ")
    want = fa.gqa_plain(q, k, v, causal=causal, window=window,
                        q_offset=q_offset)
    tol = _tol(FA_TOL, q.dtype)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"flash_attention[{name}]: shape/dtype {got.shape} {got.dtype}")
    if not bool(torch.isfinite(got).all()):
        fail(f"flash_attention[{name}]: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    if not _close(got, want, tol):
        fail(f"flash_attention[{name}]: disagrees with its plain twin, "
             f"max abs err {err} (rtol, atol {tol})")
    b, s, h, d = q.shape
    return {"case": name, "b": b, "s": s, "t": int(k.shape[1]), "h": h,
            "hkv": int(k.shape[2]), "d": d, "dtype": str(q.dtype),
            "causal": causal, "window": window, "q_offset": q_offset,
            "max_abs_err": err, "tol": tol}


def check_flash_raises(name, q, k, v, **kw):
    """A call the kernel must refuse with ValueError (and not launch)."""
    from repro_torch.kernels import flash_attention as fa
    before = fa.launches
    try:
        fa.flash_attention(q, k, v, **kw)
    except ValueError as e:
        if fa.launches != before:
            fail(f"flash_attention[{name}]: launched before raising")
        return {"case": name, "raised": "ValueError", "message": str(e)}
    fail(f"flash_attention[{name}]: expected ValueError, got a result")


def check_mean_of_v(name, q, k, v, **kw):
    """Every row sees no key: each output row is the mean of v over all
    T keys (its kv head's)."""
    from repro_torch.kernels import flash_attention as fa
    got = fa.flash_attention(q, k, v, **kw)
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    mean_v = v.float().mean(dim=1, keepdim=True) \
        .repeat_interleave(rep, dim=2).expand(b, s, h, d)
    tol = _tol(FA_TOL, q.dtype)
    err = float((got.float() - mean_v).abs().max())
    if not _close(got, mean_v, tol):
        fail(f"flash_attention[{name}]: rows with no visible key are "
             f"{err} from the mean of v")
    return {"case": name, "dtype": str(q.dtype), "max_abs_err": err,
            "tol": tol}


def flash_cases():
    """K4 against its plain twin: the JAX kernel tests' shapes (causal
    and not, q_offset = t - s), windows, GQA groups of 4 (llama) and 5
    (hymba), f32 (the split-TF32 kernel) and bf16 (the wgmma kernel),
    tails of S and T, q_offset > 0, windows that are not a multiple of
    the 128-key tile, rows that see no key (the mean of v over all T
    keys) alone and beside rows that see keys, strided views; the f32
    kernel's 64 x 64 tiling at its edges (S and T off the tile at D 16
    and 32, one q row, T under one tile, a GQA-5 band over 16 key
    tiles); and misaligned views that each kernel refuses."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(10)

    def qkv(b, s, t, h, hkv, d, dtype=torch.float32):
        def r(*shape):
            return torch.randn(*shape, generator=gen,
                               device="cuda").to(dtype)
        return r(b, s, h, d), r(b, t, hkv, d), r(b, t, hkv, d)

    cases = []
    for s, t, d in ((128, 128, 64), (256, 256, 32), (64, 256, 64),
                    (256, 128, 16)):
        for causal in (True, False):
            if causal and s > t:
                continue
            cases.append(check_flash(
                f"kernel-test-{s}x{t}x{d}-{'causal' if causal else 'full'}",
                *qkv(3, s, t, 1, 1, d), causal=causal,
                q_offset=t - s if causal else 0))
    for window in (32, 100):
        cases.append(check_flash(f"window-{window}",
                                 *qkv(2, 256, 256, 1, 1, 32),
                                 window=window))
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).removeprefix("torch.")
        # hymba: 25 q heads over 5 kv heads, window 1024 < T
        cases.append(check_flash(f"hymba-gqa5-window1024-{tag}",
                                 *qkv(1, 2048, 2048, 25, 5, 64, dtype),
                                 window=1024))
        # llama: 32 over 8, causal
        cases.append(check_flash(f"llama-gqa4-causal-{tag}",
                                 *qkv(1, 1024, 1024, 32, 8, 64, dtype)))
        cases.append(check_flash(f"tail-200-{tag}",
                                 *qkv(2, 200, 200, 4, 2, 64, dtype)))
    cases.append(check_flash("tail-200-window-100-d32",
                             *qkv(1, 200, 200, 2, 1, 32), window=100))
    bf16 = torch.bfloat16
    for dtype in (torch.float32, bf16):
        tag = str(dtype).removeprefix("torch.")
        # no row sees a key: each is the mean of v over all T keys
        q, k, v = qkv(1, 64, 128, 2, 1, 64, dtype)
        cases.append(check_flash(f"no-visible-key-{tag}", q, k, v,
                                 causal=False, window=32, q_offset=200))
        cases.append(check_mean_of_v(f"no-visible-key-is-mean-of-v-{tag}",
                                     q, k, v, causal=False, window=32,
                                     q_offset=200))
        # one block holding rows that see keys and rows that see none
        # (rows 140..158 see keys, 159..203 none)
        cases.append(check_flash(f"some-rows-see-no-key-{tag}",
                                 *qkv(1, 64, 128, 2, 1, 64, dtype),
                                 causal=False, window=32, q_offset=140))
        # strided inputs: q, k, v as views of one fused (B,S,H+2Hkv,D)
        # tensor
        qkv_fused = torch.randn(2, 300, 8 + 2 * 2, 64, generator=gen,
                                device="cuda").to(dtype)
        cases.append(check_flash(f"strided-views-{tag}",
                                 qkv_fused[:, :, :8], qkv_fused[:, :, 8:10],
                                 qkv_fused[:, :, 10:], window=64))
    # the f32 kernel's tiling (64 q rows by 64 keys) at its edges, on
    # its own generator so the cases above keep their inputs
    edge = torch.Generator(device="cuda").manual_seed(27)

    def qkv_edge(b, s, t, h, hkv, d):
        return tuple(torch.randn(*shape, generator=edge, device="cuda")
                     for shape in ((b, s, h, d), (b, t, hkv, d),
                                   (b, t, hkv, d)))
    for name, shape, kw in F32_EDGE_CASES:
        cases.append(check_flash(name, *qkv_edge(*shape), **kw))
    # head dims 128 and 192 in both kernels, on their own generator
    wide = torch.Generator(device="cuda").manual_seed(29)
    for name, (b, s, t, h, hkv, d), kw in WIDE_HEAD_CASES:
        for dtype in (torch.float32, bf16):
            tag = str(dtype).removeprefix("torch.")
            q, k, v = (torch.randn(*x, generator=wide, device="cuda")
                       .to(dtype) for x in ((b, s, h, d), (b, t, hkv, d),
                                            (b, t, hkv, d)))
            cases.append(check_flash(f"{name}-{tag}", q, k, v, **kw))
    # the wide tilings' edges (the f32 kernel's 48-key tiles at D = 192,
    # windows inside a tile) and the head layouts of the wide configs
    # (groups of 3 and 7, MQA, odd H, blind rows beside rows that see
    # keys), both dtypes, on their own generator
    wide_edge = torch.Generator(device="cuda").manual_seed(31)
    for name, (b, s, t, h, hkv, d), kw in (WIDE_BWD_EDGE_CASES
                                           + FWD_HEAD_EDGE_CASES):
        for dtype in (torch.float32, bf16):
            tag = str(dtype).removeprefix("torch.")
            q, k, v = (torch.randn(*x, generator=wide_edge, device="cuda")
                       .to(dtype) for x in ((b, s, h, d), (b, t, hkv, d),
                                            (b, t, hkv, d)))
            cases.append(check_flash(f"{name}-{tag}", q, k, v, **kw))
    # each forward twice at nemotron's layer, bit for bit (check_flash)
    _, qs, ks = BWD_REPEAT_SHAPE
    for dtype in (torch.float32, bf16):
        q = torch.randn(qs, generator=wide_edge, device="cuda").to(dtype)
        k, v = (torch.randn(ks, generator=wide_edge, device="cuda")
                .to(dtype) for _ in range(2))
        cases.append(check_flash(
            f"nemotron-layer-twice-{str(dtype).removeprefix('torch.')}",
            q, k, v))
    # the tensor-core kernel's own edges, bf16
    for s, t, d in ((128, 128, 64), (256, 256, 32), (64, 256, 64),
                    (256, 128, 16)):
        for causal in (True, False):
            if causal and s > t:
                continue
            cases.append(check_flash(
                f"kernel-test-{s}x{t}x{d}-{'causal' if causal else 'full'}"
                f"-bfloat16", *qkv(3, s, t, 1, 1, d, bf16), causal=causal,
                q_offset=t - s if causal else 0))
    cases.append(check_flash("tail-1000-bfloat16",
                             *qkv(1, 1000, 1000, 5, 1, 64, bf16)))
    cases.append(check_flash("tail-200x1000-full-bfloat16",
                             *qkv(2, 200, 1000, 4, 2, 32, bf16),
                             causal=False))
    cases.append(check_flash("q-offset-64-causal-bfloat16",
                             *qkv(2, 200, 264, 4, 1, 64, bf16), q_offset=64))
    cases.append(check_flash("window-100-bfloat16",
                             *qkv(1, 1000, 1000, 5, 1, 64, bf16),
                             window=100))
    cases.append(check_flash("window-1000-bfloat16",
                             *qkv(1, 2000, 2000, 5, 1, 64, bf16),
                             window=1000))
    cases.append(check_flash("tail-200-window-100-d16-bfloat16",
                             *qkv(1, 200, 200, 2, 1, 16, bf16), window=100))
    # a 128-row block whose first warpgroup sees keys and whose second
    # sees none (rows 0..58 see keys): the block walks all T keys
    cases.append(check_flash("half-block-sees-no-key-bfloat16",
                             *qkv(1, 128, 128, 2, 1, 64, bf16),
                             causal=False, window=32, q_offset=100))
    # the K/V ring when a warpgroup skips more tiles in a row than the
    # ring has stages: S = 1050 leaves the last block's second
    # warpgroup without rows (it releases all 9 tiles), and a block
    # whose second warpgroup is blind walks all 8 tiles of T = 1000
    # while its first sees only the last
    cases.append(check_flash("empty-second-warpgroup-s1050-bfloat16",
                             *qkv(1, 1050, 1050, 5, 1, 64, bf16)))
    cases.append(check_flash("warpgroup-skips-7-tiles-bfloat16",
                             *qkv(1, 128, 1000, 2, 1, 64, bf16),
                             causal=False, window=64, q_offset=980))
    # TMA's rule: a view 2 bytes off a 16-byte address is refused
    wide = torch.randn(1, 256, 2, 80, generator=gen, device="cuda").to(bf16)
    cases.append(check_flash_raises(
        "misaligned-view-bfloat16", wide[..., 1:65],
        wide[:, :, :1, 8:72], wide[:, :, :1, 8:72]))
    # cp.async's rule (f32 k and v): k a view 4 bytes off a 16-byte
    # address; k on a 16-byte address with strides of 130 and 65 floats
    wide32 = torch.randn(1, 256, 2, 65, generator=gen, device="cuda")
    q32 = torch.randn(1, 256, 2, 64, generator=gen, device="cuda")
    cases.append(check_flash_raises(
        "misaligned-view-float32", q32, wide32[:, :, :1, 1:],
        wide32[:, :, :1, 1:]))
    cases.append(check_flash_raises(
        "k-strides-off-16-bytes-float32", q32, wide32[:, :, :1, :64],
        wide32[:, :, :1, :64]))
    return cases


# The f32 kernel's tiling at its edges: (name, (b, s, t, h, hkv, d),
# masks).  Blocks of 64 q rows, key tiles of 64; S and T off the tile at
# D = 16 and 32 with a window and q_offset, one q row (a block of 63
# padding rows) at the end of a causal sequence, T under one tile, a
# GQA-5 band over 16 key tiles, and a block whose rows see keys of two
# tiles each, the first of them masked for some rows.
F32_EDGE_CASES = (
    ("f32-ragged-91x157-d16-window40-offset66", (2, 91, 157, 6, 2, 16),
     dict(window=40, q_offset=66)),
    ("f32-ragged-130x99-d32-full-window50-offset20",
     (1, 130, 99, 4, 1, 32), dict(causal=False, window=50, q_offset=20)),
    ("f32-one-row-1x300-causal-offset299", (2, 1, 300, 5, 1, 64),
     dict(q_offset=299)),
    ("f32-t10-under-one-tile-full", (1, 70, 10, 2, 2, 64),
     dict(causal=False)),
    ("f32-gqa5-1x1000-window300-16-key-tiles", (1, 1000, 1000, 5, 1, 64),
     dict(window=300)),
    ("f32-window-70-band-across-tiles", (1, 192, 192, 2, 1, 32),
     dict(window=70)),
)


# Head dims 128 (mixtral, arctic, phi4-mini, granite, chameleon) and 192
# (nemotron), both dtypes and the backward: (name, (b, s, t, h, hkv, d),
# masks).  Causal with GQA and S off the tile; a window over ragged S
# with a group of 5; q_offset; no mask at T over S; rows that see no key
# beside rows that do; and a band over many key tiles at the models'
# group sizes (mixtral 4, nemotron 12).  D = 80 (hubert): its own layer
# (non-causal MHA, 16 heads), S and T off every tile grid (64 rows and
# keys of the f32 kernels, 128 of the bf16 one) without a mask, a GQA
# window over ragged S, and rows that see no key beside rows that do.
WIDE_HEAD_CASES = tuple(
    case for d in (128, 192) for case in (
        (f"d{d}-gqa4-causal-300", (1, 300, 300, 8, 2, d), {}),
        (f"d{d}-gqa5-window100-ragged-333", (2, 333, 333, 5, 1, d),
         dict(window=100)),
        (f"d{d}-q-offset-64-200x264", (2, 200, 264, 4, 1, d),
         dict(q_offset=64)),
        (f"d{d}-full-130x517-gqa2", (1, 130, 517, 4, 2, d),
         dict(causal=False)),
        (f"d{d}-some-rows-see-no-key", (1, 64, 128, 4, 2, d),
         dict(causal=False, window=32, q_offset=140)),
        (f"d{d}-layer-1x1024-window300-gqa{4 if d == 128 else 12}",
         (1, 1024, 1024, 32, 8, d) if d == 128 else (1, 1024, 1024, 24, 2, d),
         dict(window=300)))) + (
    ("d80-hubert-layer-2x1024-mha-full", (2, 1024, 1024, 16, 16, 80),
     dict(causal=False)),
    ("d80-full-off-every-grid-77x203-gqa2", (1, 77, 203, 4, 2, 80),
     dict(causal=False)),
    ("d80-gqa4-window100-ragged-333", (2, 333, 333, 8, 2, 80),
     dict(window=100)),
    ("d80-some-rows-see-no-key", (1, 64, 128, 4, 2, 80),
     dict(causal=False, window=32, q_offset=140)),
)


# The backward's wide-head tiling at its edges (moving tiles of 48 q rows
# in dkdv at D = 128; of 32 q rows or keys in both kernels at D = 192):
# S and T off the 32- and 48-row grids at both head dims (and off D =
# 80's 64-row grid with GQA and q_offset), and window edges inside a
# tile (a window of 20, and of 45 over ragged S).
WIDE_BWD_EDGE_CASES = (
    ("d128-off-grid-95x139-gqa4-offset44", (1, 95, 139, 8, 2, 128),
     dict(q_offset=44)),
    ("d192-off-grid-71x105-gqa12-offset34", (1, 71, 105, 12, 1, 192),
     dict(q_offset=34)),
    ("d192-window20-inside-a-tile-160", (1, 160, 160, 4, 2, 192),
     dict(window=20)),
    ("d128-window45-ragged-117x181-full", (2, 117, 181, 6, 3, 128),
     dict(causal=False, window=45, q_offset=70)),
    ("d80-off-grid-95x139-gqa4-offset44", (1, 95, 139, 8, 2, 80),
     dict(q_offset=44)),
)

# Head layouts and edges of the forward kernels at head dims 128 and
# 192: GQA groups of 3 and 7 (phi4-mini's and arctic's; adjacent heads
# that read different kv heads), MQA, odd H, rows that see no key beside
# rows that do in one q tile, and a window edge inside a 32-key stretch
# over ragged S and T; at D = 80 MQA with odd H and a window, and a
# window edge inside a tile.
FWD_HEAD_EDGE_CASES = (
    ("d128-gqa3-200", (1, 200, 200, 6, 2, 128), {}),
    ("d128-gqa7-window64-150", (2, 150, 150, 14, 2, 128),
     dict(window=64)),
    ("d192-mqa-130", (1, 130, 130, 6, 1, 192), {}),
    ("d128-odd-h-3-no-group-100x140", (1, 100, 140, 3, 3, 128),
     dict(q_offset=40)),
    ("d192-odd-h-5-gqa5-window50", (1, 180, 180, 5, 1, 192),
     dict(window=50)),
    ("d128-blind-rows-beside-seeing-rows", (1, 192, 128, 4, 2, 128),
     dict(causal=False, window=32, q_offset=140)),
    ("d192-window13-inside-a-32-key-tile-90x97", (1, 90, 97, 4, 2, 192),
     dict(window=13, q_offset=7)),
    ("d80-odd-h-5-mqa-window50-180", (1, 180, 180, 5, 1, 80),
     dict(window=50)),
    ("d80-window13-inside-a-tile-90x97", (1, 90, 97, 4, 2, 80),
     dict(window=13, q_offset=7)),
)

# the layer whose pair of backward kernels is run twice for identical
# bits at full size: nemotron's (D = 192, GQA 12), as FA_BWD_SHAPES
BWD_REPEAT_SHAPE = ("nemotron-4-340b", (1, 2048, 96, 192), (1, 2048, 8, 192))


def check_ssm(name, x, dt, b_in, c_out, a_log, h0=None):
    """Scan kernel vs its plain twin on the same card tensors: y and
    h_end."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    y, h_end = ss.ssm_scan(x, dt, b_in, c_out, a_log, h0)
    torch.cuda.synchronize()
    y_want, h_want = ss.ssm_scan_plain(x, dt, b_in, c_out, a_log, h0)
    tol = _tol(SS_TOL, x.dtype)
    if y.shape != y_want.shape or y.dtype != y_want.dtype \
            or h_end.dtype != torch.float32:
        fail(f"ssm_scan[{name}]: shape/dtype {y.shape} {y.dtype} "
             f"{h_end.dtype}")
    if not (bool(torch.isfinite(y).all()) and
            bool(torch.isfinite(h_end).all())):
        fail(f"ssm_scan[{name}]: non-finite output")
    y_err = float((y.float() - y_want.float()).abs().max())
    h_err = float((h_end - h_want).abs().max())
    # the states are f32 on both sides: the f32 tolerance holds for
    # h_end whatever the input dtype
    h_tol = SS_TOL["float32"]
    if not _close(y, y_want, tol) or not _close(h_end, h_want, h_tol):
        fail(f"ssm_scan[{name}]: disagrees with its plain twin, max abs "
             f"err y {y_err} h_end {h_err} (rtol, atol {tol}, {h_tol})")
    bsz, s, d = x.shape
    return {"case": name, "b": bsz, "s": s, "d": d, "n": int(b_in.shape[2]),
            "dtype": str(x.dtype), "h0": h0 is not None,
            "max_abs_err": y_err, "h_end_max_abs_err": h_err, "tol": tol,
            "h_end_tol": h_tol}


def ssm_inputs(gen, b, s, d, n, dtype):
    """x, dt (softplus of a normal), b_in and c_out as the two halves of
    one (B,S,2N) tensor (strided views, as the model passes them), and
    a_log = log(1..N) per channel."""
    import torch
    import torch.nn.functional as F
    x = torch.randn(b, s, d, generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(b, s, d, generator=gen,
                                device="cuda")).to(dtype)
    bc = torch.randn(b, s, 2 * n, generator=gen, device="cuda").to(dtype)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device="cuda"))[None].repeat(d, 1)
    return x, dt, bc[..., :n], bc[..., n:], a_log


def ssm_cases():
    """K5 against its plain twin: the JAX kernel tests' shapes, f32 and
    bf16, with and without h0 (h_end checked), S=1, N in {8, 16}, D not
    a multiple of the block's channels, and the serving path's prefill
    shape; and the edges of the time split: S=17 (one short chunk,
    warps with empty segments), S=1000 (a whole chunk and a ragged one),
    S=8192 at hymba width (B=1, 16 chunks), and hymba width with N 4
    and 8."""
    import torch
    from repro_torch.kernels.ssm_scan import ssm_scan
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for b, s, d, n in ((2, 64, 32, 8), (1, 128, 64, 16), (3, 32, 16, 4)):
        cases.append(check_ssm(f"kernel-test-{b}x{s}x{d}x{n}",
                               *ssm_inputs(gen, b, s, d, n, torch.float32)))
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).removeprefix("torch.")
        for n in (8, 16):
            x, dt, bi, co, al = ssm_inputs(gen, 2, 100, 200, n, dtype)
            h0 = torch.randn(2, 200, n, generator=gen, device="cuda")
            cases.append(check_ssm(f"n{n}-d200-{tag}", x, dt, bi, co, al))
            cases.append(check_ssm(f"n{n}-d200-h0-{tag}", x, dt, bi, co, al,
                                   h0))
            cases.append(check_ssm(f"n{n}-s1-h0-{tag}", x[:, :1], dt[:, :1],
                                   bi[:, :1], co[:, :1], al, h0))
    # a prefill's h_end carried into the rest of the sequence equals the
    # whole sequence in one call
    x, dt, bi, co, al = ssm_inputs(gen, 2, 96, 100, 16, torch.float32)
    y_all, h_all = ssm_scan(x, dt, bi, co, al)
    y_a, h_a = ssm_scan(x[:, :37], dt[:, :37], bi[:, :37], co[:, :37], al)
    y_b, h_b = ssm_scan(x[:, 37:], dt[:, 37:], bi[:, 37:], co[:, 37:], al,
                        h_a)
    torch.cuda.synchronize()
    split_err = max(float((torch.cat([y_a, y_b], 1) - y_all).abs().max()),
                    float((h_b - h_all).abs().max()))
    if not (_close(torch.cat([y_a, y_b], 1), y_all, SS_TOL["float32"])
            and _close(h_b, h_all, SS_TOL["float32"])):
        fail(f"ssm_scan: split at 37 with h0 handoff is {split_err} from "
             "one call")
    cases.append({"case": "h0-handoff-split", "max_abs_err": split_err,
                  "tol": SS_TOL["float32"]})
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).removeprefix("torch.")
        cases.append(check_ssm(f"hymba-prefill-2x4096x3200x16-{tag}",
                               *ssm_inputs(gen, 2, 4096, 3200, 16, dtype)))
        cases.append(check_ssm(f"hymba-1x8192x3200x16-{tag}",
                               *ssm_inputs(gen, 1, 8192, 3200, 16, dtype)))
        for s in (17, 1000):
            x, dt, bi, co, al = ssm_inputs(gen, 2, s, 200, 16, dtype)
            h0 = torch.randn(2, 200, 16, generator=gen, device="cuda")
            cases.append(check_ssm(f"s{s}-d200-{tag}", x, dt, bi, co, al))
            cases.append(check_ssm(f"s{s}-d200-h0-{tag}", x, dt, bi, co, al,
                                   h0))
        for n in (4, 8):
            cases.append(check_ssm(f"n{n}-2x300x3200-{tag}",
                                   *ssm_inputs(gen, 2, 300, 3200, n, dtype)))
    return cases


# ---------------------------------------------------------------------
# The backward kernels of K4 and K5 (f32) against autograd of the plain
# twins
# ---------------------------------------------------------------------

# Gradients, f32, kernel vs autograd of the plain twin on the same card
# tensors: the same sums taken in another order (K4: up to ~10^4 (q, k)
# pairs a key over a kv head's group; K5: dB, dC over 3200 channels,
# dA_log over every step) and, for K5, exp through ex2.approx (2^-22
# relative) against expf.  Held elementwise at |got - want| <= atol +
# rtol * |want| with rtol 1e-4 and atol 1e-4 * max(1, max |want|): an
# error of a few percent, or a missed term, fails.
BWD_RTOL, BWD_ATOL = 1e-4, 1e-4


def _grad_close(name, got, want):
    """(max abs err, ok) of one gradient under ``BWD_RTOL`` / ``BWD_ATOL``
    scaled by the largest |want|."""
    import torch
    if got.shape != want.shape:
        fail(f"{name}: gradient shape {tuple(got.shape)} vs "
             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite gradient")
    scale = max(1.0, float(want.abs().max()))
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), rtol=BWD_RTOL,
                        atol=BWD_ATOL * scale)
    return err, scale, ok


def check_flash_bwd(name, q, k, v, do, *, causal=True, window=0,
                    q_offset=0):
    """K4's forward (asked for lse) and its two backward kernels against
    autograd of ``gqa_plain`` on the same f32 card tensors; and the
    kernels' gradients twice, bit for bit."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
    before = (fa.bwd_dq_launches, fa.bwd_dkdv_launches)
    out = fa.flash_attention(*ins, **kw)
    got = torch.autograd.grad(out, ins, do)
    again = torch.autograd.grad(fa.flash_attention(*ins, **kw), ins, do)
    torch.cuda.synchronize()
    if (fa.bwd_dq_launches - before[0], fa.bwd_dkdv_launches - before[1]) \
            != (2, 2):
        fail(f"flash_attention_bwd[{name}]: the backward kernels did not "
             "launch once a gradient each")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"flash_attention_bwd[{name}]: two runs differ")
    ref = [x.detach().requires_grad_(True) for x in (q, k, v)]
    want_out = fa.gqa_plain(*ref, **kw)
    want = torch.autograd.grad(want_out, ref, do)
    row = {"case": name, "q": list(q.shape), "k": list(k.shape),
           "causal": causal, "window": window, "q_offset": q_offset}
    out_err, _, out_ok = _grad_close(name, out.detach(), want_out.detach())
    row["out_max_abs_err"] = out_err
    for tag, a, b in zip(("dq", "dk", "dv"), got, want):
        err, scale, ok = _grad_close(f"flash_attention_bwd[{name}].{tag}",
                                     a, b)
        row[f"{tag}_max_abs_err"] = err
        row[f"{tag}_scale"] = scale
        if not ok:
            fail(f"flash_attention_bwd[{name}]: {tag} disagrees with "
                 f"autograd of the plain twin, max abs err {err} (rtol "
                 f"{BWD_RTOL}, atol {BWD_ATOL} x {scale})")
    if not out_ok:
        fail(f"flash_attention_bwd[{name}]: forward disagrees, {out_err}")
    return row


def check_flash_bwd_repeat():
    """The pair of backward kernels twice at ``BWD_REPEAT_SHAPE``
    (causal), through the wrapper's backward on the same inputs: dq, dk
    and dv the same bits (no atomics, a fixed order of the GQA sums)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    arch, qs, ks = BWD_REPEAT_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(31)
    q, do = (torch.randn(qs, generator=gen, device="cuda") for _ in "qd")
    k, v = (torch.randn(ks, generator=gen, device="cuda") for _ in "kv")
    o, lse, _ = fa._kernel_forward(q, k, v, True, 0, 0, with_lse=True)
    first = fa._kernel_backward(q, k, v, o, lse, do, True, 0, 0)
    again = fa._kernel_backward(q, k, v, o, lse, do, True, 0, 0)
    torch.cuda.synchronize()
    same = {tag: bool(torch.equal(a, b))
            for tag, a, b in zip(("dq", "dk", "dv"), first, again)}
    if not all(same.values()):
        fail(f"flash_attention_bwd repeat at {arch}'s layer: two runs "
             f"differ: {same}")
    if not all(bool(torch.isfinite(x).all()) for x in first):
        fail(f"flash_attention_bwd repeat at {arch}'s layer: non-finite")
    return {"arch": arch, "q": list(qs), "k": list(ks), "causal": True,
            "bitwise_equal": same}


def check_ssm_bwd(name, x, dt, b_in, c_out, a_log, h0=None, dh_end=True):
    """K5's forward and backward kernels against autograd of
    ``ssm_scan_plain`` on the same f32 card tensors (b_in, c_out the
    strided halves of one tensor, as the model's); an incoming gradient
    of h_end when ``dh_end``; twice, bit for bit."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(21)
    bsz, s, d = x.shape
    n = b_in.shape[-1]
    dy = torch.randn(bsz, s, d, generator=gen, device="cuda")
    dhe = (torch.randn(bsz, d, n, generator=gen, device="cuda")
           if dh_end else None)
    bc = torch.cat([b_in, c_out], dim=-1)

    def grads(fn):
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, dt, bc, a_log)]
        h = None if h0 is None else h0.detach().requires_grad_(True)
        if h is not None:
            leaves.append(h)
        y, h_end = fn(leaves[0], leaves[1], leaves[2][..., :n],
                      leaves[2][..., n:], leaves[3], h)
        outs, cots = [y], [dy]
        if dhe is not None:
            outs.append(h_end)
            cots.append(dhe)
        return y.detach(), torch.autograd.grad(outs, leaves, cots)

    before = ss.bwd_launches
    y, got = grads(ss.ssm_scan)
    _, again = grads(ss.ssm_scan)
    torch.cuda.synchronize()
    if ss.bwd_launches - before != 2:
        fail(f"ssm_scan_bwd[{name}]: the backward kernel did not launch "
             "once a gradient")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"ssm_scan_bwd[{name}]: two runs differ")
    y_want, want = grads(ss.ssm_scan_plain)
    row = {"case": name, "b": bsz, "s": s, "d": d, "n": n,
           "h0": h0 is not None, "dh_end": dh_end}
    y_err, _, y_ok = _grad_close(name, y, y_want)
    row["y_max_abs_err"] = y_err
    tags = ("dx", "ddt", "dbc", "da_log", "dh0")
    for tag, a, b in zip(tags, got, want):
        err, scale, ok = _grad_close(f"ssm_scan_bwd[{name}].{tag}", a, b)
        row[f"{tag}_max_abs_err"] = err
        row[f"{tag}_scale"] = scale
        if not ok:
            fail(f"ssm_scan_bwd[{name}]: {tag} disagrees with autograd of "
                 f"the plain twin, max abs err {err} (rtol {BWD_RTOL}, "
                 f"atol {BWD_ATOL} x {scale})")
    if not y_ok:
        fail(f"ssm_scan_bwd[{name}]: forward disagrees, {y_err}")
    return row


# K5's backward at the edges of its time split (the forward's: chunks
# of 8 segments of at most 64 steps; in a segment, checkpoints every 8
# steps, each 8-step block walked back as two register halves of 4):
# (name, (b, s, d, n), h0, dh_end).  One step; one short chunk with
# empty segments and a 5-step block (a 1-step later half); three chunks
# whose last holds a 64-step and a 12-step segment (a 4-step block:
# its later half empty) beside 6 empty ones, D off the channel group;
# a last chunk of 3 steps; two full chunks at N = 4.
SSM_BWD_SPLIT_CASES = (
    ("split-s1-h0-dh_end", (2, 1, 64, 16), True, True),
    ("split-s37-d50-n8-h0", (1, 37, 50, 8), True, False),
    ("split-s1100-d200-h0-dh_end", (2, 1100, 200, 16), True, True),
    ("split-s1027-d96-dh_end", (1, 1027, 96, 16), False, True),
    ("split-s1024-d64-n4", (1, 1024, 64, 4), False, False),
)


def check_under_checkpoint(dtype=None):
    """K4 and K5 inside ``torch.utils.checkpoint`` (non-reentrant), f32
    or bf16 inputs: the forward kernels run twice (the recompute), the
    backward kernels once (of the inputs' dtype), and the gradients
    equal the run without checkpoint bit for bit."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(22)
    q = torch.randn(1, 300, 10, 64, generator=gen, device="cuda").to(dtype)
    k = torch.randn(1, 300, 2, 64, generator=gen, device="cuda").to(dtype)
    v = torch.randn(1, 300, 2, 64, generator=gen, device="cuda").to(dtype)
    x, dt, bi, co, al = ssm_inputs(gen, 1, 300, 96, 16, dtype)

    def f(q, k, v, x, dt):
        o = fa.flash_attention(q, k, v, window=64)
        y, _ = ss.ssm_scan(x, dt, bi, co, al)
        return o.float().square().sum() + y.float().square().sum()

    def run(use_ckpt):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, x, dt)]
        zero_counts()
        loss = (checkpoint(f, *leaves, use_reentrant=False) if use_ckpt
                else f(*leaves))
        g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return g, counts()

    plain_g, plain_c = run(False)
    ck_g, ck_c = run(True)
    bf16 = int(dtype == torch.bfloat16)
    want_c = only(flash_attention=2, flash_attention_tc=2 * bf16,
                  flash_attention_bwd_dq=1, flash_attention_bwd_dkdv=1,
                  flash_attention_bwd_dq_bf16=bf16,
                  flash_attention_bwd_dkdv_bf16=bf16, ssm_scan=2,
                  ssm_scan_bwd=1, ssm_scan_bwd_bf16=bf16)
    if ck_c != want_c:
        fail(f"checkpoint: launch counts {ck_c}, expected {want_c}")
    if not all(torch.equal(a, b) for a, b in zip(plain_g, ck_g)):
        fail("checkpoint: gradients differ from the run without it")
    return {"case": "checkpoint", "dtype": str(dtype), "launches": ck_c,
            "launches_without": plain_c, "bitwise_equal": True}


def check_bwd_misaligned():
    """A q that sits 4 bytes off a 16-byte boundary (a contiguous view one
    float into its buffer): the forward runs, the backward raises
    ``ValueError`` before either backward kernel launches."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(25)
    b, s, h, hkv, d = 1, 64, 4, 1, 64
    buf = torch.randn(b * s * h * d + 1, generator=gen, device="cuda")
    q = buf[1:].view(b, s, h, d).requires_grad_(True)
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
            .requires_grad_(True) for _ in range(2))
    if q.data_ptr() % 16 == 0 or not q.is_contiguous():
        fail("check_bwd_misaligned: the view is not a misaligned "
             "contiguous tensor")
    out = fa.flash_attention(q, k, v)
    before = counts()
    try:
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    except ValueError as e:
        if counts() != before:
            fail("check_bwd_misaligned: launched before raising")
        return {"case": "misaligned-q", "q_address_mod_16":
                q.data_ptr() % 16, "raised": "ValueError",
                "message": str(e)}
    fail("check_bwd_misaligned: a misaligned q did not raise")


# bf16 training: K4's bf16 forward with lse and bf16 backward pair, K5's
# backward on bf16 inputs, each against autograd of its plain twin run
# in f32 on the same bf16 values (upcast), dO and dy the same bf16
# values.  A gradient passes when |got - want| <= atol * max(1, max
# |want|) + rtol * |want| at FA_TOL["bfloat16"] (rtol 8e-3, atol 1e-3),
# scaled as ``_grad_close`` scales: the kernels' gradients are rounded
# once to bf16 (2^-9 relative), the forward's output O (which delta =
# rowsum(dO * O) reads) too, and P and dS enter their products as two
# bf16 parts (to about 2^-16; one part, 2^-9, fails this tolerance:
# tests/test_torch_k4_bf16_wgmma_bwd.py).  The bf16 forward's lse is
# held to the f32
# tolerance FA_TOL["float32"] against ``flash_attention_fwd_plain``'s
# on the upcast inputs (both f32 sums of the same exact products), and
# its output to the forward without lse bit for bit.
BF16_BWD_TOL = FA_TOL["bfloat16"]
# The bf16 forward's out + out_lo (its output in two bf16 parts, which
# the backward's delta reads) against the plain twin's f32 output: P
# kept to about 2^-16 as two bf16 parts, exp through ex2.approx, f32
# sums in another order; a part missing or misplaced is off by 2^-9
BF16_OUT_LO_TOL = (1e-4, 1e-4)

# (name, (b, s, t, h, hkv, d), masks): all six head dims; GQA groups 1,
# 2, 4, 5 and 12; causal, window and q_offset; S and T off every tile
# grid; rows that see no key (all of them, and some beside rows that
# do).  The training layers are held to the same tolerance in
# ``flash_attention_bwd_bf16_times``.
BF16_BWD_CASES = (
    ("d16-group1-ragged-91x157-window40-offset66", (2, 91, 157, 6, 6, 16),
     dict(window=40, q_offset=66)),
    ("d32-group2-causal-130", (1, 130, 130, 4, 2, 32), {}),
    ("d64-group5-causal-130", (2, 130, 130, 5, 1, 64), {}),
    ("d64-q-offset-70-50x120-gqa4", (1, 50, 120, 4, 1, 64),
     dict(q_offset=70)),
    ("d64-no-visible-key", (1, 64, 128, 2, 1, 64),
     dict(causal=False, window=32, q_offset=200)),
    ("d64-some-rows-see-no-key", (1, 64, 128, 4, 2, 64),
     dict(causal=False, window=32, q_offset=140)),
    ("d80-full-77x203-gqa2", (1, 77, 203, 4, 2, 80), dict(causal=False)),
    ("d80-gqa4-window100-ragged-333", (2, 333, 333, 8, 2, 80),
     dict(window=100)),
    ("d128-gqa4-causal-300", (1, 300, 300, 8, 2, 128), {}),
    ("d128-off-grid-95x139-gqa4-offset44", (1, 95, 139, 8, 2, 128),
     dict(q_offset=44)),
    ("d128-window45-ragged-117x181-full-group2", (2, 117, 181, 6, 3, 128),
     dict(causal=False, window=45, q_offset=70)),
    ("d128-some-rows-see-no-key", (1, 64, 128, 4, 2, 128),
     dict(causal=False, window=32, q_offset=140)),
    ("d192-off-grid-71x105-gqa12-offset34", (1, 71, 105, 12, 1, 192),
     dict(q_offset=34)),
    ("d192-window20-inside-a-tile-160", (1, 160, 160, 4, 2, 192),
     dict(window=20)),
    ("d192-gqa5-window100-ragged-333", (2, 333, 333, 5, 1, 192),
     dict(window=100)),
)


def _grad_close_bf16(name, got, want):
    """(max abs err, scale, ok) of one bf16 gradient against its f32
    reference under ``BF16_BWD_TOL``, atol scaled by max(1, max
    |want|)."""
    import torch
    rtol, atol = BF16_BWD_TOL
    if got.shape != want.shape:
        fail(f"{name}: gradient shape {tuple(got.shape)} vs "
             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite gradient")
    scale = max(1.0, float(want.abs().max()))
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                        atol=atol * scale)
    return err, scale, ok


def _launched_since(before) -> dict:
    return {k: v - before[k] for k, v in counts().items() if v != before[k]}


def check_flash_bwd_bf16(name, q, k, v, do, *, causal=True, window=0,
                         q_offset=0):
    """K4's bf16 forward with lse and its bf16 backward pair on bf16 card
    tensors through ``flash_attention`` with grad: each bf16 kernel
    launched once a gradient (the f32 ones never), the gradients twice
    bit for bit and against autograd of ``gqa_plain`` in f32 on the
    upcast inputs (``BF16_BWD_TOL``); the forward's lse against
    ``flash_attention_fwd_plain``'s (FA_TOL f32) and its output equal
    to the forward without lse bit for bit."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
    ins = [x.detach().requires_grad_(True) for x in (qb, kb, vb)]
    before = counts()
    out = fa.flash_attention(*ins, **kw)
    got = torch.autograd.grad(out, ins, dob)
    again = torch.autograd.grad(fa.flash_attention(*ins, **kw), ins, dob)
    torch.cuda.synchronize()
    launched = _launched_since(before)
    want_launched = {key: 2 for key in (
        "flash_attention", "flash_attention_tc", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv", "flash_attention_bwd_dq_bf16",
        "flash_attention_bwd_dkdv_bf16")}
    if launched != want_launched:
        fail(f"flash_attention_bwd_bf16[{name}]: launches {launched}, "
             f"expected {want_launched}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"flash_attention_bwd_bf16[{name}]: two runs differ")
    if any(g.dtype != torch.bfloat16 for g in got):
        fail(f"flash_attention_bwd_bf16[{name}]: gradient dtypes "
             f"{[g.dtype for g in got]}")
    with_lse, lse, out_lo = fa._kernel_forward(qb, kb, vb, causal, window,
                                               q_offset, with_lse=True)
    without = fa._kernel_forward(qb, kb, vb, causal, window, q_offset,
                                 with_lse=False)[0]
    if not (torch.equal(with_lse, without) and torch.equal(out, without)):
        fail(f"flash_attention_bwd_bf16[{name}]: the forward's output "
             "changed with lse")
    full_want, lse_want = fa.flash_attention_fwd_plain(
        qb.float(), kb.float(), vb.float(), **kw)
    lse_err = float((lse - lse_want).abs().max())
    if not _close(lse, lse_want, FA_TOL["float32"]):
        fail(f"flash_attention_bwd_bf16[{name}]: lse disagrees with the "
             f"plain twin's, max abs err {lse_err}")
    full = with_lse.float() + out_lo.float()
    full_err = float((full - full_want).abs().max())
    if not _close(full, full_want, BF16_OUT_LO_TOL):
        fail(f"flash_attention_bwd_bf16[{name}]: out + out_lo is "
             f"{full_err} from the plain twin's f32 output (rtol, atol "
             f"{BF16_OUT_LO_TOL})")
    ref = [x.detach().float().requires_grad_(True) for x in (qb, kb, vb)]
    want = torch.autograd.grad(fa.gqa_plain(*ref, **kw), ref, dob.float())
    row = {"case": name, "q": list(q.shape), "k": list(k.shape), **kw,
           "lse_max_abs_err": lse_err, "out_plus_out_lo_max_abs_err": full_err}
    for tag, a, b in zip(("dq", "dk", "dv"), got, want):
        err, scale, ok = _grad_close_bf16(
            f"flash_attention_bwd_bf16[{name}].{tag}", a, b)
        row[f"{tag}_max_abs_err"] = err
        row[f"{tag}_scale"] = scale
        if not ok:
            fail(f"flash_attention_bwd_bf16[{name}]: {tag} disagrees with "
                 f"autograd of the plain twin, max abs err {err} (rtol, "
                 f"atol {BF16_BWD_TOL} x {scale})")
    return row


def check_ssm_bwd_bf16(name, x, dt, b_in, c_out, a_log, h0=None,
                       dh_end=True):
    """K5's forward and backward kernels on bf16 inputs (x, dt and the
    strided halves of one bf16 (B,S,2N) tensor; a_log, h0 and dh_end
    f32; dy bf16) against autograd of ``ssm_scan_plain`` in f32 on the
    upcast inputs (``BF16_BWD_TOL``); the backward launched once a
    gradient on its bf16 route; twice, bit for bit."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(27)
    bsz, s, d = x.shape
    n = b_in.shape[-1]
    dy = torch.randn(bsz, s, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    dhe = (torch.randn(bsz, d, n, generator=gen, device="cuda")
           if dh_end else None)
    bc = torch.cat([b_in, c_out], dim=-1)

    def grads(fn, upcast):
        leaves = [(t.float() if upcast and t.dtype == torch.bfloat16
                   else t).detach().requires_grad_(True)
                  for t in (x, dt, bc, a_log)]
        h = None if h0 is None else h0.detach().requires_grad_(True)
        if h is not None:
            leaves.append(h)
        y, h_end = fn(leaves[0], leaves[1], leaves[2][..., :n],
                      leaves[2][..., n:], leaves[3], h)
        outs, cots = [y], [dy.float() if upcast else dy]
        if dhe is not None:
            outs.append(h_end)
            cots.append(dhe)
        return torch.autograd.grad(outs, leaves, cots)

    before = counts()
    got = grads(ss.ssm_scan, False)
    again = grads(ss.ssm_scan, False)
    torch.cuda.synchronize()
    launched = _launched_since(before)
    want_launched = {"ssm_scan": 2, "ssm_scan_bwd": 2,
                     "ssm_scan_bwd_bf16": 2}
    if launched != want_launched:
        fail(f"ssm_scan_bwd_bf16[{name}]: launches {launched}, expected "
             f"{want_launched}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"ssm_scan_bwd_bf16[{name}]: two runs differ")
    want = grads(ss.ssm_scan_plain, True)
    row = {"case": name, "b": bsz, "s": s, "d": d, "n": n,
           "h0": h0 is not None, "dh_end": dh_end}
    for tag, a, b in zip(("dx", "ddt", "dbc", "da_log", "dh0"), got, want):
        err, scale, ok = _grad_close_bf16(f"ssm_scan_bwd_bf16[{name}].{tag}",
                                          a, b)
        row[f"{tag}_max_abs_err"] = err
        row[f"{tag}_scale"] = scale
        if not ok:
            fail(f"ssm_scan_bwd_bf16[{name}]: {tag} disagrees with autograd "
                 f"of the plain twin, max abs err {err} (rtol, atol "
                 f"{BF16_BWD_TOL} x {scale})")
    return row


# K5's bf16 backward at the short edges of its time split (one step; a
# short chunk with empty segments); the long ones are the f32 checks'
# (the split is the same code), hymba's shape ``ssm_scan_bwd_bf16_times``
SSM_BWD_BF16_SPLIT_CASES = SSM_BWD_SPLIT_CASES[:2]


def bf16_bwd_checks():
    """The bf16 training kernels: ``BF16_BWD_CASES`` through K4's bf16
    forward with lse and backward pair; K5's backward on bf16 inputs
    with N 4, 8 and 16, with and without h0 and dh_end, and at short
    edges of its time split (``SSM_BWD_BF16_SPLIT_CASES``); a misaligned
    bf16 q (the forward) and dO (the backward) raising ``ValueError``
    before any launch; and both under ``torch.utils.checkpoint``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(33)

    def qkvd(b, s, t, h, hkv, d):
        def r(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        return r(b, s, h, d), r(b, t, hkv, d), r(b, t, hkv, d), \
            r(b, s, h, d)

    fa_rows = [check_flash_bwd_bf16(name, *qkvd(*shape), **kw)
               for name, shape, kw in BF16_BWD_CASES]
    ss_rows = []
    for n in (4, 8, 16):
        x, dt, bi, co, al = ssm_inputs(gen, 2, 100, 200, n, torch.bfloat16)
        h0 = torch.randn(2, 200, n, generator=gen, device="cuda")
        ss_rows.append(check_ssm_bwd_bf16(f"n{n}-2x100x200", x, dt, bi, co,
                                          al, dh_end=False))
        ss_rows.append(check_ssm_bwd_bf16(f"n{n}-2x100x200-h0-dh_end", x,
                                          dt, bi, co, al, h0))
    for name, (b, s, d, n), with_h0, dh_end in SSM_BWD_BF16_SPLIT_CASES:
        x, dt, bi, co, al = ssm_inputs(gen, b, s, d, n, torch.bfloat16)
        h0 = (torch.randn(b, d, n, generator=gen, device="cuda")
              if with_h0 else None)
        ss_rows.append(check_ssm_bwd_bf16(name, x, dt, bi, co, al, h0,
                                          dh_end=dh_end))
    return {"rtol": BF16_BWD_TOL[0], "atol": BF16_BWD_TOL[1],
            "atol_scaled_by": "max(1, max |want|) per gradient",
            "lse_tol": FA_TOL["float32"], "out_lo_tol": BF16_OUT_LO_TOL,
            "flash_attention_bwd_bf16": fa_rows,
            "ssm_scan_bwd_bf16": ss_rows,
            "raises": check_bwd_misaligned_bf16(),
            "checkpoint": check_under_checkpoint(torch.bfloat16)}


def check_bwd_misaligned_bf16():
    """bf16 views 2 bytes off a 16-byte boundary: a q (the forward's TMA
    rule: ``ValueError`` before the forward launches) and a dO (the
    backward's TMA rule: ``ValueError`` after the forward, before
    either backward kernel launches)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(34)
    b, s, h, hkv, d = 1, 64, 4, 1, 64

    def off_by_one(shape):
        buf = torch.randn(math.prod(shape) + 1, generator=gen,
                          device="cuda").to(torch.bfloat16)
        t = buf[1:].view(shape)
        if t.data_ptr() % 16 == 0 or not t.is_contiguous():
            fail("check_bwd_misaligned_bf16: the view is not a misaligned "
                 "contiguous tensor")
        return t

    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
            .to(torch.bfloat16).requires_grad_(True) for _ in range(2))
    rows = []
    q_bad = off_by_one((b, s, h, d)).requires_grad_(True)
    before = counts()
    try:
        fa.flash_attention(q_bad, k, v)
        fail("check_bwd_misaligned_bf16: a misaligned bf16 q did not raise")
    except ValueError as e:
        if counts() != before:
            fail("check_bwd_misaligned_bf16: launched before raising")
        rows.append({"case": "misaligned-bf16-q", "raised": "ValueError",
                     "message": str(e)})
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    out = fa.flash_attention(q, k, v)
    do_bad = off_by_one((b, s, h, d))
    before = counts()
    try:
        torch.autograd.grad(out, (q, k, v), do_bad)
    except ValueError as e:
        if counts() != before:
            fail("check_bwd_misaligned_bf16: launched before raising")
        rows.append({"case": "misaligned-bf16-do", "raised": "ValueError",
                     "message": str(e)})
        return rows
    fail("check_bwd_misaligned_bf16: a misaligned bf16 dO did not raise")


HEAD_DIMS = (16, 32, 64, 80, 128, 192)  # K4's instantiations

# The tensor-core kernels as cuobjdump names them (mangled): library ->
# [(pattern of a kernel's name, its key from the match, the keys wanted,
# the instruction each must hold, one it must not)]: the split-TF32
# kernels (the f32 forward and backward) TF32 HMMA, the bf16 forward
# and backward wgmma (HGMMA in SASS) and no TF32 HMMA
SASS_KERNELS = {
    "flash_attention_bwd": [(
        r"_Z\d+(fa_bwd_\w+?_kernel)ILi(\d+)ELb([01])EE",
        lambda m: _bwd_key(m),
        {f"fa_bwd_{kind}_kernel<{d}>{cap}" for kind in ("dq", "dkdv")
         for d in HEAD_DIMS for cap in ("", "+cap")}, "tf32_hmma", None)],
    "flash_attention_bwd_tc": [(
        r"_ZN2tc\d+(fa_bwd_tc_\w+?_kernel)ILi(\d+)ELb([01])EE",
        lambda m: _bwd_key(m),
        {f"fa_bwd_tc_{kind}_kernel<{d}>{cap}" for kind in ("dq", "dkdv")
         for d in HEAD_DIMS for cap in ("", "+cap")}, "hgmma",
        "tf32_hmma")],
    "flash_attention": [(
        r"_Z\d+(fa_fwd_f32_kernel)ILi(\d+)ELb([01])ELb([01])EE",
        lambda m: _fwd_key(m),
        {f"fa_fwd_f32_kernel<{d}, {lse}>" for d in HEAD_DIMS
         for lse in ("true", "false")}
        | {f"fa_fwd_f32_kernel<{d}, true>+cap" for d in HEAD_DIMS},
        "tf32_hmma", None), (
        r"_ZN2tc\d+(flash_attention_tc_kernel)ILi(\d+)ELb([01])ELb([01])EE",
        lambda m: _fwd_key(m),
        {f"flash_attention_tc_kernel<{d}, {lse}>" for d in HEAD_DIMS
         for lse in ("true", "false")}
        | {f"flash_attention_tc_kernel<{d}, true>+cap" for d in HEAD_DIMS},
        "hgmma", "tf32_hmma")],
}


def _fwd_key(m) -> str:
    """A forward kernel's key: ``name<D, lse>`` as before the softcap
    (so its rows compare with earlier runs'), ``+cap`` for the CAP
    instantiations (flash_attention_softcap.cu)."""
    lse = "true" if m.group(3) == "1" else "false"
    return f"{m.group(1)}<{m.group(2)}, {lse}>" + \
        ("+cap" if m.group(4) == "1" else "")


def _bwd_key(m) -> str:
    """A backward kernel's key: ``name<D>`` as before the softcap (so
    its rows compare with earlier runs'), ``+cap`` for the CAP
    instantiations (flash_attention_bwd{,_tc}_softcap.cu)."""
    return f"{m.group(1)}<{m.group(2)}>" + ("+cap" if m.group(3) == "1"
                                           else "")


def _sass_op(kind: str, line: str) -> bool:
    return ("HMMA" in line and "TF32" in line) if kind == "tf32_hmma" \
        else "HGMMA" in line


def library_sass(library: str) -> dict:
    """A built library as ``cuobjdump`` reads it (one ``-sass`` and one
    ``-res-usage`` pass): each tensor-core kernel's tensor-core
    instructions (TF32 ``HMMA`` for the split-TF32 kernels, ``HGMMA``
    for the ``wgmma`` kernels, and the count of the one it must not
    hold), registers and local-memory (spill) bytes; fails when a kernel
    of ``SASS_KERNELS`` is missing, has none of its instruction, has the
    forbidden one, or spills.  ``seconds``: what the two reads took."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build([library])[library]
    tool = str(Path(_build._nvcc()).parent / "cuobjdump")

    # the two reads at once (each a pass over the whole library)
    procs = [subprocess.Popen([tool, flag, str(lib)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for flag in ("-sass", "-res-usage")]
    outs = [proc.communicate(timeout=120) for proc in procs]
    if any(proc.returncode for proc in procs):
        fail(f"cuobjdump of {library}: {[err for _, err in outs]}")
    sass, usage = (out for out, _ in outs)
    kernels = {}
    for name, key, want, op, banned in SASS_KERNELS[library]:
        found, current = {}, None
        for line in sass.splitlines():
            if "Function : " in line:
                m = re.search(r"Function : " + name, line)
                current = key(m) if m else None
                if current:
                    found[current] = {op: 0, **({banned: 0} if banned
                                                else {})}
            elif current and _sass_op(op, line):
                found[current][op] += 1
            elif current and banned and _sass_op(banned, line):
                found[current][banned] += 1
        for m in re.finditer(name + r"\S*:\s*REG:(\d+) STACK:(\d+) \S+ "
                             r"LOCAL:(\d+)", usage):
            regs = m.groups()[-3:]
            found[key(m)].update(
                registers=int(regs[0]), stack_bytes=int(regs[1]),
                local_bytes=int(regs[2]))
        if set(found) != want or not all(k[op] for k in found.values()):
            fail(f"{library} library: a tensor-core kernel missing or "
                 f"without {op}: {found}")
        if banned and any(k[banned] for k in found.values()):
            fail(f"{library} library: a kernel holds {banned}: {found}")
        spills = {k: v for k, v in found.items() if v.get("local_bytes")}
        if spills:
            fail(f"{library} library: kernels spill: {spills}")
        kernels.update(found)
    return {**kernels, "seconds": time.perf_counter() - t0}


def kernel_bwd_checks():
    """K4's two backward kernels and K5's backward kernel against
    autograd of their plain twins on the card (f32): small and odd
    shapes, GQA groups 1, 4 and 5, causal, window and q_offset, rows
    that see no key (alone and beside rows that do), the two full-width
    layer shapes of the training path; head dims 128 and 192
    (``WIDE_HEAD_CASES``) and their tiling's edges
    (``WIDE_BWD_EDGE_CASES``); the pair twice at nemotron's layer, bit
    for bit (``check_flash_bwd_repeat``); K5 with N 4, 8 and 16, with and
    without h0, with and without an incoming h_end gradient, hymba's
    full shape and the edges of its time split
    (``SSM_BWD_SPLIT_CASES``); both under ``torch.utils.checkpoint``;
    the bf16 kernels of training (``bf16_bwd_checks``); and
    ``cuobjdump`` of the tensor-core libraries (``library_sass``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(20)

    def qkvd(b, s, t, h, hkv, d, g=gen):
        def r(*shape):
            return torch.randn(*shape, generator=g, device="cuda")
        return r(b, s, h, d), r(b, t, hkv, d), r(b, t, hkv, d), \
            r(b, s, h, d)

    fa_rows = [
        check_flash_bwd("group1-100-causal", *qkvd(2, 100, 100, 4, 4, 64)),
        check_flash_bwd("group4-77-window16-d32",
                        *qkvd(1, 77, 77, 8, 2, 32), window=16),
        check_flash_bwd("group5-130-causal", *qkvd(2, 130, 130, 5, 1, 64)),
        check_flash_bwd("q-offset-70-50x120-d16",
                        *qkvd(1, 50, 120, 4, 1, 16), q_offset=70),
        check_flash_bwd("full-200x333-group4", *qkvd(1, 200, 333, 8, 2, 64),
                        causal=False),
        check_flash_bwd("no-visible-key", *qkvd(1, 64, 128, 2, 1, 64),
                        causal=False, window=32, q_offset=200),
        check_flash_bwd("some-rows-see-no-key", *qkvd(1, 64, 128, 4, 2, 64),
                        causal=False, window=32, q_offset=140),
        check_flash_bwd("hymba-layer-1x2048-gqa5-window1024",
                        *qkvd(1, 2048, 2048, 25, 5, 64), window=1024),
        check_flash_bwd("llama-layer-2x2048-gqa4-causal",
                        *qkvd(2, 2048, 2048, 32, 8, 64)),
    ]
    # the edges of the tensor-core tiling (64 rows by 64 keys), on their
    # own generator: S and T off the tile at D = 16 and 32 with window
    # and q_offset; a GQA-5 band over 16 key tiles (blocks far below the
    # SM count)
    edge = torch.Generator(device="cuda").manual_seed(26)
    fa_rows += [
        check_flash_bwd("ragged-91x157-d16-window40-offset66",
                        *qkvd(2, 91, 157, 6, 2, 16, edge), window=40,
                        q_offset=66),
        check_flash_bwd("ragged-130x99-d32-full-window50-offset20",
                        *qkvd(1, 130, 99, 4, 1, 32, edge), causal=False,
                        window=50, q_offset=20),
        check_flash_bwd("gqa5-1x1000-window300-16-key-tiles",
                        *qkvd(1, 1000, 1000, 5, 1, 64, edge), window=300),
    ]
    # head dims 128 and 192 (their own tilings), on their own generator
    wide = torch.Generator(device="cuda").manual_seed(30)
    fa_rows += [check_flash_bwd(name, *qkvd(*shape, wide), **kw)
                for name, shape, kw in WIDE_HEAD_CASES]
    # the wide heads' 48- and 32-row moving tiles at their edges
    wide_edge = torch.Generator(device="cuda").manual_seed(32)
    fa_rows += [check_flash_bwd(name, *qkvd(*shape, wide_edge), **kw)
                for name, shape, kw in WIDE_BWD_EDGE_CASES]
    ss_rows = []
    for n in (4, 8, 16):
        x, dt, bi, co, al = ssm_inputs(gen, 2, 100, 200, n, torch.float32)
        h0 = torch.randn(2, 200, n, generator=gen, device="cuda")
        ss_rows.append(check_ssm_bwd(f"n{n}-2x100x200", x, dt, bi, co, al,
                                     dh_end=False))
        ss_rows.append(check_ssm_bwd(f"n{n}-2x100x200-h0-dh_end", x, dt, bi,
                                     co, al, h0))
    x, dt, bi, co, al = ssm_inputs(gen, 1, 37, 50, 16, torch.float32)
    ss_rows.append(check_ssm_bwd("s37-d50-dh_end", x, dt, bi, co, al))
    x, dt, bi, co, al = ssm_inputs(gen, 1, 2048, 3200, 16, torch.float32)
    ss_rows.append(check_ssm_bwd("hymba-1x2048x3200x16", x, dt, bi, co, al,
                                 dh_end=False))
    # the edges of the backward's time split, on their own generator
    split_gen = torch.Generator(device="cuda").manual_seed(28)
    for name, (b, s, d, n), with_h0, dh_end in SSM_BWD_SPLIT_CASES:
        x, dt, bi, co, al = ssm_inputs(split_gen, b, s, d, n, torch.float32)
        h0 = (torch.randn(b, d, n, generator=split_gen, device="cuda")
              if with_h0 else None)
        ss_rows.append(check_ssm_bwd(name, x, dt, bi, co, al, h0,
                                     dh_end=dh_end))
    return {"rtol": BWD_RTOL, "atol": BWD_ATOL,
            "atol_scaled_by": "max(1, max |want|) per gradient",
            "flash_attention_bwd": fa_rows,
            "flash_attention_bwd_repeat": check_flash_bwd_repeat(),
            "ssm_scan_bwd": ss_rows,
            "raises": [check_bwd_misaligned()],
            "checkpoint": check_under_checkpoint(),
            "bf16": bf16_bwd_checks(),
            "flash_attention_bwd_sass": library_sass("flash_attention_bwd"),
            "flash_attention_bwd_tc_sass":
                library_sass("flash_attention_bwd_tc"),
            "flash_attention_f32_sass": library_sass("flash_attention")}


# ---------------------------------------------------------------------
# LM serving: prefill and decode at full width (K4, K5)
# ---------------------------------------------------------------------

# (arch, batch, prompt length, the attention route attention() takes)
LM_PREFILL = (("hymba-1.5b", 2, 4096, "banded"),
              ("hymba-1.5b", 2, 1024, "chunked"),
              ("llama3.2-1b", 2, 4096, "chunked"))
LM_WARM_RUNS = 3
# the serving path: 4 requests, a 32-token prompt filled by decode
# steps, then 32 greedy steps (the host-bound decode's other seconds go
# to the xLSTM phases)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 32
# the consistency run (f32): longer than hymba's window of 1024, so that
# the ring cache wraps, and a multiple of its attention chunks, so that
# prefill takes the banded branch.  The chunk sizes (TrainConfig's
# attn_chunk_q / attn_chunk_kv) only choose the route on the card, where
# either branch is one kernel launch; chunks of 256 admit S = 1280.
CONSISTENCY_S = 1280
CONSISTENCY_CHUNK = 256
# its depth, cut from hymba's 32 layers at full width: the 1280 decode
# steps are host-bound (~270 PyTorch ops a layer a step), so the
# script's time limit, not the card, sets the number of layers (8 took
# 24-31 s of the script on one H100's host, 4 took 12-15 s; one layer
# keeps every kind the check reads -- each hymba layer has the banded
# attention, the SSM and the ring cache -- and frees the seconds the
# xLSTM phases need)
CONSISTENCY_LAYERS = 1
# f32 logits of a random-weight model (up to 32 layers), two orders of summation
# (GEMM vs GEMV products, chunked vs stepwise scan, kernel vs plain
# softmax): absolute, on logits of order one
CONSISTENCY_ATOL = 2e-3


def _lm_params(arch, dtype, num_layers=None):
    """Full-width random parameters drawn on the card from seed 0, at the
    arch's depth or ``num_layers``."""
    import dataclasses
    import torch
    from repro_torch.config import get_arch
    from repro_torch.models import init_model
    cfg = get_arch(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(cfg, gen, dtype)
    return cfg, params


def _param_bytes(params):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


@contextlib.contextmanager
def recording_attention_calls(calls):
    """Every call the model makes to the attention kernel's wrapper, as
    (q shape, k shape, dtype, causal, window, q_offset), into
    ``calls``; the call goes through unchanged."""
    from repro_torch.kernels import ops as kernel_ops

    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), q.dtype,
                      kw.get("causal", True), kw.get("window", 0),
                      kw.get("q_offset", 0)))
        return real(q, k, v, **kw)

    with patched(kernel_ops, "gqa_flash_attention", recording) as real:
        yield


@contextlib.contextmanager
def recording_routes(routes):
    """The attention branch (``banded`` / ``chunked`` / ``naive``, and
    the context-parallel ``banded_cp`` / ``chunked_cp``) of every call
    to ``models.attention.attention``."""
    from repro_torch.models import attention as attn_lib

    def wrap(name, real):
        def rec(*a, **kw):
            routes.append(name)
            return real(*a, **kw)
        return rec

    with contextlib.ExitStack() as stack:
        for name in ("banded", "chunked", "naive", "banded_cp",
                     "chunked_cp"):
            attr = name.replace("_cp", "_attention_cp") if "_cp" in name \
                else f"{name}_attention"
            stack.enter_context(patched(attn_lib, attr, wrap(
                name, getattr(attn_lib, attr))))
        yield


def lm_prefill_path(models):
    """``make_prefill_step`` at full width in bf16 (``TrainConfig().
    dtype``) on every case of ``LM_PREFILL``: first run (the kernels'
    build and load included) with the launch counts read around it, then
    warm runs.  ``models`` caches the parameters for later phases."""
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.launch.steps import make_prefill_step
    tcfg = TrainConfig()
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        tcfg.dtype]
    out, attn_calls = [], []
    for arch, b, s, route in LM_PREFILL:
        if arch not in models:
            t0 = time.perf_counter()
            models[arch] = _lm_params(arch, dtype)
            torch.cuda.synchronize()
            models[arch + ":init_s"] = time.perf_counter() - t0
        cfg, params = models[arch]
        step = make_prefill_step(cfg, tcfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device="cuda")
        routes, calls = [], []
        with recording_routes(routes), recording_attention_calls(calls):
            zero_counts()
            t0 = time.perf_counter()
            logits = step(params, {"tokens": toks})
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launched = counts()
        hybrid = cfg.family == "hybrid"
        # bf16: every K4 launch is the wgmma kernel, none the f32 one
        want = only(flash_attention=cfg.num_layers,
                    flash_attention_tc=cfg.num_layers
                    if dtype == torch.bfloat16 else 0,
                    ssm_scan=cfg.num_layers if hybrid else 0)
        if launched != want:
            fail(f"prefill {arch} B={b} S={s}: launches {launched}, "
                 f"expected {want}")
        if set(routes) != {route} or len(routes) != cfg.num_layers:
            fail(f"prefill {arch} S={s}: attention routes {set(routes)} "
                 f"x{len(routes)}, expected {route}")
        if any(kv[2] != cfg.n_kv_heads for _, kv, *_ in calls):
            fail(f"prefill {arch}: the kernel was handed repeated k/v")
        if tuple(logits.shape) != (b, cfg.vocab_size) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"prefill {arch}: logits {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
        warm = []
        for _ in range(LM_WARM_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = step(params, {"tokens": toks})
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        if not torch.equal(again, logits):
            fail(f"prefill {arch}: a warm run's logits differ from the "
                 "first run's")
        med = statistics.median(warm)
        attn_calls.append((arch, route, calls[0]))
        out.append({"arch": arch, "batch": b, "prompt_len": s,
                    "route": route, "dtype": str(dtype),
                    "param_bytes": _param_bytes(params),
                    "init_s": models[arch + ":init_s"],
                    "first_run_s": first_s, "warm_s": warm,
                    "warm_s_median": med,
                    "prompt_tokens_per_s": b * s / med,
                    "launches": launched})
    return out, attn_calls


def lm_serve_path(models):
    """The serving path at full width, bf16, hymba-1.5b: 4 requests, the
    decode state filled by decode steps over a 32-token prompt (as the
    JAX package's ``launch/serve.py`` does), then 32 greedy steps, every
    one through ``make_serve_step``; then the CLI once at its reduced
    defaults."""
    import torch
    from repro_torch.config.base import InputShape, TrainConfig
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_decode_state
    cfg, params = models["hymba-1.5b"]
    cache_len = SERVE_PROMPT + SERVE_GEN
    shape = InputShape("serve", cache_len, SERVE_BATCH, "decode")
    step = make_serve_step(cfg, shape, TrainConfig())
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device="cuda")
    state = init_decode_state(cfg, SERVE_BATCH, cache_len,
                              dtype=torch.bfloat16, device="cuda")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SERVE_PROMPT):
        logits, state = step(params, state,
                             {"tokens": prompts[:, i:i + 1]})
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out_tokens = []
    t0 = time.perf_counter()
    for _ in range(SERVE_GEN):
        out_tokens.append(tok)
        logits, state = step(params, state, {"tokens": tok})
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launched = counts()
    steps = SERVE_PROMPT + SERVE_GEN
    want = only(ssm_scan=cfg.num_layers * steps)
    if launched != want:
        fail(f"serve path launches {launched}, expected {want}")
    toks = torch.cat(out_tokens, dim=1)
    if state["pos"] != steps or not bool(torch.isfinite(logits).all()) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"serve path: pos {state['pos']}, tokens "
             f"{toks[0, :8].tolist()}")
    # the CLI, at its reduced defaults, on the card, in this process (a
    # new process would spend ~8 s of the script reaching the card)
    import io
    from repro_torch.launch import serve as serve_cli
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cli_tokens = serve_cli.main(["--arch", "hymba-1.5b"])
    cli_s = time.perf_counter() - t0
    if cli_tokens.shape[0] < 1 or "[serve] hymba-1.5b-reduced" \
            not in printed.getvalue():
        fail(f"repro_torch.launch.serve: {printed.getvalue()}")
    return {"arch": cfg.arch_id, "batch": SERVE_BATCH,
            "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN,
            "dtype": "torch.bfloat16",
            "prompt_fill_s": fill_s,
            "prompt_fill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / fill_s,
            "decode_s": decode_s,
            "decode_tokens_per_s": SERVE_BATCH * SERVE_GEN / decode_s,
            "s_per_decode_step": decode_s / SERVE_GEN,
            "launches": launched,
            "ssm_scan_per_step": launched["ssm_scan"] / steps,
            "sample_tokens": toks[0, :16].tolist(),
            "cli_s": cli_s,
            "cli_stdout": printed.getvalue().strip().splitlines()}


# The bf16 prefill with K4 against the f32 forward on the same weights,
# beside the same prefill with the plain attention: K4's RMS distance at
# most this multiple of the plain one's (both carry every other bf16
# rounding of the model; K4 adds its own few).  The model's own bf16
# roundings dominate the distance, so this catches gross faults only:
# rounding P to bf16 once reads 0.966 on the card, P split 0.930.  K4's
# precision is checked by FA_TOL against its plain twin.
BF16_RMS_RATIO = 1.25


def bf16_prefill_vs_f32(cfg, params):
    """The bf16 hymba-1.5b prefill of B=1 x 1280 tokens (banded route,
    as in ``lm_consistency``) twice -- with the tensor-core K4, and with
    the plain twin ``gqa_plain`` patched in for it (K5 runs in both) --
    and the f32 forward on the same weights (the bf16 parameters
    upcast; K4's f32 kernel and K5): each bf16 run's last-position
    logits against the f32 ones (max abs and RMS distance), the
    kernel-vs-plain distance, the greedy tokens and the launch counts.
    Gates nothing itself."""
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.tree import tree_map
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, CONSISTENCY_S),
                         generator=gen, device="cuda")
    prefill = make_prefill_step(cfg, TrainConfig(
        attn_chunk_q=CONSISTENCY_CHUNK, attn_chunk_kv=CONSISTENCY_CHUNK))
    zero_counts()
    got = prefill(params, {"tokens": toks}).float()
    torch.cuda.synchronize()
    kernel_counts = counts()

    def plain_attention(q, k, v, **kw):
        return fa.gqa_plain(q, k, v, **kw)

    with patched(kernel_ops, "gqa_flash_attention", plain_attention):
        zero_counts()
        plain = prefill(params, {"tokens": toks}).float()
        torch.cuda.synchronize()
        plain_counts = counts()
    f32_params = tree_map(lambda t: t.float(), params)
    exact = prefill(f32_params, {"tokens": toks})
    torch.cuda.synchronize()
    del f32_params
    torch.cuda.empty_cache()

    def dist(a, b):
        diff = (a - b).double()
        return float(diff.abs().max()), float(diff.pow(2).mean().sqrt())

    k_max, k_rms = dist(got, exact)
    p_max, p_rms = dist(plain, exact)
    return {"arch": cfg.arch_id, "batch": 1, "seq_len": CONSISTENCY_S,
            "dtype": "torch.bfloat16",
            "kernel_vs_f32_max_abs": k_max, "kernel_vs_f32_rms": k_rms,
            "plain_vs_f32_max_abs": p_max, "plain_vs_f32_rms": p_rms,
            "kernel_vs_plain_max_abs": dist(got, plain)[0],
            "logits_max_abs": float(exact.abs().max()),
            "logits_rms": float(exact.double().pow(2).mean().sqrt()),
            "greedy_token_kernel": int(got.argmax(-1)[0]),
            "greedy_token_plain": int(plain.argmax(-1)[0]),
            "greedy_token_f32": int(exact.argmax(-1)[0]),
            "launches_kernel": kernel_counts, "launches_plain": plain_counts}


def lm_bf16_kernel_vs_plain(models):
    """Gated: ``bf16_prefill_vs_f32`` on the serving path's bf16
    hymba-1.5b parameters.  K4's logits may sit no further from the f32
    forward's than ``BF16_RMS_RATIO`` times the plain attention's (RMS),
    with the same greedy token as the plain run and as the f32 forward;
    every K4 launch is the tensor-core kernel.  A gate for gross faults
    (see ``BF16_RMS_RATIO``)."""
    cfg, params = models["hymba-1.5b"]
    out = bf16_prefill_vs_f32(cfg, params)
    if out["launches_kernel"] != only(flash_attention=cfg.num_layers,
                                      flash_attention_tc=cfg.num_layers,
                                      ssm_scan=cfg.num_layers) \
            or out["launches_plain"] != only(ssm_scan=cfg.num_layers):
        fail(f"bf16 kernel-vs-plain prefill launches "
             f"{out['launches_kernel']}, {out['launches_plain']}")
    ratio = out["kernel_vs_f32_rms"] / out["plain_vs_f32_rms"]
    tokens = (out["greedy_token_kernel"], out["greedy_token_plain"],
              out["greedy_token_f32"])
    if ratio > BF16_RMS_RATIO or len(set(tokens)) != 1:
        fail(f"bf16 prefill: K4's RMS distance to the f32 forward is "
             f"{ratio} x the plain attention's (at most {BF16_RMS_RATIO}),"
             f" greedy tokens (kernel, plain, f32) {tokens}")
    return {**out, "gated": True, "rms_ratio": ratio,
            "rms_ratio_limit": BF16_RMS_RATIO}


def lm_consistency():
    """f32 parameters (``set_full_f32``), hymba-1.5b at full width and
    ``CONSISTENCY_LAYERS`` deep, B=1, S=1280: the prefill step's last-position logits (K4 banded, K5)
    against the last logits of decode steps over the same tokens (ring
    cache of 1024, K5 with a carried h0), and the same prefill with the
    plain twins patched in for the kernels."""
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import decode_step, init_decode_state
    cfg, params = _lm_params("hymba-1.5b", torch.float32,
                             num_layers=CONSISTENCY_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, CONSISTENCY_S),
                         generator=gen, device="cuda")
    prefill = make_prefill_step(cfg, TrainConfig(
        attn_chunk_q=CONSISTENCY_CHUNK, attn_chunk_kv=CONSISTENCY_CHUNK))
    routes = []
    with recording_routes(routes):
        zero_counts()
        got = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_counts = counts()
    if routes != ["banded"] * cfg.num_layers:
        fail(f"consistency prefill: attention routes {set(routes)} "
             f"x{len(routes)}, expected banded x{cfg.num_layers}")

    def plain_attention(q, k, v, **kw):
        return fa.gqa_plain(q, k, v, **kw)

    with patched(kernel_ops, "gqa_flash_attention", plain_attention), \
            patched(ss, "ssm_scan", ss.ssm_scan_plain):
        zero_counts()
        plain = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        plain_counts = counts()
    if plain_counts != only():
        fail(f"the plain forward launched kernels: {plain_counts}")

    state = init_decode_state(cfg, 1, CONSISTENCY_S, dtype=torch.float32,
                              device="cuda")
    zero_counts()
    t0 = time.perf_counter()
    for i in range(CONSISTENCY_S):
        logits, state = decode_step(cfg, params, state, toks[:, i:i + 1])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_counts = counts()
    dec = logits[:, -1]
    kv_len = int(state["layers"]["kv"]["k"].shape[2])
    del params, state
    torch.cuda.empty_cache()

    vs_decode = float((got - dec).abs().max())
    vs_plain = float((got - plain).abs().max())
    same_token = bool(torch.equal(got.argmax(-1), dec.argmax(-1))) and \
        bool(torch.equal(got.argmax(-1), plain.argmax(-1)))
    if prefill_counts != only(flash_attention=cfg.num_layers,
                              ssm_scan=cfg.num_layers):
        fail(f"consistency prefill launches {prefill_counts}")
    if decode_counts != only(ssm_scan=cfg.num_layers * CONSISTENCY_S):
        fail(f"consistency decode launches {decode_counts}")
    if kv_len >= CONSISTENCY_S:
        fail(f"consistency decode: the ring cache ({kv_len}) never wrapped")
    if vs_decode > CONSISTENCY_ATOL or vs_plain > CONSISTENCY_ATOL \
            or not same_token:
        fail(f"lm consistency: prefill vs decode {vs_decode}, kernels vs "
             f"plain {vs_plain} (atol {CONSISTENCY_ATOL}), same greedy "
             f"token {same_token}")
    return {"arch": cfg.arch_id, "num_layers": cfg.num_layers, "batch": 1,
            "seq_len": CONSISTENCY_S,
            "dtype": "torch.float32", "kv_ring_len": kv_len,
            "prefill_vs_decode_max_abs": vs_decode,
            "kernels_vs_plain_max_abs": vs_plain,
            "atol": CONSISTENCY_ATOL,
            "logits_max_abs": float(got.abs().max()),
            "greedy_token": int(got.argmax(-1)[0]),
            "greedy_token_equal": same_token,
            "decode_s": decode_s, "launches_prefill": prefill_counts,
            "launches_decode": decode_counts}


# ---------------------------------------------------------------------
# LM training at full width (K4 and K5 forward and backward, f32)
# ---------------------------------------------------------------------

# (arch, batch, seq): hymba's window of 1024 < 2048 puts its attention
# on the banded branch; llama is causal (chunked branch)
LM_TRAIN = (("hymba-1.5b", 1, 2048), ("llama3.2-1b", 2, 2048))
# timed steps: the first and one warm (a third step's seconds go to the
# xLSTM and MoE phases)
LM_TRAIN_STEPS = 2
# one more step after the timed ones, traced by torch.profiler (CUDA
# kernels and the CPU ops that launched them) and left out of the step
# times
PROFILED_STEPS = 1
# One full-width hymba block's gradients through the kernels against the
# plain twins patched in, same weights and input: f32 sums in other
# orders through the block's GEMMs (reductions over 2048 tokens) and the
# scan's exp through ex2.approx (2^-22 relative) carried through the
# SSM's memory: each leaf's max abs error at most 1e-4 x its largest
# |gradient|.  The sound kernels read 6.9e-06; planted faults
# (tools/block_grad_mutants.py) read what PERF.md records.
BLOCK_GRAD_RTOL = 1e-4
# The same block in bf16 (weights, input, cotangent; the bf16 kernels
# against the plain twins, which compute in f32 and round to bf16 as
# the kernels do): the two routes' outputs differ by f32 sums in another
# order, whose bf16 rounding flips an ulp (2^-8) here and there, and the
# block carries those flips into every gradient: each leaf within 2e-2
# of its largest |gradient|, the model tolerance of
# tests/test_torch_bf16_train.py.
BLOCK_GRAD_BF16_RTOL = 2e-2


@contextlib.contextmanager
def recording_train_steps(record, profile=False,
                          profile_after=LM_TRAIN_STEPS,
                          groups=None):
    """``launch.train``'s ``make_train_step`` with each step timed on the
    host between two synchronizes (``record["step_s"]``) and the last
    step's (params, opt_state, metrics) kept (``record["last"]``).  With
    ``profile`` the step after ``profile_after`` steps runs under
    ``torch.profiler`` instead of the clock: ``record["profile"]`` is
    its ``step_profile`` (kernels grouped by ``groups``, default
    ``STEP_GROUPS``), or with ``profile="kernels"`` its
    ``kernel_profile`` (device activity only, for steps of ~10^5
    host-bound ops)."""
    import torch
    from repro_torch.launch import train as train_mod

    def wrapped(cfg, tcfg, lr=None):
        step, opt = real(cfg, tcfg, lr)

        def timed(params, opt_state, batch):
            torch.cuda.synchronize()
            if profile == "kernels" \
                    and len(record["step_s"]) == profile_after:
                out, record["profile"] = kernel_profile(
                    lambda: step(params, opt_state, batch),
                    groups or STEP_GROUPS)
            elif profile and len(record["step_s"]) == profile_after:
                out, record["profile"] = profiled_step(
                    lambda: step(params, opt_state, batch),
                    groups or STEP_GROUPS)
            else:
                t0 = time.perf_counter()
                out = step(params, opt_state, batch)
                torch.cuda.synchronize()
                record["step_s"].append(time.perf_counter() - t0)
            record["last"] = out
            return out
        return timed, opt

    record.update(step_s=[], last=None)
    with patched(train_mod, "make_train_step", wrapped) as real:
        yield


# the range around a train step's clip and AdamW update (``launch/
# steps.py``: ``global_norm``, ``update_in_place``) in a profiled step
OPTIMIZER_RANGE = "optimizer"


def profiled_step(fn, groups):
    """``fn()`` (one train step of ``make_train_step``) under
    ``torch.profiler`` (CUDA kernels and the CPU ops that launched them,
    the clip and AdamW update inside ``OPTIMIZER_RANGE``), read by
    ``step_profile``.  Returns (``fn()``, the profile)."""
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.launch import steps as steps_mod

    def in_range(f):
        def call(*args, **kw):
            with torch.profiler.record_function(OPTIMIZER_RANGE):
                return f(*args, **kw)
        return call

    with torch.profiler.profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=True) as prof, \
            patched(steps_mod, "global_norm",
                    in_range(steps_mod.global_norm)), \
            patched(steps_mod, "update_in_place",
                    in_range(steps_mod.update_in_place)):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    profile = step_profile(prof, wall, groups=groups)
    profile["reading_s"] = time.perf_counter() - t1
    return out, profile

# kernel name (lower case) -> group of a profiled train step, first
# match wins; kernels launched inside OPTIMIZER_RANGE are "optimizer";
# cuBLAS names its bf16 GEMM kernels on the H100 "nvjet_*"
STEP_GROUPS = (
    ("k4_dq", ("fa_bwd_dq", "fa_bwd_tc_dq")),
    ("k4_dkdv", ("fa_bwd_dkdv", "fa_bwd_tc_dkdv")),
    ("k4_fwd", ("flash_attention", "fa_fwd")),
    ("k5_bwd", ("ssm_scan_bwd",)),
    ("k5_fwd", ("ssm_scan_kernel", "ssm_step_kernel")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet")),
    ("elementwise", ("elementwise", "reduce")),
)


# the MoE train step's groups: the dispatch's sorts, searches and
# gathers (and their index backward) apart from the other elementwise
# kernels; the embedding's gather and its backward fall in it too.  The
# expert einsums are ``aten::bmm`` (``op_s`` of the profile): their
# GEMM kernels are named as the attention projections' are.
MOE_STEP_GROUPS = STEP_GROUPS[:5] + (
    ("dispatch", ("sort", "searchsorted", "index", "gather", "scatter")),
) + STEP_GROUPS[5:]


def step_group(name: str, groups=STEP_GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def step_profile(prof, wall_s: float, top: int = 12, groups=STEP_GROUPS,
                 ops: bool = True) -> dict:
    """A finished ``torch.profiler`` run (a profiled train step), read from
    its raw events (the profiler's Python event tree took 3-8 s for a
    hymba step): every device kernel's time summed by name; a kernel
    whose launch lies inside an ``OPTIMIZER_RANGE`` range is
    "optimizer", the rest grouped by ``step_group``; each group's
    seconds, the seconds in which a kernel ran (``busy_s``, the union
    of their intervals), the ``top`` kernels by time; with ``ops`` (and
    host activity recorded with shapes) the ``top`` PyTorch ops by the
    device time of the kernels they launched themselves (the innermost
    op around each launch, on its thread), with their input shapes (who
    calls the kernels), and the same by op name alone (``op_s``).  The
    device-side span of a ``record_function`` range is not a kernel and
    is left out.  ``wall_s`` is the profiled step's host time (the
    profiler's own cost included)."""
    from torch.autograd import DeviceType
    kernels, launches, cpu_ops, ranges = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and name != OPTIMIZER_RANGE:
                kernels.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                                name))
        elif e.is_user_annotation():
            if name == OPTIMIZER_RANGE:
                ranges.append((e.start_ns(), e.end_ns()))
        elif name.startswith("cu") and "::" not in name:
            # the CUDA API calls (cudaLaunchKernel, cuLaunchKernel, ...)
            launches.append((e.start_thread_id(), e.start_ns(),
                             e.correlation_id()))
        elif ops:
            cpu_ops.append((e.start_thread_id(), e.start_ns(), e.end_ns(),
                            name, str(e.shapes())))
    if not kernels:
        fail("step_profile: the profiler saw no device activity")
    launched_at = {corr: at for _, at, corr in launches}
    # each launch's innermost enclosing op on its thread: ops nest, so a
    # sweep in time order with a stack of the open ones finds it
    owner, timeline = {}, {}
    for i, (tid, a, b, _, _) in enumerate(cpu_ops):
        timeline.setdefault(tid, []).append((a, 0, -b, i))
    for tid, a, corr in launches:
        timeline.setdefault(tid, []).append((a, 1, 0, corr))
    for items in timeline.values():
        items.sort()
        stack = []
        for at, kind, _, ref in items:
            while stack and cpu_ops[stack[-1]][2] < at:
                stack.pop()
            if kind == 0:
                stack.append(ref)
            elif stack:
                owner[ref] = stack[-1]
    table = groups
    groups = {g: 0 for g, _ in table}
    groups.update(optimizer=0, other=0)
    by_name, group_of, op_ns = {}, {}, {}
    for start, end, corr, name in kernels:
        ns = end - start
        by_name[name] = by_name.get(name, 0) + ns
        at = launched_at.get(corr)
        if at is not None and any(a <= at <= b for a, b in ranges):
            groups["optimizer"] += ns
        else:
            if name not in group_of:
                group_of[name] = step_group(name, table)
            groups[group_of[name]] += ns
        i = owner.get(corr)
        if i is not None:
            key = cpu_ops[i][3:]
            op_ns[key] = op_ns.get(key, 0) + ns
    calls = {}
    for op in cpu_ops:
        calls[op[3:]] = calls.get(op[3:], 0) + 1
    op_s = {}
    for (name, _), ns in op_ns.items():
        op_s[name] = op_s.get(name, 0.0) + ns / 1e9
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    top_ops = sorted(op_ns.items(), key=lambda kv: -kv[1])[:top]
    return {"profiled_wall_s": wall_s, "kernels": len(kernels),
            "device_s": sum(by_name.values()) / 1e9,
            "busy_s": union_s((a, b) for a, b, _, _ in kernels) / 1e9,
            "groups_s": {g: ns / 1e9 for g, ns in groups.items()},
            "optimizer_ranges": len(ranges),
            "top": [{"name": n[:120], "s": ns / 1e9,
                     "group": step_group(n, table)} for n, ns in ranked],
            "op_s": dict(sorted(op_s.items(), key=lambda kv: -kv[1])[:top]),
            "top_ops": [{"op": name, "shapes": shapes[:160],
                         "calls": calls[(name, shapes)], "s": ns / 1e9}
                        for (name, shapes), ns in top_ops]}


def with_step_shares(profile: dict, warm_s: float) -> dict:
    """``step_profile``'s seconds as shares of the unprofiled warm step
    (``warm_s``, the median of the timed steps): each group's, the
    device's busy share, and the top kernels'."""
    return {**profile, "warm_s_per_step": warm_s,
            "device_busy_share": profile["device_s"] / warm_s,
            "groups_share_of_step": {g: v / warm_s for g, v in
                                     profile["groups_s"].items()},
            "top": [{**t, "share_of_step": t["s"] / warm_s}
                    for t in profile["top"]]}


def union_s(spans) -> float:
    """Length of the union of ``(start, end)`` intervals, in their unit."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def kernel_profile(fn, groups=STEP_GROUPS, top=8):
    """``fn()`` under ``torch.profiler`` recording the device alone (for
    runs of ~10^5 host-bound ops: the profiler's cost on the host kept
    low, no op table, no optimizer split), read by ``step_profile``: the
    wall s (the profiler's cost included), the device time by group,
    the busy seconds and their share of the wall time, the ``top``
    kernels.  Returns (``fn()``, the profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    reading = step_profile(prof, wall, top, groups, ops=False)
    del reading["op_s"], reading["top_ops"]
    return out, {**reading, "busy_share": reading["busy_s"] / wall,
                 "reading_s": time.perf_counter() - t1}


# launch.train's corpus, (args, kwargs) -> the tokens or their pending
# result: the reference's generator takes one ``rng.choice`` over the
# whole vocabulary a quarter of its tokens (~40 s for hymba's 32,001,
# ~95 s for llama's 128,256 at 400,000 tokens), so ``start_corpora``
# makes them in worker processes while the earlier phases run
_CORPORA = {}
TRAIN_CORPUS_TOKENS = 400_000


def start_corpora():
    """Start making ``launch.train``'s corpus for each arch of
    ``LM_TRAIN`` and for the reduced llama of ``mesh_train_cli``
    (``make_token_dataset(vocab, 400,000, seed=0)``, as the CLI calls
    it), one spawned worker each; returns the pool, which the caller
    terminates."""
    import multiprocessing
    from repro_torch.config import get_arch
    from repro_torch.data.synthetic import make_token_dataset
    vocabs = sorted({get_arch(arch).vocab_size for arch, _, _ in LM_TRAIN}
                    | {get_arch(MESH_TRAIN[0]).reduced().vocab_size})
    pool = multiprocessing.get_context("spawn").Pool(len(vocabs))
    for v in vocabs:
        key = ((v, TRAIN_CORPUS_TOKENS), (("seed", 0),))
        _CORPORA[key] = pool.apply_async(make_token_dataset,
                                         key[0], dict(key[1]))
    return pool


def _cached_corpus(real):
    """``make_token_dataset`` made once per argument set in this process,
    or taken from ``start_corpora``'s workers: a repeated run needs the
    same tokens."""
    def corpus(*args, **kw):
        key = (args, tuple(sorted(kw.items())))
        if key not in _CORPORA:
            _CORPORA[key] = real(*args, **kw)
        elif hasattr(_CORPORA[key], "get"):
            _CORPORA[key] = _CORPORA[key].get(timeout=600)
        return _CORPORA[key]
    return corpus


def _train_run(arch, b, s, profile=False):
    """``python -m repro_torch.launch.train --full`` in-process for
    ``LM_TRAIN_STEPS + PROFILED_STEPS`` steps, with the launch counts
    read around it; with ``profile`` the last step is profiled
    (``recording_train_steps``)."""
    import torch
    from repro_torch.launch import train as train_mod
    record = {}
    argv = ["--arch", arch, "--full", "--batch", str(b), "--seq", str(s),
            "--steps", str(LM_TRAIN_STEPS + PROFILED_STEPS),
            "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    with recording_train_steps(record, profile), patched(
            train_mod, "make_token_dataset",
            _cached_corpus(train_mod.make_token_dataset)):
        zero_counts()
        t0 = time.perf_counter()
        losses = train_mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
    return {"losses": losses, "wall_s": wall, "launches": launched,
            "step_s": record["step_s"], "last": record["last"],
            "profile": record.get("profile"), "start_bytes": start_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def lm_block_grads_vs_plain(dtype=None, arch="hymba-1.5b", softcap=0.0):
    """One full-width block of ``arch`` (hymba-1.5b by default; random
    weights from seed 0 in ``dtype``, f32 by default, a random (1, 2048,
    d_model) input, a random cotangent; with ``softcap`` > 0 the config's
    ``attn_logit_softcap``): every parameter's and the input's gradient
    through the kernels (K4 banded or chunked, K5 where the block has an
    SSM; forward and backward, of that dtype; the capped ones with a
    cap) against the same with the plain twins patched in for both
    (autograd of ``gqa_plain`` and ``ssm_scan_plain``), each leaf within
    ``BLOCK_GRAD_RTOL`` (f32) or ``BLOCK_GRAD_BF16_RTOL`` (bf16) of its
    largest |gradient|.  With a cap, the cap must bite: the plain twins'
    gradients without it are more than 100x ``BLOCK_GRAD_RTOL`` of each
    leaf's largest |gradient| away, in either dtype (bf16's own
    tolerance x 100 is 2.0, more than a cap moves any leaf)."""
    import dataclasses
    import torch
    from repro_torch.config import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import init_model
    from repro_torch.models.transformer import _block_apply, _layer
    from repro_torch.tree import tree_flatten, tree_unflatten
    dtype = dtype or torch.float32
    bf16 = int(dtype == torch.bfloat16)
    rtol = BLOCK_GRAD_BF16_RTOL if bf16 else BLOCK_GRAD_RTOL
    cfg = dataclasses.replace(get_arch(arch), num_layers=1,
                              attn_logit_softcap=softcap)
    hybrid = int(cfg.family == "hybrid")
    gen = torch.Generator(device="cuda").manual_seed(0)
    block = _layer(init_model(cfg, gen, dtype=dtype)["blocks"], 0)
    x = torch.randn(1, 2048, cfg.d_model, generator=gen,
                    device="cuda").to(dtype)
    cot = torch.randn(1, 2048, cfg.d_model, generator=gen,
                      device="cuda").to(dtype)
    positions = torch.arange(2048, device="cuda")[None]

    def grads(c=cfg):
        leaves, treedef = tree_flatten(block)
        leaves = [l.detach().requires_grad_(True) for l in leaves] + \
            [x.detach().requires_grad_(True)]
        y, _ = _block_apply(tree_unflatten(treedef, leaves[:-1]), c,
                            leaves[-1], positions, window=c.sliding_window,
                            chunk_q=128, chunk_kv=128, ssm_chunk=256,
                            moe_group=0)
        g = torch.autograd.grad(y, leaves, cot)
        torch.cuda.synchronize()
        return g

    zero_counts()
    got = grads()
    launched = counts()
    capped = int(softcap > 0)
    want_launches = only(flash_attention=1, flash_attention_tc=bf16,
                         flash_attention_softcap=capped,
                         flash_attention_bwd_dq=1,
                         flash_attention_bwd_dkdv=1,
                         flash_attention_bwd_dq_bf16=bf16,
                         flash_attention_bwd_dkdv_bf16=bf16,
                         flash_attention_softcap_bwd=2 * capped,
                         ssm_scan=hybrid, ssm_scan_bwd=hybrid,
                         ssm_scan_bwd_bf16=bf16 * hybrid)
    if launched != want_launches:
        fail(f"block gradients: launches {launched}, expected "
             f"{want_launches}")
    with patched(kernel_ops, "gqa_flash_attention", fa.gqa_plain), \
            patched(ss, "ssm_scan", ss.ssm_scan_plain):
        zero_counts()
        want = grads()
        uncapped = grads(dataclasses.replace(cfg, attn_logit_softcap=0.0)) \
            if capped else None
        if counts() != only():
            fail(f"block gradients: the plain run launched {counts()}")
    names = [".".join(k) for k in _leaf_names(block)] + ["x"]
    worst, bites = {}, {}
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        worst[name] = err / max(scale, 1e-30)
        if not bool(torch.isfinite(a).all()) or scale == 0.0 \
                or err > rtol * scale:
            fail(f"block gradients ({dtype}): {name} max abs err {err} "
                 f"against max |grad| {scale} (rtol {rtol})")
        if capped:
            bites[name] = float((uncapped[i].float() - b.float()).abs()
                                .max()) / scale
            if bites[name] <= 100 * BLOCK_GRAD_RTOL:
                fail(f"block gradients ({dtype}, cap {softcap}): the cap "
                     f"moves {name} by {bites[name]} of its largest "
                     f"|gradient| only")
    out = {"arch": f"{arch} (one block)", "b": 1, "s": 2048,
           "dtype": str(dtype), "rtol_of_max": rtol, "launches": launched,
           "max_rel_err": max(worst.values()),
           "rel_err_by_leaf": worst}
    if capped:
        out.update(softcap=softcap, cap_moves_min_rel=min(bites.values()),
                   cap_moves_by_leaf=bites)
    return out


def _leaf_names(tree, prefix=()):
    """Key paths of a nested dict's leaves in ``tree_flatten`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_leaf_names(v, prefix + (k,)))
        else:
            out.append(prefix + (k,))
    return out


# hymba's f32 seeded repeat, cut in depth (the bf16 path repeats it at
# all 32 layers): two ``launch.train`` runs of LM_TRAIN_STEPS steps at
# this many layers
LM_REPEAT_LAYERS = 4


def _f32_repeat(arch, b, s):
    """``launch.train --full`` on ``arch`` cut to ``LM_REPEAT_LAYERS``
    layers, twice from its seed on the CLI's corpus: losses and every
    parameter and AdamW moment (``leaf_checksums``) bit for bit, each
    layer's K4 (and K5) forward and backward launched once a step."""
    from repro_torch.launch import train as train_mod
    with patched(train_mod, "make_token_dataset",
                 _cached_corpus(train_mod.make_token_dataset)):
        runs = [_cut_train(arch, LM_REPEAT_LAYERS, b, s, LM_TRAIN_STEPS,
                           TRAIN_CORPUS_TOKENS, profile=False)
                for _ in range(2)]
    n = LM_REPEAT_LAYERS * LM_TRAIN_STEPS
    want = only(flash_attention=n, flash_attention_bwd_dq=n,
                flash_attention_bwd_dkdv=n, ssm_scan=n, ssm_scan_bwd=n)
    if any(r["launches"] != want for r in runs):
        fail(f"lm_train_path {arch} repeat: launches "
             f"{[r['launches'] for r in runs]}, expected {want}")
    if runs[0]["losses"] != runs[1]["losses"] \
            or runs[0]["checksums"] != runs[1]["checksums"]:
        fail(f"lm_train_path {arch}: two seeded runs at "
             f"{LM_REPEAT_LAYERS} layers differ: {runs[0]['losses']} vs "
             f"{runs[1]['losses']}")
    return {"layers": LM_REPEAT_LAYERS, "steps": LM_TRAIN_STEPS,
            "losses": runs[0]["losses"], "bitwise_equal": True,
            "step_s": [r["step_s"] for r in runs]}


def cli_train_tcfg(s):
    """``launch.train``'s TrainConfig at sequence ``s`` (f32, no remat)."""
    from repro_torch.config.base import TrainConfig
    return TrainConfig(dtype="float32", remat=False,
                       attn_chunk_q=min(128, s), attn_chunk_kv=min(128, s))


def step_roofline(arch, b, s, tcfg, s_step, layers=None):
    """A timed train step against its compiler-free cost on one card
    (``roofline/cost.py: step_share`` on ``H100_SXM``): the step's
    bound and what binds it, ``mfu`` = model FLOPs / (s_step * 989e12)
    and ``bound_s / s_step``.  Arithmetic only: no chip time."""
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.config.base import InputShape
    from repro_torch.roofline.cost import step_share
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return step_share(cfg, InputShape(f"{arch}-train", s, b, "train"),
                      tcfg, s_step)


def lm_train_path():
    """``launch.train --full`` on each case of ``LM_TRAIN``, f32, 2
    timed steps and one profiled (``step_profile``): warm s/step,
    tokens/s, first step, peak memory, K4 and K5 forward and backward
    launches (each layer once a step), the profiled step's device time
    by group; hymba twice at ``LM_REPEAT_LAYERS`` layers, losses,
    parameters and moments bit for bit (``_f32_repeat``); and one
    full-width hymba block's gradients through the kernels against the
    plain twins."""
    import math
    import torch
    from repro_torch.config import get_arch
    runs, train_counts = [], {}
    for arch, b, s in LM_TRAIN:
        cfg = get_arch(arch)
        r = _train_run(arch, b, s, profile=True)
        layers_steps = cfg.num_layers * (LM_TRAIN_STEPS + PROFILED_STEPS)
        want = only(flash_attention=layers_steps,
                    flash_attention_bwd_dq=layers_steps,
                    flash_attention_bwd_dkdv=layers_steps,
                    **({"ssm_scan": layers_steps,
                        "ssm_scan_bwd": layers_steps}
                       if cfg.family == "hybrid" else {}))
        if r["launches"] != want:
            fail(f"lm_train_path {arch}: launches {r['launches']}, "
                 f"expected {want}")
        if not all(math.isfinite(x) for x in r["losses"]):
            fail(f"lm_train_path {arch}: losses {r['losses']}")
        row = {"arch": arch, "batch": b, "seq": s, "dtype": "float32",
               "optimizer": "adamw", "steps": LM_TRAIN_STEPS,
               "losses": r["losses"], "step_s": r["step_s"],
               "first_step_s": r["step_s"][0],
               "warm_s_per_step": statistics.median(r["step_s"][1:]),
               "peak_bytes": r["peak_bytes"],
               "allocated_before_bytes": r["start_bytes"],
               "wall_s": r["wall_s"],
               "launches": r["launches"],
               "launches_per_step": {
                   k: v // (LM_TRAIN_STEPS + PROFILED_STEPS)
                   for k, v in r["launches"].items()}}
        row["tokens_per_s"] = b * s / row["warm_s_per_step"]
        row["step_roofline"] = step_roofline(arch, b, s, cli_train_tcfg(s),
                                             row["warm_s_per_step"])
        row["profiled_step"] = with_step_shares(r["profile"],
                                                row["warm_s_per_step"])
        if arch == "hymba-1.5b":
            r = None
            row["repeat"] = _f32_repeat(arch, b, s)
        train_counts[arch] = row["launches_per_step"]
        runs.append(row)
        r = None
        torch.cuda.empty_cache()
    block = lm_block_grads_vs_plain()
    torch.cuda.empty_cache()
    return {"runs": runs, "block_grads_vs_plain": block}, train_counts


# bf16 training (the default ``TrainConfig()``: dtype bfloat16, remat
# "full", AdamW, clip 1.0) at LM_TRAIN's shapes, full width, all layers:
# steps a run (the first, then warm ones), each on its own random tokens
LM_BF16_STEPS = 2


def _bf16_train_run(arch, b, s, seed=0, profile=False, softcap=0.0,
                    steps=None):
    """``make_train_step(cfg, TrainConfig())`` on ``init_model(cfg,
    dtype=torch.bfloat16)`` parameters drawn on the card from ``seed``,
    ``steps`` (``LM_BF16_STEPS``) steps on random tokens from the same
    seed, each timed on the host between two synchronizes, with the
    launch counts and peak memory read around the run; with ``profile``
    one more step after those, under ``torch.profiler``
    (``profiled_step``: device time by group), its launches left out of
    the counts; with ``softcap`` the config's ``attn_logit_softcap``."""
    import dataclasses
    import torch
    from repro_torch.config import get_arch
    from repro_torch.config.base import TrainConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model
    steps = steps or LM_BF16_STEPS
    cfg = dataclasses.replace(get_arch(arch), attn_logit_softcap=softcap)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_model(cfg, gen, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size,
                           (steps + bool(profile), b, s),
                           generator=gen, device="cuda")
    tcfg = TrainConfig()
    step, opt = make_train_step(cfg, tcfg)
    state = opt.init(params)
    step_s, metrics = [], []
    zero_counts()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, {"tokens": tokens[i]})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append(m)
    launched = counts()
    prof = None
    if profile:
        (params, state, _), prof = profiled_step(
            lambda: step(params, state, {"tokens": tokens[-1]}), STEP_GROUPS)
    return {"tcfg": tcfg, "layers": cfg.num_layers, "profile": prof,
            "hybrid": cfg.family == "hybrid", "params": params,
            "state": state, "step_s": step_s, "launches": launched,
            "losses": [float(m["loss"]) for m in metrics],
            "grad_norms": [float(m["grad_norm"]) for m in metrics],
            "peak_bytes": torch.cuda.max_memory_allocated()}


def lm_bf16_train_path():
    """bf16 training on the card at full width and all layers: each case
    of ``LM_TRAIN`` through ``make_train_step(cfg, TrainConfig())`` (bf16
    parameters from ``init_model``; remat "full"), ``LM_BF16_STEPS``
    steps: warm s/step, tokens/s, first step, peak memory; the exact
    launches a step, gated (remat runs each layer's forward twice: K4's
    bf16 forward with lse 2 a layer, its bf16 dq and dkdv 1; hymba's K5
    forward 2 and bf16 backward 1); finite losses; hymba twice from the
    same seed, losses and every parameter and moment bit for bit;
    llama's step after the timed ones profiled (``profiled_step``:
    device time by group, shares of the warm step); and one full-width
    bf16 hymba block's gradients through the kernels against the plain
    twins (``lm_block_grads_vs_plain(bfloat16)``)."""
    import math
    import torch
    from repro_torch.tree import tree_leaves
    runs, per_step = [], {}
    for arch, b, s in LM_TRAIN:
        r = _bf16_train_run(arch, b, s, profile=arch == "llama3.2-1b")
        tcfg = r["tcfg"]
        if (tcfg.dtype, tcfg.remat, tcfg.remat_policy) != (
                "bfloat16", True, "full"):
            fail(f"lm_bf16_train_path: TrainConfig() is {tcfg}")
        if not all(t.dtype in (torch.bfloat16, torch.float32)
                   for t in tree_leaves(r["params"])) or not any(
                t.dtype == torch.bfloat16 for t in tree_leaves(r["params"])):
            fail(f"lm_bf16_train_path {arch}: parameter dtypes "
                 f"{sorted({str(t.dtype) for t in tree_leaves(r['params'])})}")
        n = r["layers"] * LM_BF16_STEPS
        want = only(flash_attention=2 * n, flash_attention_tc=2 * n,
                    flash_attention_bwd_dq=n, flash_attention_bwd_dkdv=n,
                    flash_attention_bwd_dq_bf16=n,
                    flash_attention_bwd_dkdv_bf16=n,
                    **({"ssm_scan": 2 * n, "ssm_scan_bwd": n,
                        "ssm_scan_bwd_bf16": n} if r["hybrid"] else {}))
        if r["launches"] != want:
            fail(f"lm_bf16_train_path {arch}: launches {r['launches']}, "
                 f"expected {want}")
        if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
            fail(f"lm_bf16_train_path {arch}: losses {r['losses']}, grad "
                 f"norms {r['grad_norms']}")
        row = {"arch": arch, "batch": b, "seq": s, "dtype": "bfloat16",
               "train_config": "TrainConfig() (remat full, AdamW, clip 1.0)",
               "layers": r["layers"], "steps": LM_BF16_STEPS,
               "losses": r["losses"], "grad_norms": r["grad_norms"],
               "step_s": r["step_s"], "first_step_s": r["step_s"][0],
               "warm_s_per_step": statistics.median(r["step_s"][1:]),
               "peak_bytes": r["peak_bytes"], "launches": r["launches"],
               "launches_per_step": {k: v // LM_BF16_STEPS
                                     for k, v in r["launches"].items()}}
        row["tokens_per_s"] = b * s / row["warm_s_per_step"]
        row["step_roofline"] = step_roofline(arch, b, s, tcfg,
                                             row["warm_s_per_step"],
                                             layers=r["layers"])
        if r["profile"] is not None:
            row["profiled_step"] = with_step_shares(r["profile"],
                                                    row["warm_s_per_step"])
        if arch == "hymba-1.5b":
            first = [t.clone() for t in tree_leaves((r["params"],
                                                     r["state"]))]
            losses = r["losses"]
            r = None
            torch.cuda.empty_cache()
            again = _bf16_train_run(arch, b, s)
            same = again["losses"] == losses and all(
                torch.equal(a, c) for a, c in zip(
                    first, tree_leaves((again["params"], again["state"]))))
            if not same:
                fail(f"lm_bf16_train_path {arch}: two seeded runs differ: "
                     f"{losses} vs {again['losses']}")
            row["second_run_bitwise_equal"] = True
            row["second_run_step_s"] = again["step_s"]
            del first, again
        per_step[arch] = row["launches_per_step"]
        runs.append(row)
        r = None
        torch.cuda.empty_cache()
    block = lm_block_grads_vs_plain(torch.bfloat16)
    torch.cuda.empty_cache()
    return {"runs": runs, "block_grads_vs_plain": block}, per_step


FL_LM_ARGV = ["--rounds", "2", "--seed", "0"]


def fl_lm_path():
    """``fl_train`` with its default arch (reduced llama3.2-1b) and with
    ``--arch hymba-1.5b`` (reduced: the SSM scan forward and backward),
    ``--arch mixtral-8x7b`` (reduced: the MoE dispatch and its backward)
    and ``--arch xlstm-350m`` (reduced: the mLSTM and the sLSTM's time
    loop), 2 rounds each, twice: equal histories; K1 launched, K5 for
    hymba; the attention at seq 128 takes the naive branch (no K4)."""
    from repro_torch.launch import fl_train
    out = []
    for extra in ([], ["--arch", "hymba-1.5b"], ["--arch", "mixtral-8x7b"],
                  ["--arch", "xlstm-350m"]):
        hists, launched, walls = [], [], []
        for _ in range(2):
            zero_counts()
            t0 = time.perf_counter()
            hists.append(fl_train.main(FL_LM_ARGV + extra).to_json())
            walls.append(time.perf_counter() - t0)
            launched.append(counts())
        arch = hists[0]["arch"]
        if hists[0] != hists[1] or launched[0] != launched[1]:
            fail(f"fl_lm_path {arch}: two seeded runs differ")
        c = launched[0]
        if c["fedagg"] < 1:
            fail(f"fl_lm_path {arch}: the rounds never aggregated through "
                 f"K1: {c}")
        hybrid = extra[1:] == ["hymba-1.5b"]
        if hybrid and (c["ssm_scan"] < 1 or c["ssm_scan_bwd"] < 1):
            fail(f"fl_lm_path {arch}: K5 forward/backward not launched: "
                 f"{c}")
        if not hybrid and (c["ssm_scan"] or c["ssm_scan_bwd"]):
            fail(f"fl_lm_path {arch}: K5 launched: {c}")
        if c["flash_attention"] or c["flash_attention_bwd_dq"]:
            fail(f"fl_lm_path {arch}: seq 128 should take the naive "
                 f"attention branch, K4 launched: {c}")
        out.append({"arch": arch, "argv": FL_LM_ARGV + extra,
                    "accuracy": hists[0]["accuracy"],
                    "times": hists[0]["times"], "wall_s": walls,
                    "launches": c, "two_runs_equal": True})
    return out


# ---------------------------------------------------------------------
# The MoE family and the wide heads at full width (K4 at D = 128, 192)
# ---------------------------------------------------------------------

# mixtral-8x7b serving: depth cut from 32 layers (2.9 GB of bf16 a
# layer: 32 do not fit in 80 GB) to MOE_LAYERS; the prefill of
# B = 2 x 4096 is two groups of TrainConfig().moe_group_tokens = 4096
# tokens (capacity 1280 slots an expert); decode: 4 requests, a 16-token
# prompt filled by decode steps, then 16 greedy steps
MOE_LAYERS = 8
MOE_PREFILL = (2, 4096)
MOE_SERVE_BATCH, MOE_SERVE_PROMPT, MOE_SERVE_GEN = 4, 16, 16
# arctic-480b: one layer (128 experts and the dense residual, ~26.8 GB
# of bf16), B = 1 x 2048 (one group: the 128-expert dispatch)
ARCTIC_LAYERS, ARCTIC_PREFILL = 1, (1, 2048)
# the repaired head dims in the bf16 prefill: phi4-mini (D = 128) at its
# full 32 layers, nemotron (D = 192, ~7 GB a layer) cut to 2, and the
# VLM chameleon-34b (D = 128, 64 q heads over 8 kv heads: a GQA group of
# 8; image tokens are ids of its 65,536-token vocabulary; 1.4 GB a
# layer) cut to 2 of 48
WIDE_PREFILL = (("phi4-mini-3.8b", None, 2, 4096),
                ("nemotron-4-340b", 2, 1, 4096),
                ("chameleon-34b", 2, 1, 4096))
# the f32 train step at D = 128: phi4-mini through launch.train's path,
# cut to WIDE_TRAIN_LAYERS (params, grads and AdamW's two moments: 16 B
# a parameter, 26 GB at 4 layers; 71 GB at 32 would not fit beside the
# activations), two timed steps and a third under torch.profiler on a
# corpus of WIDE_TRAIN_TOKENS from the CLI's generator (its 400,000 over
# a 200,064-token vocabulary take minutes of host time)
WIDE_TRAIN = ("phi4-mini-3.8b", 1, 2048)
WIDE_TRAIN_LAYERS, WIDE_TRAIN_STEPS, WIDE_TRAIN_TOKENS = 4, 2, 4096
# MoE consistency: mixtral in f32 at full width, 2 layers, capacity
# factor n_experts (no token dropped in any group), a 272-token prompt
# then 8 greedy tokens; S * S above 256 * 256 and attention chunks of 8
# put S = 272 and S + 8 on the chunked (kernel) route
MOE_CONSISTENCY_LAYERS, MOE_CONSISTENCY_S, MOE_CONSISTENCY_GEN = 2, 272, 8
MOE_CONSISTENCY_CHUNK = 8


def _kernel_runs(fn, cfg, shape, label, per_layer=1):
    """``fn()`` (a bf16 forward of ``cfg``) once, the launch counts read
    around it (``per_layer`` tensor-core K4 launches a layer -- one, or
    one a model shard on the context-parallel route -- and K5 once a
    layer for a hybrid, no other kernel) and the attention calls
    recorded (k/v not repeated, the config's head dim and mask), then
    ``LM_WARM_RUNS`` times warm.  Returns the first output (of
    ``shape``, finite, equal to a warm run's bit for bit), its seconds,
    the warm seconds, the launches and the calls."""
    import torch
    calls = []
    with recording_attention_calls(calls):
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = counts()
    want = only(flash_attention=cfg.num_layers * per_layer,
                flash_attention_tc=cfg.num_layers * per_layer,
                ssm_scan=cfg.num_layers if cfg.family == "hybrid" else 0)
    if launched != want:
        fail(f"{label}: launches {launched}, expected {want}")
    if any(kv[2] != cfg.n_kv_heads or q[3] != cfg.head_dim
           or causal != cfg.causal for q, kv, _, causal, *_ in calls):
        fail(f"{label}: the kernel was handed repeated k/v, another "
             f"head dim or another mask: {calls[:1]}")
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        fail(f"{label}: logits {tuple(out.shape)}, finite "
             f"{bool(torch.isfinite(out).all())}")
    warm = []
    for _ in range(LM_WARM_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fn()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    if not torch.equal(again, out):
        fail(f"{label}: a warm run's logits differ from the first's")
    return out, first_s, warm, launched, calls


def _prefill_run(cfg, params, b, s, tcfg, label):
    """``make_prefill_step`` on random tokens through ``_kernel_runs``:
    the attention calls, the first and warm seconds, and the
    last-position logits."""
    import torch
    from repro_torch.launch.steps import make_prefill_step
    step = make_prefill_step(cfg, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    logits, first_s, warm, launched, calls = _kernel_runs(
        lambda: step(params, {"tokens": toks}), cfg, (b, cfg.vocab_size),
        label)
    med = statistics.median(warm)
    return {"arch": cfg.arch_id, "num_layers": cfg.num_layers, "batch": b,
            "prompt_len": s, "head_dim": cfg.head_dim,
            "dtype": "torch.bfloat16", "param_bytes": _param_bytes(params),
            "first_run_s": first_s, "warm_s": warm, "warm_s_median": med,
            "prompt_tokens_per_s": b * s / med, "launches": launched,
            "greedy_tokens": logits.argmax(-1).tolist()}, calls[0]


def _fresh(arch, dtype, num_layers=None):
    """Full-width random parameters on the card (``_lm_params``) after
    the card's memory is released, timed; returns (cfg, params, init
    seconds)."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params = _lm_params(arch, dtype, num_layers)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def lm_moe_serve_path():
    """The MoE family served at full width in bf16: mixtral-8x7b cut to
    ``MOE_LAYERS`` (prefill of ``MOE_PREFILL`` through
    ``make_prefill_step`` with ``TrainConfig().moe_group_tokens``, then
    4 requests decoded through ``make_serve_step``), and arctic-480b cut
    to one layer (prefill): seconds, tokens/s, peak memory, K4's
    launches (the tensor-core kernel at D = 128 each layer of a prefill,
    none in decode).  Returns (the phase, the attention calls)."""
    import torch
    from repro_torch.config.base import InputShape, TrainConfig
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_decode_state
    from repro_torch.models.moe import capacity_for
    tcfg = TrainConfig()
    out, calls = {}, []
    torch.cuda.reset_peak_memory_stats()
    cfg, params, init_s = _fresh("mixtral-8x7b", torch.bfloat16, MOE_LAYERS)
    b, s = MOE_PREFILL
    row, call = _prefill_run(cfg, params, b, s, tcfg, "mixtral prefill")
    group = tcfg.moe_group_tokens
    row.update(init_s=init_s, moe_group_tokens=group,
               groups=b * s // group,
               capacity=capacity_for(group, cfg.top_k, cfg.n_experts,
                                     cfg.moe_capacity_factor))
    calls.append(("mixtral-8x7b", "chunked", call))
    cache_len = MOE_SERVE_PROMPT + MOE_SERVE_GEN
    shape = InputShape("serve", cache_len, MOE_SERVE_BATCH, "decode")
    step = make_serve_step(cfg, shape, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size,
                            (MOE_SERVE_BATCH, MOE_SERVE_PROMPT),
                            generator=gen, device="cuda")
    state = init_decode_state(cfg, MOE_SERVE_BATCH, cache_len,
                              dtype=torch.bfloat16, device="cuda")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MOE_SERVE_PROMPT):
        logits, state = step(params, state, {"tokens": prompts[:, i:i + 1]})
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    toks = []
    t0 = time.perf_counter()
    for _ in range(MOE_SERVE_GEN):
        toks.append(tok)
        logits, state = step(params, state, {"tokens": tok})
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_counts = counts()
    toks = torch.cat(toks, dim=1)
    if decode_counts != only() or state["pos"] != cache_len \
            or not bool(torch.isfinite(logits).all()):
        fail(f"mixtral decode: launches {decode_counts}, pos "
             f"{state['pos']}, finite {bool(torch.isfinite(logits).all())}")
    row.update(decode={
        "batch": MOE_SERVE_BATCH, "prompt_len": MOE_SERVE_PROMPT,
        "gen": MOE_SERVE_GEN, "prompt_fill_s": fill_s,
        "prompt_fill_tokens_per_s": MOE_SERVE_BATCH * MOE_SERVE_PROMPT
        / fill_s, "decode_s": decode_s,
        "decode_tokens_per_s": MOE_SERVE_BATCH * MOE_SERVE_GEN / decode_s,
        "s_per_decode_step": decode_s / MOE_SERVE_GEN,
        "launches": decode_counts, "sample_tokens": toks[0].tolist()})
    row["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["mixtral"] = row
    del params, state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, init_s = _fresh("arctic-480b", torch.bfloat16,
                                 ARCTIC_LAYERS)
    b, s = ARCTIC_PREFILL
    row, call = _prefill_run(cfg, params, b, s, tcfg, "arctic prefill")
    row.update(init_s=init_s, groups=1,
               capacity=capacity_for(b * s, cfg.top_k, cfg.n_experts,
                                     cfg.moe_capacity_factor),
               peak_bytes=torch.cuda.max_memory_allocated())
    calls.append(("arctic-480b", "chunked", call))
    out["arctic"] = row
    del params
    torch.cuda.empty_cache()
    return out, calls


def lm_wide_head_prefill(cp_prefills):
    """The bf16 prefill of the dense configs whose head dims K4 took in
    this slice (``WIDE_PREFILL``): phi4-mini at D = 128, nemotron at
    D = 192.  On the weights of an arch of ``MESH_CP_PREFILL`` also its
    context-parallel prefill (``mesh_cp_prefill``, into
    ``cp_prefills``).  Returns (rows, attention calls)."""
    import torch
    from repro_torch.config.base import TrainConfig
    rows, calls = [], []
    for arch, layers, b, s in WIDE_PREFILL:
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = _fresh(arch, torch.bfloat16, layers)
        row, call = _prefill_run(cfg, params, b, s, TrainConfig(),
                                 f"{arch} prefill")
        row.update(init_s=init_s, peak_bytes=torch.cuda.max_memory_allocated())
        rows.append(row)
        calls.append((arch, "chunked", call))
        if arch in MESH_CP_PREFILL:
            cp_prefills[arch] = mesh_cp_prefill(cfg, params, b, s)
        del params
        torch.cuda.empty_cache()
    return rows, calls


def lm_moe_consistency():
    """mixtral-8x7b in f32 at full width, ``MOE_CONSISTENCY_LAYERS``
    deep, capacity factor n_experts: the prefill step's last logits
    over a prompt of ``MOE_CONSISTENCY_S`` (K4), decode steps over the
    prompt and ``MOE_CONSISTENCY_GEN`` greedy tokens (each token its own
    MoE group), and one forward over prompt + generated tokens (K4):
    every decode logit against the forward's at its position, and the
    prefill's, within ``CONSISTENCY_ATOL``; the forward's greedy tokens
    equal the generated ones."""
    import dataclasses
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import decode_step, forward, init_decode_state
    cfg, params, init_s = _fresh("mixtral-8x7b", torch.float32,
                                 MOE_CONSISTENCY_LAYERS)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))
    n, g = MOE_CONSISTENCY_S, MOE_CONSISTENCY_GEN
    chunk = MOE_CONSISTENCY_CHUNK
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device="cuda")
    prefill = make_prefill_step(cfg, TrainConfig(attn_chunk_q=chunk,
                                                 attn_chunk_kv=chunk))
    zero_counts()
    pre = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_counts = counts()
    state = init_decode_state(cfg, 1, n + g, dtype=torch.float32,
                              device="cuda")
    zero_counts()
    t0 = time.perf_counter()
    for i in range(n):
        logits, state = decode_step(cfg, params, state, prompt[:, i:i + 1])
    dec = [logits[:, -1]]
    new = []
    for _ in range(g):
        new.append(torch.argmax(dec[-1], dim=-1)[:, None])
        logits, state = decode_step(cfg, params, state, new[-1])
        dec.append(logits[:, -1])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_counts = counts()
    full = torch.cat([prompt] + new, dim=1)
    zero_counts()
    fwd, _ = forward(cfg, params, {"tokens": full}, chunk_q=chunk,
                     chunk_kv=chunk)
    torch.cuda.synchronize()
    forward_counts = counts()
    want_fwd = fwd[0, n - 1:]                     # positions n-1 .. n+g-1
    dec = torch.cat(dec, dim=0)
    vs_forward = float((dec - want_fwd).abs().max())
    vs_prefill = float((pre[0] - dec[0]).abs().max())
    generated = torch.cat(new, 1)[0]
    same_tokens = bool(torch.equal(want_fwd[:-1].argmax(-1), generated))
    del params, state
    torch.cuda.empty_cache()
    for name, got in (("prefill", prefill_counts),
                      ("forward", forward_counts)):
        if got != only(flash_attention=cfg.num_layers):
            fail(f"moe consistency {name} launches {got}")
    if decode_counts != only():
        fail(f"moe consistency decode launches {decode_counts}")
    if vs_forward > CONSISTENCY_ATOL or vs_prefill > CONSISTENCY_ATOL \
            or not same_tokens:
        fail(f"moe consistency: decode vs forward {vs_forward}, vs prefill "
             f"{vs_prefill} (atol {CONSISTENCY_ATOL}), greedy tokens "
             f"equal {same_tokens}")
    return {"arch": cfg.arch_id, "num_layers": cfg.num_layers,
            "moe_capacity_factor": cfg.moe_capacity_factor,
            "dtype": "torch.float32", "prompt_len": n, "gen": g,
            "init_s": init_s, "decode_vs_forward_max_abs": vs_forward,
            "prefill_vs_decode_max_abs": vs_prefill,
            "atol": CONSISTENCY_ATOL, "greedy_tokens": generated.tolist(),
            "greedy_tokens_equal": True,
            "logits_max_abs": float(want_fwd.abs().max()),
            "decode_s": decode_s, "launches_prefill": prefill_counts,
            "launches_decode": decode_counts,
            "launches_forward": forward_counts}


def _cut_train(arch, num_layers, b, s, timed_steps, corpus_tokens,
               profile=True, groups=None):
    """``python -m repro_torch.launch.train --full --arch ARCH`` in-process,
    f32, AdamW, cut to ``num_layers`` (``get_arch`` patched) on a corpus
    ``corpus_tokens`` long from the CLI's generator: ``timed_steps``
    steps, then (with ``profile``) one more under ``torch.profiler``
    (``recording_train_steps``).  Returns the losses, step seconds, the
    profile, the launch counts, the wall and peak bytes, and
    ``checksums``: each leaf of the trained model and of AdamW's state
    as the sum of its f32 words read as integers (any flipped bit moves
    it), the run's last tensors then dropped."""
    import dataclasses
    import torch
    from repro_torch.config import get_arch
    from repro_torch.launch import train as train_mod

    def cut(name):
        return dataclasses.replace(get_arch(name), num_layers=num_layers)

    def corpus(vocab, n, seed=0):
        return real_corpus(vocab, corpus_tokens, seed=seed)

    real_corpus = train_mod.make_token_dataset
    record = {}
    steps = timed_steps + (1 if profile else 0)
    argv = ["--arch", arch, "--full", "--batch", str(b), "--seq", str(s),
            "--steps", str(steps), "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording_train_steps(record, profile=profile,
                               profile_after=timed_steps, groups=groups), \
            patched(train_mod, "get_arch", cut), \
            patched(train_mod, "make_token_dataset", corpus):
        zero_counts()
        t0 = time.perf_counter()
        losses = train_mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
    params, opt_state, _ = record.pop("last")
    checksums = leaf_checksums(params, opt_state)
    del params, opt_state
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": record["step_s"],
            "profile": record.get("profile"), "launches": launched,
            "wall_s": wall, "peak_bytes": peak, "steps": steps,
            "checksums": checksums}


def lm_wide_train_step():
    """``python -m repro_torch.launch.train --full --arch phi4-mini-3.8b``
    in-process, f32, AdamW, cut to ``WIDE_TRAIN_LAYERS`` and
    ``WIDE_TRAIN_STEPS`` steps (the corpus ``WIDE_TRAIN_TOKENS`` long):
    K4's f32 forward with lse, dq and dkdv at D = 128 once a layer a
    step; step seconds, tokens/s and peak memory; one more step under
    ``torch.profiler`` (``step_profile``, as ``lm_train_path``): the
    K4 groups' share of the step.  Returns (the phase, the per-step
    launches)."""
    import math
    from repro_torch.config import get_arch
    arch, b, s = WIDE_TRAIN
    r = _cut_train(arch, WIDE_TRAIN_LAYERS, b, s, WIDE_TRAIN_STEPS,
                   WIDE_TRAIN_TOKENS)
    n = WIDE_TRAIN_LAYERS * r["steps"]
    want = only(flash_attention=n, flash_attention_bwd_dq=n,
                flash_attention_bwd_dkdv=n)
    if r["launches"] != want:
        fail(f"lm_wide_train_step: launches {r['launches']}, expected "
             f"{want}")
    if not all(math.isfinite(x) for x in r["losses"]):
        fail(f"lm_wide_train_step: losses {r['losses']}")
    step_s = r["step_s"]
    return {"arch": arch, "num_layers": WIDE_TRAIN_LAYERS, "batch": b,
            "seq": s, "head_dim": get_arch(arch).head_dim,
            "dtype": "float32", "optimizer": "adamw",
            "corpus_tokens": WIDE_TRAIN_TOKENS, "losses": r["losses"],
            "step_s": step_s, "warm_s_per_step": step_s[-1],
            "tokens_per_s": b * s / step_s[-1], "wall_s": r["wall_s"],
            "step_roofline": step_roofline(arch, b, s, cli_train_tcfg(s),
                                           step_s[-1],
                                           layers=WIDE_TRAIN_LAYERS),
            "launches": r["launches"],
            "profiled_step": with_step_shares(r["profile"], step_s[-1]),
            "peak_bytes": r["peak_bytes"]}, {
        k: v // r["steps"] for k, v in r["launches"].items()}


# ---------------------------------------------------------------------
# MoE training at full width: K4's f32 kernels at D = 128 under the
# expert dispatch
# ---------------------------------------------------------------------

# mixtral-8x7b (d 4096, d_ff 14336, 8 experts, top-2, D = 128, window
# 4096 >= S) trained in f32 with AdamW through launch.train, cut from 32
# layers to MOE_TRAIN_LAYERS: 1,451.3 M parameters a layer and 262.1 M
# in the embedding and head, 16 B each with the gradient and AdamW's two
# moments: 50.6 GB at 2 layers (3 would be 73.9 GB before activations).
# B = 1 x 2048 is one MoE group (moe_group_tokens = 4096 does not divide
# 2048), capacity 640 slots an expert.  One whole run (MOE_TRAIN_STEPS
# timed steps and one profiled); the repeat that holds it to its seed is
# one block's gradients at the run's layer shape, twice (a second whole
# run would cost the seconds the host-bound xLSTM phases need)
MOE_TRAIN = ("mixtral-8x7b", 1, 2048)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_TOKENS = 2, 3, 8192
CARD_BYTES = 80e9


def moe_block_grads_repeat():
    """One full-width mixtral-8x7b block in f32 (random weights from seed
    0, a random (1, 2048, 4096) input and cotangent, the load-balance
    loss weighted 0.01 as in ``lm_loss``), at ``launch.train``'s
    attention chunks and ``TrainConfig().moe_group_tokens``: every
    parameter's and the input's gradient twice, through K4 (forward with
    lse, dq, dkdv) and the expert dispatch's backward (gathers whose
    indices repeat: empty slots and dropped tokens clamped), bit for
    bit."""
    import dataclasses
    import torch
    from repro_torch.config import get_arch
    from repro_torch.config.base import TrainConfig
    from repro_torch.models import init_model
    from repro_torch.models.transformer import _block_apply, _layer
    from repro_torch.tree import tree_flatten, tree_unflatten
    arch, b, s = MOE_TRAIN
    cfg = dataclasses.replace(get_arch(arch), num_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    block = _layer(init_model(cfg, gen)["blocks"], 0)
    x = torch.randn(b, s, cfg.d_model, generator=gen, device="cuda")
    cot = torch.randn(b, s, cfg.d_model, generator=gen, device="cuda")
    positions = torch.arange(s, device="cuda")[None]
    chunk = min(128, s)

    def grads():
        leaves, treedef = tree_flatten(block)
        leaves = [l.detach().requires_grad_(True) for l in leaves] + \
            [x.detach().requires_grad_(True)]
        y, aux = _block_apply(tree_unflatten(treedef, leaves[:-1]), cfg,
                              leaves[-1], positions,
                              window=cfg.sliding_window, chunk_q=chunk,
                              chunk_kv=chunk, ssm_chunk=256,
                              moe_group=TrainConfig().moe_group_tokens)
        g = torch.autograd.grad(
            (y, aux), leaves, (cot, torch.full((), 0.01, device="cuda")))
        torch.cuda.synchronize()
        return [aux.detach()] + list(g)

    zero_counts()
    t0 = time.perf_counter()
    first = grads()
    second = grads()
    seconds = time.perf_counter() - t0
    launched = counts()
    want = only(flash_attention=2, flash_attention_bwd_dq=2,
                flash_attention_bwd_dkdv=2)
    if launched != want:
        fail(f"moe block gradients: launches {launched}, expected {want}")
    differ = [i for i, (a, c) in enumerate(zip(first, second))
              if not torch.equal(a, c)]
    if differ or not all(bool(torch.isfinite(t).all()) for t in first):
        fail(f"moe block gradients: tensors {differ} differ between two "
             f"runs, or are not finite")
    n = len(first)
    del first, second, block
    torch.cuda.empty_cache()
    return {"arch": arch, "b": b, "s": s, "tensors": n,
            "bitwise_equal": True, "seconds": seconds,
            "launches": launched}


def lm_moe_train_step():
    """``launch.train --full --arch mixtral-8x7b`` (``MOE_TRAIN``, cut to
    ``MOE_TRAIN_LAYERS``): K4's f32 forward with lse, dq and dkdv once a
    layer a step, finite losses, peak under ``CARD_BYTES``; s/step,
    tokens/s, the first step, and the profiled step by group
    (``MOE_STEP_GROUPS``; the expert einsums as ``aten::bmm``); then
    ``moe_block_grads_repeat``.  Returns (the phase, the per-step
    launches)."""
    import math
    from repro_torch.config import get_arch
    from repro_torch.config.base import TrainConfig
    from repro_torch.models.moe import capacity_for
    arch, b, s = MOE_TRAIN
    cfg = get_arch(arch)
    r = _cut_train(arch, MOE_TRAIN_LAYERS, b, s, MOE_TRAIN_STEPS,
                   MOE_TRAIN_TOKENS, groups=MOE_STEP_GROUPS)
    n = MOE_TRAIN_LAYERS * r["steps"]
    want = only(flash_attention=n, flash_attention_bwd_dq=n,
                flash_attention_bwd_dkdv=n)
    if r["launches"] != want:
        fail(f"lm_moe_train_step: launches {r['launches']}, expected "
             f"{want}")
    if not all(math.isfinite(x) for x in r["losses"]):
        fail(f"lm_moe_train_step: losses {r['losses']}")
    if r["peak_bytes"] >= CARD_BYTES:
        fail(f"lm_moe_train_step: peak {r['peak_bytes']} B")
    step_s = r["step_s"]
    warm = statistics.median(step_s[1:])
    prof = with_step_shares(r["profile"], warm)
    prof["expert_einsums_s"] = prof["op_s"].get("aten::bmm", 0.0)
    group = TrainConfig().moe_group_tokens
    return {"arch": arch, "num_layers": MOE_TRAIN_LAYERS, "batch": b,
            "seq": s, "head_dim": cfg.head_dim, "dtype": "float32",
            "optimizer": "adamw", "corpus_tokens": MOE_TRAIN_TOKENS,
            "moe_group_tokens": group, "groups": 1,
            "capacity": capacity_for(b * s, cfg.top_k, cfg.n_experts,
                                     cfg.moe_capacity_factor),
            "losses": r["losses"], "step_s": step_s,
            "first_step_s": step_s[0], "warm_s_per_step": warm,
            "tokens_per_s": b * s / warm, "wall_s": r["wall_s"],
            "step_roofline": step_roofline(arch, b, s, cli_train_tcfg(s),
                                           warm, layers=MOE_TRAIN_LAYERS),
            "launches": r["launches"], "peak_bytes": r["peak_bytes"],
            "leaf_checksums": r["checksums"],
            "profiled_step": prof,
            "block_grads_repeat": moe_block_grads_repeat()}, {
        k: v // r["steps"] for k, v in r["launches"].items()}


# ---------------------------------------------------------------------
# The xLSTM family at full width (no kernel of the port on its path)
# ---------------------------------------------------------------------

# xlstm-350m: 12 stacked (mLSTM, sLSTM, GeLU MLP) pairs, d 1024, 4
# heads, vocab 50304.  The sLSTM is a Python loop of one step a token,
# ~22 PyTorch ops a layer a step (more with autograd): these phases are
# host-bound (14-19 us of host a kernel on an H100 machine: the card is
# busy 5-9 % of a prefill or a train step), and their lengths are cut
# to the script's time limit; a token costs the same host time at any
# length, as a pair does at any depth.  Serving in bf16, cut to
# XLSTM_SERVE_LAYERS (2 of 12 pairs): a
# prefill of XLSTM_PREFILL through make_prefill_step (one mLSTM chunk of
# 256), run twice, the second (warm) run under kernel_profile (device
# activity only: the card's busy share); then 4 requests decoded (a 16-token
# prompt filled by decode steps, then 16 greedy steps), twice
XLSTM = "xlstm-350m"
XLSTM_SERVE_LAYERS = 4
XLSTM_PREFILL = (2, 256)
XLSTM_SERVE_BATCH, XLSTM_SERVE_PROMPT, XLSTM_SERVE_GEN = 4, 16, 16
# f32 decode against the forward: 2 pairs at full width, S = 512, so
# that the forward's mLSTM crosses a chunk boundary (ssm_chunk 256); the
# reference's tolerance for this family
# (tests/test_decode_consistency.py)
XLSTM_CONSISTENCY_LAYERS, XLSTM_CONSISTENCY_S = 4, 512
XLSTM_DECODE_TOL = 2e-4
# training: f32 AdamW through launch.train, 2 pairs, B = 1 x 256 (one
# mLSTM chunk; the backward across chunks is held to jax.grad on the
# CPU), one timed step and a second read by kernel_profile (~7 x 10^4
# kernels a step; device activity only, so clip + AdamW's kernels fall
# in their kernels' groups)
XLSTM_TRAIN = (1, 256)
XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_STEPS, XLSTM_TRAIN_TOKENS = 4, 1, 4096


def lm_xlstm_serve_path():
    """xlstm-350m at full width (``XLSTM_SERVE_LAYERS``), bf16: the
    prefill of ``XLSTM_PREFILL`` through ``make_prefill_step`` (first
    run, then a warm run whose logits must equal it) and 4 requests
    decoded through
    ``make_serve_step``, twice (the same tokens and logits); no kernel
    of the port launched, finite logits; tokens/s, first-run s, peak,
    and the card's busy share in the warm prefill (``kernel_profile``,
    device activity only)."""
    import torch
    from repro_torch.config.base import InputShape, TrainConfig
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state
    torch.cuda.reset_peak_memory_stats()
    cfg, params, init_s = _fresh(XLSTM, torch.bfloat16, XLSTM_SERVE_LAYERS)
    b, s = XLSTM_PREFILL
    tcfg = TrainConfig()
    prefill = make_prefill_step(cfg, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    logits, prefill_prof = kernel_profile(
        lambda: prefill(params, {"tokens": toks}))
    warm_s = prefill_prof["profiled_wall_s"]
    prefill_counts = counts()
    if prefill_counts != only():
        fail(f"xlstm prefill launched {prefill_counts}")
    if tuple(logits.shape) != (b, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()) \
            or not torch.equal(first, logits):
        fail(f"xlstm prefill: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}, warm == first "
             f"{torch.equal(first, logits)}")
    prefill_tokens = logits.argmax(-1).tolist()

    cache_len = XLSTM_SERVE_PROMPT + XLSTM_SERVE_GEN
    shape = InputShape("serve", cache_len, XLSTM_SERVE_BATCH, "decode")
    step = make_serve_step(cfg, shape, tcfg)
    prompts = torch.randint(0, cfg.vocab_size,
                            (XLSTM_SERVE_BATCH, XLSTM_SERVE_PROMPT),
                            generator=gen, device="cuda")

    def serve():
        state = init_decode_state(cfg, XLSTM_SERVE_BATCH, cache_len,
                                  dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(XLSTM_SERVE_PROMPT):
            logits, state = step(params, state,
                                 {"tokens": prompts[:, i:i + 1]})
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out = []
        t0 = time.perf_counter()
        for _ in range(XLSTM_SERVE_GEN):
            out.append(tok)
            logits, state = step(params, state, {"tokens": tok})
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        return (fill_s, time.perf_counter() - t0, torch.cat(out, 1),
                logits, state["pos"])

    zero_counts()
    decodes = [serve(), serve()]
    decode_counts = counts()
    fill_s, decode_s, out, logits, pos = decodes[0]
    if decode_counts != only() or pos != cache_len \
            or not bool(torch.isfinite(logits).all()):
        fail(f"xlstm decode: launches {decode_counts}, pos {pos}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    if not (torch.equal(out, decodes[1][2])
            and torch.equal(logits, decodes[1][3])):
        fail("xlstm decode: two seeded runs differ")
    peak = torch.cuda.max_memory_allocated()
    param_bytes = _param_bytes(params)
    del params
    torch.cuda.empty_cache()
    n_dec = XLSTM_SERVE_BATCH * XLSTM_SERVE_GEN
    return {"arch": cfg.arch_id, "num_layers": cfg.num_layers,
            "pairs": cfg.num_layers // 2, "dtype": "torch.bfloat16",
            "param_bytes": param_bytes,
            "init_s": init_s,
            "prefill": {"batch": b, "prompt_len": s, "ssm_chunk": 256,
                        "first_run_s": first_s, "warm_s": warm_s,
                        "prompt_tokens_per_s": b * s / warm_s,
                        "warm_run": "under kernel_profile, device "
                                    "activity only",
                        "launches": prefill_counts,
                        "busy": prefill_prof,
                        "greedy_tokens": prefill_tokens},
            "decode": {"batch": XLSTM_SERVE_BATCH,
                       "prompt_len": XLSTM_SERVE_PROMPT,
                       "gen": XLSTM_SERVE_GEN, "prompt_fill_s": fill_s,
                       "prompt_fill_tokens_per_s": XLSTM_SERVE_BATCH
                       * XLSTM_SERVE_PROMPT / fill_s,
                       "decode_s": decode_s,
                       "decode_tokens_per_s": n_dec / decode_s,
                       "s_per_decode_step": decode_s / XLSTM_SERVE_GEN,
                       "second_run_decode_s": decodes[1][1],
                       "launches": decode_counts,
                       "two_runs_equal": True,
                       "sample_tokens": out[0].tolist()},
            "peak_bytes": peak}


def lm_xlstm_consistency():
    """xlstm-350m in f32 at full width, ``XLSTM_CONSISTENCY_LAYERS``
    deep: decoding a prompt of ``XLSTM_CONSISTENCY_S`` one token at a
    time through the mLSTM memory, its conv state and the sLSTM state
    against one forward over the prompt (two mLSTM chunks of 256): every
    position's logits within ``XLSTM_DECODE_TOL`` (rtol and atol), no
    kernel of the port launched."""
    import torch
    from repro_torch.models import decode_step, forward, init_decode_state
    cfg, params, init_s = _fresh(XLSTM, torch.float32,
                                 XLSTM_CONSISTENCY_LAYERS)
    n = XLSTM_CONSISTENCY_S
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device="cuda")
    zero_counts()
    t0 = time.perf_counter()
    full, _ = forward(cfg, params, {"tokens": prompt}, ssm_chunk=256)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    state = init_decode_state(cfg, 1, n, dtype=torch.float32, device="cuda")
    outs = []
    t0 = time.perf_counter()
    for i in range(n):
        logits, state = decode_step(cfg, params, state, prompt[:, i:i + 1])
        outs.append(logits[:, 0])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launched = counts()
    dec = torch.stack(outs, 1)
    err = (dec - full).abs()
    bound = XLSTM_DECODE_TOL + XLSTM_DECODE_TOL * full.abs()
    worst = float((err / bound).max())
    max_abs = float(err.max())
    del params, state, full, dec
    torch.cuda.empty_cache()
    if launched != only():
        fail(f"xlstm consistency: launches {launched}")
    if not worst <= 1.0:
        fail(f"xlstm consistency: decode vs forward max abs {max_abs}, "
             f"{worst} of the tolerance (rtol = atol = "
             f"{XLSTM_DECODE_TOL})")
    return {"arch": cfg.arch_id, "num_layers": cfg.num_layers,
            "pairs": cfg.num_layers // 2, "dtype": "torch.float32",
            "prompt_len": n, "ssm_chunk": 256, "init_s": init_s,
            "decode_vs_forward_max_abs": max_abs,
            "share_of_tolerance": worst, "rtol": XLSTM_DECODE_TOL,
            "atol": XLSTM_DECODE_TOL, "forward_s": forward_s,
            "decode_s": decode_s, "decode_tokens_per_s": n / decode_s,
            "launches": launched}


def lm_xlstm_train_step():
    """``launch.train --full --arch xlstm-350m`` in-process, f32 AdamW,
    cut to ``XLSTM_TRAIN_LAYERS`` (2 pairs), B x S = ``XLSTM_TRAIN``:
    ``XLSTM_TRAIN_STEPS`` timed step(s) and one more under
    ``kernel_profile`` (device time by group, the card's busy share);
    no kernel of the port launched, finite losses; s/step, tokens/s,
    peak."""
    import math
    b, s = XLSTM_TRAIN
    r = _cut_train(XLSTM, XLSTM_TRAIN_LAYERS, b, s, XLSTM_TRAIN_STEPS,
                   XLSTM_TRAIN_TOKENS, profile="kernels")
    if r["launches"] != only():
        fail(f"lm_xlstm_train_step: launches {r['launches']}")
    if not all(math.isfinite(x) for x in r["losses"]):
        fail(f"lm_xlstm_train_step: losses {r['losses']}")
    # the timed step is the first: the step is host-bound, and the
    # allocator's first-step work is small beside its host time
    step_s = r["step_s"]
    warm = step_s[-1]
    return {"arch": XLSTM, "num_layers": XLSTM_TRAIN_LAYERS,
            "pairs": XLSTM_TRAIN_LAYERS // 2, "batch": b, "seq": s,
            "ssm_chunk": 256, "dtype": "float32", "optimizer": "adamw",
            "corpus_tokens": XLSTM_TRAIN_TOKENS, "losses": r["losses"],
            "step_s": step_s, "s_per_step": warm,
            "tokens_per_s": b * s / warm,
            "wall_s": r["wall_s"], "launches": r["launches"],
            "peak_bytes": r["peak_bytes"],
            "profiled_step": with_step_shares(r["profile"], warm)}


# ---------------------------------------------------------------------
# The audio family at full width: hubert-xlarge, an encoder over frames
# (K4 at D = 80, non-causal)
# ---------------------------------------------------------------------

# hubert-xlarge: 48 layers, d 1280, 16 heads of D = 80 (MHA), d_ff 5120,
# GeLU, causal=False and no window (attention takes the chunked route:
# one K4 launch a layer), 504 k-means targets; 945 M parameters.  Its
# batch is frames (B, S, d_model) in place of tokens, and for training
# per-frame labels.  Encoding in bf16 at all 48 layers, B = 8 x 1024
# frames (eight utterances of about 20 s at HuBERT's 50 frames a
# second), through models.forward (the per-frame logits, the encoder's
# output) and make_prefill_step (the last frame's); training in f32
# with AdamW through make_train_step (launch.train and fl_train feed
# token batches), all 48 layers (15.1 GB of parameters, gradient and
# moments), B = 2 x 1024: the first step, AUDIO_TRAIN_STEPS timed ones
# and one under torch.profiler, then the same steps again from the same
# seeds for the checksums
AUDIO = "hubert-xlarge"
AUDIO_ENCODE = (8, 1024)
AUDIO_TRAIN = (2, 1024)
AUDIO_TRAIN_STEPS = 2


def _audio_batch(cfg, b, s, dtype, seed, labels=False):
    """Frames (B, S, d_model) of ``dtype`` drawn on the card from
    ``seed``, and with ``labels`` per-frame targets (B, S)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"frames": torch.randn(b, s, cfg.d_model, generator=gen,
                                   device="cuda").to(dtype)}
    if labels:
        batch["labels"] = torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=gen, device="cuda")
    return batch


def lm_audio_encode_path():
    """hubert-xlarge encoding in bf16 at full width and depth
    (``AUDIO_ENCODE``): ``models.forward`` (per-frame logits) and
    ``make_prefill_step`` (the last frame's logits), each once with
    the launch counts read around it (48 K4 launches, all on the
    tensor-core kernel) and ``LM_WARM_RUNS`` times warm, equal to the
    first run bit for bit: seconds, frames/s, peak bytes.  Returns (the
    phase, the attention calls)."""
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import forward
    torch.cuda.reset_peak_memory_stats()
    cfg, params, init_s = _fresh(AUDIO, torch.bfloat16)
    b, s = AUDIO_ENCODE
    tcfg = TrainConfig()
    batch = _audio_batch(cfg, b, s, torch.bfloat16, seed=5)
    prefill = make_prefill_step(cfg, tcfg)

    def encode():
        return forward(cfg, params, batch, chunk_q=tcfg.attn_chunk_q,
                       chunk_kv=tcfg.attn_chunk_kv)[0]

    out = {"arch": AUDIO, "num_layers": cfg.num_layers, "batch": b,
           "frames": s, "head_dim": cfg.head_dim, "dtype": "torch.bfloat16",
           "init_s": init_s, "param_bytes": _param_bytes(params)}
    for name, fn, shape in (("forward", encode, (b, s, cfg.vocab_size)),
                            ("prefill_step", lambda: prefill(params, batch),
                             (b, cfg.vocab_size))):
        logits, first_s, warm, launched, calls = _kernel_runs(
            fn, cfg, shape, f"hubert {name}")
        med = statistics.median(warm)
        out[name] = {"first_run_s": first_s, "warm_s": warm,
                     "warm_s_median": med, "frames_per_s": b * s / med,
                     "launches": launched,
                     "logits_shape": list(logits.shape)}
        del logits
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    return out, [(AUDIO, "chunked", calls[0])]


def leaf_checksums(*trees):
    """Each f32 leaf of the trees as the sum of its words read as
    integers (any flipped bit moves it)."""
    import torch
    from repro_torch.tree import tree_leaves
    return [int(t.contiguous().view(torch.int32).sum(dtype=torch.int64))
            for tree in trees for t in tree_leaves(tree)
            if t.dtype == torch.float32]


def _audio_train_run(cfg, profile_at=None):
    """``make_train_step`` (f32, AdamW, ``launch.train``'s TrainConfig)
    on hubert-xlarge at full width from seed 0, ``AUDIO_TRAIN_STEPS +
    2`` steps on batches from seeds 100, 101, ...; the step
    ``profile_at`` under ``profiled_step``.  Returns the losses, the
    seconds of the other steps, the profile, the launch counts, the
    peak bytes and the checksums of the trained parameters and AdamW's
    state."""
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model
    b, s = AUDIO_TRAIN
    tcfg = TrainConfig(dtype="float32", lr=3e-4, remat=False,
                       attn_chunk_q=min(128, s), attn_chunk_kv=min(128, s))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(cfg, gen, torch.float32)
    step, opt = make_train_step(cfg, tcfg)
    opt_state = opt.init(params)
    losses, step_s, profile = [], [], None
    zero_counts()
    for i in range(AUDIO_TRAIN_STEPS + 2):
        batch = _audio_batch(cfg, b, s, torch.float32, seed=100 + i,
                             labels=True)
        torch.cuda.synchronize()
        if i == profile_at:
            (params, opt_state, metrics), profile = profiled_step(
                lambda: step(params, opt_state, batch), STEP_GROUPS)
        else:
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launched = counts()
    sums = leaf_checksums(params, opt_state)
    del params, opt_state
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": step_s, "profile": profile,
            "launches": launched, "peak_bytes": peak, "checksums": sums}


def lm_audio_train_step():
    """hubert-xlarge trained in f32 with AdamW at full width and depth
    (``AUDIO_TRAIN``): the first step, ``AUDIO_TRAIN_STEPS`` timed steps
    and one profiled (device time by group); K4's forward with lse, dq
    and dkdv exactly once a layer a step; finite losses; the same steps
    again from the same seeds with equal checksums of the parameters and
    moments.  Returns (the phase, the per-step launches)."""
    import math
    from repro_torch.config import get_arch
    cfg = get_arch(AUDIO)
    b, s = AUDIO_TRAIN
    steps = AUDIO_TRAIN_STEPS + 2
    first = _audio_train_run(cfg, profile_at=steps - 1)
    again = _audio_train_run(cfg)
    n = cfg.num_layers * steps
    want = only(flash_attention=n, flash_attention_bwd_dq=n,
                flash_attention_bwd_dkdv=n)
    for r in (first, again):
        if r["launches"] != want:
            fail(f"lm_audio_train_step: launches {r['launches']}, "
                 f"expected {want}")
        if not all(math.isfinite(x) for x in r["losses"]):
            fail(f"lm_audio_train_step: losses {r['losses']}")
    if first["checksums"] != again["checksums"] \
            or first["losses"] != again["losses"]:
        fail("lm_audio_train_step: two seeded runs differ")
    warm = statistics.median(first["step_s"][1:])
    return {"arch": AUDIO, "num_layers": cfg.num_layers, "batch": b,
            "frames": s, "head_dim": cfg.head_dim, "dtype": "float32",
            "optimizer": "adamw", "losses": first["losses"],
            "step_s": first["step_s"], "first_step_s": first["step_s"][0],
            "warm_s_per_step": warm, "frames_per_s": b * s / warm,
            "step_roofline": step_roofline(AUDIO, b, s, cli_train_tcfg(s),
                                           warm),
            "repeat_step_s": again["step_s"],
            "launches": first["launches"],
            "peak_bytes": first["peak_bytes"],
            "two_runs_equal": True,
            "leaf_checksums": first["checksums"][:8],
            "profiled_step": with_step_shares(first["profile"], warm)}, {
        k: v // steps for k, v in first["launches"].items()}


# ---------------------------------------------------------------------
# The LM mesh: context-parallel attention, one K4 launch a model shard
# ---------------------------------------------------------------------

# The bf16 prefills under a ("data", "model") mesh of virtual shards of
# the card: (mesh shape, TrainConfig.context_parallel, the branch the
# dispatch must take).  phi4-mini's 24 heads do not divide a 16-way
# model axis, so "auto" takes chunked_attention_cp (4096 / 512 = 8
# chunks shrink to 16 of 256 rows); hymba's banded window of 1024 is
# wider than its 512-row chunks, so only "always" takes
# banded_attention_cp (4 shards of 1024 rows)
MESH_CP_PREFILL = {"phi4-mini-3.8b": ((1, 16), "auto", "chunked_cp"),
                   "hymba-1.5b": ((1, 4), "always", "banded_cp")}
# the f32 training step under a (1, 4) mesh with "always": llama's 32
# heads divide the axis, so only "always" takes chunked_attention_cp
# (4 shards of 512 rows at q_offset 0, 512, 1024, 1536)
MESH_TRAIN = ("llama3.2-1b", (1, 4), 2, 2048)
# its loss and each gradient leaf against the step without the mesh
# (one launch over all rows): each row's forward and dq come from the
# same kernel on the same keys; dk and dv are autograd's sum over the 4
# shards' dkdv launches, another order of the same f32 sum; an error
# relative to the leaf's largest |g|
MESH_GRAD_RTOL = 1e-4
MESH_LOSS_RTOL = 1e-6
# a CP shard's shape in that step, through the bf16 and f32 backward
# pairs against their plain twins
MESH_SHARD_BWD = ((2, 512, 32, 64), (2, 2048, 8, 64), 1536)
# launch.train --mesh 1,4 (reduced llama) against the run without it
MESH_TRAIN_ARGV = ["--steps", "3", "--batch", "2", "--log-every", "1"]


@contextlib.contextmanager
def lm_mesh(shape):
    """A ("data", "model") mesh of ``shape`` over as many virtual shards
    of the card (``launch.mesh.make_host_mesh`` under a forced count),
    set for the block (``sharding.hints.set_mesh``); ``shape=None``: no
    mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.hints import get_mesh, set_mesh
    if shape is None:
        if get_mesh() is not None:
            fail("a mesh is set where none should be")
        yield None
        return
    with forced_shards(shape[0] * shape[1]):
        mesh = make_host_mesh(data=shape[0], model=shape[1])
    if mesh.devices.shape != tuple(shape):
        fail(f"host mesh {mesh.devices.shape}, asked for {shape}")
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(None)


def _shard_calls_ok(calls, cfg, s, shards, window):
    """Every recorded K4 call of a CP run: one a shard a layer, shard r
    on rows [r*S/m, (r+1)*S/m) at q_offset r*S/m, the config's window."""
    rows = s // shards
    want = sorted((rows, r * rows) for r in range(shards)) * cfg.num_layers
    got = sorted((q[1], off) for q, _, _, _, w, off in calls)
    return sorted(want) == got and all(c[4] == window for c in calls)


def mesh_cp_prefill(cfg, params, b, s):
    """``make_prefill_step`` of ``cfg`` (bf16, full width) under
    ``MESH_CP_PREFILL``'s mesh and mode, and under the same mode with no
    mesh (one K4 launch a layer over all rows): the mesh run's branch,
    its launches (one a shard a layer) and each call's rows and offset;
    its last-position logits within ``FA_TOL`` bf16 of the run without
    the mesh.  For the 16-shard prefill also K4's ms at one shard's
    shape (first and last shard) beside the one launch over all rows."""
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.launch.steps import make_prefill_step
    shape, mode, route = MESH_CP_PREFILL[cfg.arch_id]
    shards = shape[1]
    window = cfg.sliding_window or 0
    step = make_prefill_step(cfg, TrainConfig(context_parallel=mode))
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    out, logits = {"mesh": list(shape), "context_parallel": mode}, {}
    t_all = time.perf_counter()
    for tag, mesh_shape in (("without_mesh", None), ("mesh", shape)):
        routes = []
        label = f"lm_mesh_path {cfg.arch_id} prefill {tag}"
        with lm_mesh(mesh_shape), recording_routes(routes):
            logits[tag], first_s, warm, launched, calls = _kernel_runs(
                lambda: step(params, {"tokens": toks}), cfg,
                (b, cfg.vocab_size), label,
                per_layer=shards if mesh_shape else 1)
        # routes: the first run and the warm ones; calls: the first run
        if tag == "mesh" and (
                routes != [route] * cfg.num_layers * (1 + LM_WARM_RUNS)
                or not _shard_calls_ok(calls, cfg, s, shards, window)):
            fail(f"{label}: routes {sorted(set(routes))} x{len(routes)}, "
                 f"calls {sorted(set((c[0], c[5]) for c in calls))}")
        med = statistics.median(warm)
        out[tag] = {"route": sorted(set(routes)), "first_run_s": first_s,
                    "warm_s": warm, "warm_s_median": med,
                    "prompt_tokens_per_s": b * s / med,
                    "launches": launched,
                    "k4_calls": sorted({(c[0], c[5]) for c in calls})[:4]}
    err = float((logits["mesh"].float()
                 - logits["without_mesh"].float()).abs().max())
    if not _close(logits["mesh"].float(), logits["without_mesh"].float(),
                  FA_TOL["bfloat16"]):
        fail(f"lm_mesh_path {cfg.arch_id}: CP prefill logits {err} from "
             f"those without the mesh (rtol, atol {FA_TOL['bfloat16']})")
    out.update(logits_max_abs_err=err, tol=FA_TOL["bfloat16"],
               cp_over_one_launch=out["mesh"]["warm_s_median"]
               / out["without_mesh"]["warm_s_median"],
               seconds=time.perf_counter() - t_all)
    if shards == 16:
        out["k4_per_shard"] = k4_shard_times(cfg, b, s, shards, window)
    return out


def k4_shard_times(cfg, b, s, shards, window):
    """K4 (bf16) at one shard's q rows against the full keys, for the
    first and the last shard, and one launch over all rows: median ms
    (CUDA events) and the bound of each; then the ``shards`` launches
    of one layer's CP route back to back."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(5)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, s, hkv, d, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    rows = s // shards
    out = []
    for r in (0, shards - 1, None):
        qs = q if r is None else q[:, r * rows:(r + 1) * rows]
        off = 0 if r is None else r * rows
        ms = median_ms(lambda: fa.flash_attention(
            qs, k, v, causal=True, window=window, q_offset=off))
        bound = flash_bound_ms(tuple(qs.shape), tuple(k.shape), 2, True,
                               window, off)
        out.append({"shard": r, "q": list(qs.shape), "k": list(k.shape),
                    "q_offset": off, "ms": ms, "bound_ms": bound[0],
                    "bound_by": bound[1]})

    def layer():
        for r in range(shards):
            fa.flash_attention(q[:, r * rows:(r + 1) * rows], k, v,
                               causal=True, window=window,
                               q_offset=r * rows)

    all_ms = median_ms(layer)
    return {"launches": out, "all_shards_ms": all_ms,
            "all_shards_over_one_launch": all_ms / out[-1]["ms"]}


def mesh_cp_train():
    """``lm_loss`` and its gradients (``launch.steps.loss_and_grads``)
    of full-width llama3.2-1b in f32 on one batch of ``MESH_TRAIN``,
    with ``context_parallel="always"``, under a (1, 4) mesh and with no
    mesh: 4 K4 launches a layer (forward with lse, dq, dkdv) against
    one; the loss and every gradient leaf within ``MESH_GRAD_RTOL`` of
    the run without the mesh; each side's step time the mean of that
    step and a second one taken in the other order.  Then K4's bf16 and f32 backward pairs at
    a CP shard's shape (``MESH_SHARD_BWD``) against their plain twins."""
    import torch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.transformer import lm_loss
    from repro_torch.tree import tree_leaves
    arch, shape, b, s = MESH_TRAIN
    t_all = time.perf_counter()
    cfg, params, init_s = _fresh(arch, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device="cuda")}
    runs, res = {}, {}
    for tag, mesh_shape in (("without_mesh", None), ("mesh", shape)):
        shards = mesh_shape[1] if mesh_shape else 1
        calls = []
        with lm_mesh(mesh_shape), recording_attention_calls(calls):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _, grads = loss_and_grads(
                lambda p: lm_loss(cfg, p, batch,
                                  context_parallel="always"), params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = counts()
        n = cfg.num_layers * shards
        want = only(flash_attention=n, flash_attention_bwd_dq=n,
                    flash_attention_bwd_dkdv=n)
        if launched != want or not _shard_calls_ok(calls, cfg, s, shards,
                                                   0):
            fail(f"lm_mesh_path train {tag}: launches {launched}, "
                 f"expected {want}; calls "
                 f"{sorted(set((c[0], c[5]) for c in calls))}")
        res[tag] = (loss, grads)
        runs[tag] = {"step_s_runs": [wall], "loss": float(loss),
                     "launches": launched}
    # one warm step a side more, in the other order (mesh first): the
    # cost of the route is read from the means over both orders
    for tag, mesh_shape in (("mesh", shape), ("without_mesh", None)):
        with lm_mesh(mesh_shape):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_and_grads(lambda p: lm_loss(cfg, p, batch,
                                             context_parallel="always"),
                           params)
            torch.cuda.synchronize()
            runs[tag]["step_s_runs"].append(time.perf_counter() - t0)
    for r_ in runs.values():
        r_["step_s"] = sum(r_["step_s_runs"]) / len(r_["step_s_runs"])
        r_["tokens_per_s"] = b * s / r_["step_s"]
    (loss0, g0), (loss1, g1) = res["without_mesh"], res["mesh"]
    worst = {"rel_err": 0.0}
    for name, a, w in zip(_leaf_names(g0), tree_leaves(g1),
                          tree_leaves(g0)):
        err = float((a - w).abs().max())
        scale = float(w.abs().max())
        if not bool(torch.isfinite(a).all()) or err > MESH_GRAD_RTOL * scale:
            fail(f"lm_mesh_path train: gradient {'/'.join(name)} is {err} "
                 f"from the step without the mesh (scale {scale}, rtol "
                 f"{MESH_GRAD_RTOL})")
        rel = err / scale if scale else 0.0
        if rel >= worst["rel_err"]:
            worst = {"leaf": "/".join(name), "max_abs_err": err,
                     "scale": scale, "rel_err": rel}
    loss_err = abs(float(loss1) - float(loss0))
    if loss_err > MESH_LOSS_RTOL * abs(float(loss0)):
        fail(f"lm_mesh_path train: loss {float(loss1)} vs {float(loss0)}")
    del params, res, g0, g1, grads
    torch.cuda.empty_cache()
    qs, ks, off = MESH_SHARD_BWD
    gen = torch.Generator(device="cuda").manual_seed(9)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q, k, v, do = r(*qs), r(*ks), r(*ks), r(*qs)
    shard_bwd = [check_flash_bwd_bf16("cp-shard", q, k, v, do, q_offset=off),
                 check_flash_bwd("cp-shard", q, k, v, do, q_offset=off)]
    return {"arch": arch, "mesh": list(shape), "batch": b, "seq": s,
            "dtype": "torch.float32", "context_parallel": "always",
            "init_s": init_s, **runs,
            "mesh_over_without": runs["mesh"]["step_s"]
            / runs["without_mesh"]["step_s"], "loss_abs_err": loss_err,
            "grad_rtol": MESH_GRAD_RTOL, "worst_grad": worst,
            "shard_bwd": shard_bwd, "seconds": time.perf_counter() - t_all}


def mesh_fl_lm(fl_lm_rows):
    """``fl_train`` over the reduced llama clients (``FL_LM_ARGV``) with
    ``--mesh-clients 4`` over forced shards, twice: the two histories
    equal, K3 launched (the sharded merge), the accuracies within
    ``MESH_ACC_ATOL`` of ``fl_lm_path``'s one-device run and its
    virtual times equal."""
    from repro_torch.launch import fl_train
    argv = FL_LM_ARGV + ["--mesh-clients", str(MESH_SHARDS)]
    hists, launched, walls = [], [], []
    for _ in range(2):
        with forced_shards(MESH_SHARDS):
            zero_counts()
            t0 = time.perf_counter()
            hists.append(fl_train.main(argv).to_json())
            walls.append(time.perf_counter() - t0)
            launched.append(counts())
    plain = fl_lm_rows[0]
    if hists[0] != hists[1] or launched[0] != launched[1]:
        fail("lm_mesh_path fl_train --mesh-clients: two seeded runs differ")
    if launched[0]["fedagg_partial"] < 1:
        fail(f"lm_mesh_path fl_train: K3 never launched: {launched[0]}")
    acc_err = max(abs(a - p) for a, p in zip(hists[0]["accuracy"],
                                             plain["accuracy"]))
    if hists[0]["times"] != plain["times"] or acc_err > MESH_ACC_ATOL:
        fail(f"lm_mesh_path fl_train: mesh history {hists[0]['accuracy']} "
             f"{hists[0]['times']} vs one device {plain['accuracy']} "
             f"{plain['times']}")
    return {"argv": argv, "accuracy": hists[0]["accuracy"],
            "one_device_accuracy": plain["accuracy"],
            "accuracy_max_abs_err": acc_err, "atol": MESH_ACC_ATOL,
            "wall_s": walls, "launches": launched[0],
            "two_runs_equal": True}


def mesh_train_cli():
    """``python -m repro_torch.launch.train`` (reduced llama) with and
    without ``--mesh 1,4`` over 4 forced shards: the same losses bit for
    bit (on one device the placement moves nothing)."""
    from repro_torch.launch import train as train_mod
    with patched(train_mod, "make_token_dataset",
                 _cached_corpus(train_mod.make_token_dataset)):
        t0 = time.perf_counter()
        plain = train_mod.main(MESH_TRAIN_ARGV)
        with forced_shards(MESH_SHARDS):
            zero_counts()
            meshed = train_mod.main(MESH_TRAIN_ARGV + ["--mesh", "1,4"])
            launched = counts()
    if meshed != plain:
        fail(f"lm_mesh_path launch.train --mesh 1,4: losses {meshed} vs "
             f"{plain}")
    return {"argv": MESH_TRAIN_ARGV + ["--mesh", "1,4"], "losses": meshed,
            "equal_to_without_mesh": True, "launches": launched,
            "seconds": time.perf_counter() - t0}


def lm_mesh_path(cp_prefills, fl_lm_rows):
    """The LM mesh: (a) phi4-mini's and (b) hymba's context-parallel
    bf16 prefills (run inside the phases that hold their weights), (c)
    the CP f32 training step, (d) the LM client mesh, (e) ``launch.train
    --mesh``; every K4 launch count of the CP routes."""
    import torch
    train = mesh_cp_train()
    torch.cuda.empty_cache()
    return {"prefill": cp_prefills, "train_step": train,
            "fl_lm_client_mesh": mesh_fl_lm(fl_lm_rows),
            "train_cli": mesh_train_cli(),
            "cp_k4_launches": {
                **{f"{a} prefill": r["mesh"]["launches"]["flash_attention"]
                   for a, r in cp_prefills.items()},
                **{f"{MESH_TRAIN[0]} train {part}": train["mesh"][
                    "launches"][f"flash_attention{key}"]
                   for part, key in (("forward", ""), ("dq", "_bwd_dq"),
                                     ("dkdv", "_bwd_dkdv"))}}}


def _sdpa_backend(fn):
    """The backend the library call ran, from its kernels' names in a
    profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages()).lower()
    # cuDNN's kernels carry "flash" in their names too: it is read first
    for tag, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if tag in names:
            return backend
    return "math"


# D-long dots a visible (q, k) pair of the bf16 kernel's precision
# contract: Q.K^T, and P.V with P in two bf16 parts (the reference's f32
# P); flash_bound_ms counts the function's two
TC_DOTS = 3


def flash_attention_times(attn_calls):
    """K4 (the tensor-core kernel: the prefill path is bf16), its plain
    twin, ``scaled_dot_product_attention`` (the library yardstick; the
    port never calls it) and the f32 (split-TF32) kernel on the same
    inputs in f32, at one layer of each route the prefill path formed,
    in turns.  Each row also carries both kernels' launch as the library
    reports it (``fwd_sizes``), the bf16 kernel's rate on a bound that
    also counts the second P.V product of its P split (``TC_DOTS`` dots
    a pair: the implementation's way to meet ``FA_TOL``, not work that
    attention needs; ``rate_on_bound`` is the function's),
    and SDPA's own max abs error against the plain twin beside
    ``FA_TOL`` (reported, not gated: whether the library computes the
    same function within the port's tolerance)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    out = []
    for arch, route, (qs, ks, dtype, causal, window, q_offset) in attn_calls:
        gen = torch.Generator(device="cuda").manual_seed(12)
        q = torch.randn(qs, generator=gen, device="cuda").to(dtype)
        k = torch.randn(ks, generator=gen, device="cuda").to(dtype)
        v = torch.randn(ks, generator=gen, device="cuda").to(dtype)
        err = check_flash(f"timed-{arch}-{route}", q, k, v, causal=causal,
                          window=window, q_offset=q_offset)["max_abs_err"]
        # the same shape in f32, under the f32 tolerance
        f32_err = check_flash(f"timed-{arch}-{route}-f32", q.float(),
                              k.float(), v.float(), causal=causal,
                              window=window,
                              q_offset=q_offset)["max_abs_err"]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        s, t = qs[1], ks[1]
        if window and window < t:
            qp = torch.arange(s, device="cuda")[:, None] + q_offset
            kp = torch.arange(t, device="cuda")[None, :]
            band = kp > qp - window
            if causal:
                band &= kp <= qp
            lib_kw = {"attn_mask": band}
        else:
            lib_kw = {"is_causal": bool(causal)}

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)

        def plain():
            return fa.gqa_plain(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True, **lib_kw)

        qf, kf, vf = q.float(), k.float(), v.float()

        def kernel_f32():
            return fa.flash_attention(qf, kf, vf, causal=causal,
                                      window=window, q_offset=q_offset)

        def kernel_f32_lse():
            return fa._kernel_forward(qf, kf, vf, causal, window, q_offset,
                                      with_lse=True)

        backend = _sdpa_backend(library)
        want = plain()
        got_lib = library().transpose(1, 2)
        sdpa_err = float((got_lib.float() - want.float()).abs().max())
        sdpa_ok = _close(got_lib, want, _tol(FA_TOL, dtype))
        del want, got_lib
        tc_before = fa.tc_launches
        kernel_a = median_ms(kernel, runs=5, per_run=5)
        if fa.tc_launches == tc_before:
            fail(f"flash_attention_times {arch}: the timed kernel was not "
                 "the tensor-core one")
        plain_a = median_ms(plain, runs=3, per_run=2)
        lib = median_ms(library, runs=5, per_run=5)
        f32_ms = median_ms(kernel_f32, runs=3, per_run=3)
        f32_lse_ms = median_ms(kernel_f32_lse, runs=3, per_run=3)
        kernel_b = median_ms(kernel, runs=5, per_run=5)
        plain_b = median_ms(plain, runs=3, per_run=2)
        bound, bound_by, ops_by, flops, exps = flash_bound_ms(
            qs, ks, q.element_size(), causal, window, q_offset)
        bound_incl_p_split = max(bound, TC_DOTS * flops / 2
                                 / BF16_TENSOR_FLOPS_PER_S * 1e3)
        ms = min(kernel_a, kernel_b)
        out.append({"arch": arch, "route": route, "q": list(qs),
                    "k": list(ks), "dtype": str(dtype), "causal": causal,
                    "window": window, "visible_flops": flops,
                    "visible_exps": exps, "ms": ms,
                    "ms_runs": [kernel_a, kernel_b],
                    "tflops": flops / ms / 1e9,
                    "plain_ms": min(plain_a, plain_b), "library_ms": lib,
                    "library": f"scaled_dot_product_attention "
                               f"({backend} backend)",
                    "f32_kernel_ms": f32_ms,
                    "f32_kernel_lse_ms": f32_lse_ms,
                    "bound_ms": bound, "bound_by": bound_by,
                    "bound_ops": ops_by,
                    "bound_tensor_ms": flops / BF16_TENSOR_FLOPS_PER_S * 1e3,
                    "bound_exp_ms": exps / SFU_EXP_PER_S * 1e3,
                    "bound_incl_p_split_ms": bound_incl_p_split,
                    "rate_on_bound": bound / ms,
                    "rate_incl_p_split": bound_incl_p_split / ms,
                    "sizes": fa.fwd_sizes(qs[3], dtype),
                    "f32_sizes": fa.fwd_sizes(qs[3], torch.float32),
                    "max_abs_err": err, "f32_max_abs_err": f32_err,
                    "library_max_abs_err": sdpa_err,
                    "library_within_tol": sdpa_ok,
                    "library_tol": _tol(FA_TOL, dtype)})
    return out


# K5's times before its redesign (the serial kernel it replaced, on an
# H100 80GB HBM3 at 700 W; PERF.md), printed beside this run's
SS_EARLIER_MS = {"prefill": 1.012, "decode": 0.00624}


def ssm_split(b, s, d, n):
    """The time split the built K5 takes for one call, as its
    ``ssm_scan_scratch`` reports it: segment length, segments (warps) a
    chunk, chunks (all 0 for S = 1, the step kernel)."""
    from repro_torch.kernels import ssm_scan as ss
    lib = ss._lib()
    return {key: int(lib.ssm_scan_scratch(b, s, d, n, which))
            for key, which in (("seg", 2), ("warps", 3), ("chunks", 4))}


def ssm_design_exps(b, s, d, n, split):
    """The exps the kernel takes for one call under ``split``
    (``ssm_split``): one per (t, d, n) in each of its two passes, and N
    per earlier segment of the chunk for each warp's carry; a decode step
    (S = 1) takes one per state."""
    if s == 1:
        return b * d * n
    warps = split["warps"]
    folds = split["chunks"] * warps * (warps - 1) // 2
    return 2 * b * s * d * n + b * d * n * folds


def ssm_scan_times():
    """K5 and its plain twin at the serving path's two shapes: hymba's
    prefill (B=2, S=4096, D=3200, N=16) and a decode step (B=4, S=1,
    carried h0), beside the bound, the design's exp floor and the time
    before the redesign.  No single PyTorch call computes a selective
    scan, so there is no library yardstick."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = []
    for name, b, s, with_h0 in (("prefill", 2, 4096, False),
                                ("decode", SERVE_BATCH, 1, True)):
        d, n = 3200, 16
        x, dt, bi, co, al = ssm_inputs(gen, b, s, d, n, torch.bfloat16)
        h0 = (torch.randn(b, d, n, generator=gen, device="cuda")
              if with_h0 else None)
        err = check_ssm(f"timed-{name}", x, dt, bi, co, al, h0)

        def kernel():
            return ss.ssm_scan(x, dt, bi, co, al, h0)

        def plain():
            return ss.ssm_scan_plain(x, dt, bi, co, al, h0)

        long_plain = s > 64          # a Python loop of S steps
        kernel_a = median_ms(kernel)
        plain_a = median_ms(plain, hide_host=not long_plain,
                            warmup=1 if long_plain else 5,
                            runs=3 if long_plain else 7,
                            per_run=1 if long_plain else 20)
        kernel_b = median_ms(kernel)
        bound, bound_by = ssm_bound_ms(b, s, d, n, 2, with_h0)
        split = ssm_split(b, s, d, n)
        out.append({"case": name, "b": b, "s": s, "d": d, "n": n,
                    "dtype": "torch.bfloat16", "h0": with_h0,
                    "ms": min(kernel_a, kernel_b), "ms_turns":
                    [kernel_a, kernel_b], "plain_ms": plain_a,
                    "plain_includes_host": long_plain, "library_ms": None,
                    "bound_ms": bound, "bound_by": bound_by,
                    "split": split, "design_exp_floor_ms":
                    ssm_design_exps(b, s, d, n, split) / SFU_EXP_PER_S
                    * 1e3,
                    "earlier_ms": SS_EARLIER_MS[name],
                    "max_abs_err": err["max_abs_err"],
                    "h_end_max_abs_err": err["h_end_max_abs_err"]})
    return out


# K4's backward at the training path's two layer shapes (f32)
FA_BWD_SHAPES = (("hymba-1.5b", (1, 2048, 25, 64), (1, 2048, 5, 64), 1024),
                 ("llama3.2-1b", (2, 2048, 32, 64), (2, 2048, 8, 64), 0),
                 # the wide heads: phi4-mini's train step (D = 128), and
                 # a nemotron layer at S = 2048 (D = 192; no train run)
                 ("phi4-mini-3.8b", (1, 2048, 24, 128), (1, 2048, 8, 128),
                  0),
                 ("nemotron-4-340b", (1, 2048, 96, 192), (1, 2048, 8, 192),
                  0),
                 # mixtral's train step (D = 128, 32 q heads): its window
                 # of 4096 covers S, so every earlier key is visible
                 ("mixtral-8x7b", (1, 2048, 32, 128), (1, 2048, 8, 128),
                  4096))
# the same as (arch, q shape, k shape, window, causal), and hubert's
# train step (D = 80, MHA, an encoder: no mask)
FA_BWD_LAYERS = tuple((*x, True) for x in FA_BWD_SHAPES) + (
    ("hubert-xlarge", (2, 1024, 16, 80), (2, 1024, 16, 80), 0, False),)


def flash_attention_bwd_times(per_step):
    """K4's two backward kernels at the training path's layer shapes, f32:
    each kernel alone (direct launches of the built library, not
    counted), the pair through the wrapper's backward, the plain
    backward (``flash_attention_bwd_plain``) and autograd of
    ``scaled_dot_product_attention`` in f32 on its memory-efficient
    backend (the library yardstick for the pair's work: dq, dk and dv)
    and on its math backend, in turns; and the f32 forward kernel with
    and without the log-sum-exp output beside SDPA's f32 forward alone
    (memory-efficient backend), its plain twin
    (``flash_attention_fwd_plain``) and the forward's bound."""
    import math
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    out = []
    for arch, qs, ks, window, causal in FA_BWD_LAYERS:
        gen = torch.Generator(device="cuda").manual_seed(23)
        q = torch.randn(qs, generator=gen, device="cuda")
        k = torch.randn(ks, generator=gen, device="cuda")
        v = torch.randn(ks, generator=gen, device="cuda")
        do = torch.randn(qs, generator=gen, device="cuda")
        o, lse, _ = fa._kernel_forward(q, k, v, causal, window, 0,
                                    with_lse=True)
        b, s, h, d = qs
        t, hkv = ks[1], ks[2]
        lib = fa._bwd_lib()
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty((b, h, s), device="cuda")
        args = (b, s, t, h, hkv, d, int(causal), window, 0,
                1.0 / math.sqrt(d))

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

        def pair():
            return fa._kernel_backward(q, k, v, o, lse, do, causal, window,
                                       0)

        def plain():
            return fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=causal, window=window)

        # the library yardstick: autograd of SDPA on k and v repeated to
        # every q head inside the graph (its backward sums each group),
        # timed on the memory-efficient backend (f32, any mask) and on
        # the math backend
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        rep = h // hkv
        if window and window < t:
            qp = torch.arange(s, device="cuda")[:, None]
            kp = torch.arange(t, device="cuda")[None, :]
            lib_kw = {"attn_mask": (kp <= qp) & (kp > qp - window)}
        else:
            lib_kw = {"is_causal": causal}
        lib_do = do.transpose(1, 2)

        def library_on(backend):
            """The backward call, and the name of the graph node SDPA
            left (its backward names the backend)."""
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(
                    qt, kt.repeat_interleave(rep, dim=1),
                    vt.repeat_interleave(rep, dim=1), **lib_kw)

            def call():
                return torch.autograd.grad(out, (qt, kt, vt), lib_do,
                                           retain_graph=True)
            return call, out.grad_fn.name()

        library, lib_node = library_on(SDPBackend.EFFICIENT_ATTENTION)
        library_math, math_node = library_on(SDPBackend.MATH)
        lib_k = k.transpose(1, 2).repeat_interleave(rep, dim=1)
        lib_v = v.transpose(1, 2).repeat_interleave(rep, dim=1)
        lib_q = q.transpose(1, 2)

        def library_fwd():
            """SDPA's f32 forward alone (the yardstick of the forward
            with lse), memory-efficient backend, no grad."""
            with torch.no_grad(), sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(lib_q, lib_k, lib_v,
                                                      **lib_kw)

        def fwd_lse():
            return fa._kernel_forward(q, k, v, causal, window, 0,
                                      with_lse=True)

        def fwd_plain_out():
            return fa._kernel_forward(q, k, v, causal, window, 0,
                                      with_lse=False)

        def fwd_twin():
            return fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                window=window)

        if "EfficientAttention" not in lib_node:
            fail(f"flash_attention_bwd_times {arch}: SDPA's backward is "
                 f"{lib_node}, not the memory-efficient backend's")
        dq_a = median_ms(dq_kernel, runs=5, per_run=5)
        dkdv_a = median_ms(dkdv_kernel, runs=5, per_run=5)
        pair_a = median_ms(pair, runs=5, per_run=3)
        plain_ms = median_ms(plain, runs=3, per_run=2)
        lib_ms = median_ms(library, runs=5, per_run=3)
        lib_math_ms = median_ms(library_math, runs=3, per_run=3)
        fwd_a = median_ms(fwd_plain_out, runs=5, per_run=5)
        fwd_lse_a = median_ms(fwd_lse, runs=5, per_run=5)
        lib_fwd_ms = median_ms(library_fwd, runs=5, per_run=5)
        fwd_twin_ms = median_ms(fwd_twin, runs=3, per_run=2)
        dq_b = median_ms(dq_kernel, runs=5, per_run=5)
        dkdv_b = median_ms(dkdv_kernel, runs=5, per_run=5)
        pair_b = median_ms(pair, runs=5, per_run=3)
        fwd_lse_b = median_ms(fwd_lse, runs=5, per_run=5)
        fwd_b = median_ms(fwd_plain_out, runs=5, per_run=5)
        lib_fwd_b = median_ms(library_fwd, runs=5, per_run=5)
        # the pair's results against the plain backward, f32 tolerance
        got = pair()
        want = plain()
        errs = {}
        for tag, a, c in zip(("dq", "dk", "dv"), got, want):
            err, scale, ok = _grad_close(f"flash_attention_bwd_times.{tag}",
                                         a, c)
            errs[tag] = err
            if not ok:
                fail(f"flash_attention_bwd_times {arch}: {tag} {err}")
        row = {"arch": arch, "q": list(qs), "k": list(ks),
               "window": window, "causal": causal, "dtype": "torch.float32",
               "library": "autograd of scaled_dot_product_attention, f32, "
                          f"kv repeated in the graph ({lib_node})",
               "library_ms": lib_ms, "library_math_ms": lib_math_ms,
               "library_math": math_node,
               "plain_ms": plain_ms,
               "pair_ms": min(pair_a, pair_b), "pair_ms_turns":
               [pair_a, pair_b], "max_abs_err": errs,
               "fwd_f32_ms": min(fwd_a, fwd_b),
               "fwd_f32_lse_ms": min(fwd_lse_a, fwd_lse_b),
               "fwd_turns": {"no_lse": [fwd_a, fwd_b],
                             "lse": [fwd_lse_a, fwd_lse_b]},
               "fwd_plain_ms": fwd_twin_ms,
               "fwd_library_ms": min(lib_fwd_ms, lib_fwd_b),
               "fwd_library_ms_turns": [lib_fwd_ms, lib_fwd_b],
               "fwd_library": "scaled_dot_product_attention, f32, "
                              "memory-efficient backend, forward only, kv "
                              "repeated",
               "launches_per_train_step":
                   {"fwd_lse": per_step.get(arch, {}).get(
                       "flash_attention", 0),
                    "dq": per_step.get(arch, {}).get(
                        "flash_attention_bwd_dq", 0),
                    "dkdv": per_step.get(arch, {}).get(
                        "flash_attention_bwd_dkdv", 0)}}
        dots, reads, writes = FA_FWD_WORK
        fb = flash_bwd_bound_ms(qs, ks, dots, reads, writes, causal=causal,
                                window=window)
        row["fwd_bound"] = {
            "ms": fb["ms"], "by": fb["by"], "route": fb["route"],
            "flops": fb["flops"], "exps": fb["exps"],
            "cuda_core_ms": fb["cuda_core_ms"], "tensor_ms": fb["tensor_ms"]}
        row["fwd_f32_tflops"] = fb["flops"] / row["fwd_f32_lse_ms"] / 1e9
        row["fwd_rate_on_bound"] = fb["ms"] / row["fwd_f32_lse_ms"]
        row["fwd_sizes"] = fa.fwd_sizes(d, torch.float32)
        times = {"dq": min(dq_a, dq_b), "dkdv": min(dkdv_a, dkdv_b),
                 "pair": min(pair_a, pair_b)}
        for name, dots, reads, writes in FA_BWD_WORK:
            ms = times[name]
            bound = flash_bwd_bound_ms(qs, ks, dots, reads, writes,
                                       causal=causal, window=window)
            row[name] = {"ms": ms, "bound_ms": bound["ms"],
                         "bound_by": bound["by"],
                         "bound_route": bound["route"],
                         "bound_cuda_core_ms": bound["cuda_core_ms"],
                         "bound_tensor_ms": bound["tensor_ms"],
                         "flops": bound["flops"],
                         "tf32_flops": bound["tf32_flops"],
                         "exps": bound["exps"],
                         "f32_tflops": bound["flops"] / ms / 1e9}
        row["dq"]["ms_turns"] = [dq_a, dq_b]
        row["dkdv"]["ms_turns"] = [dkdv_a, dkdv_b]
        # the launches as the library reports them, and each kernel's rate
        # on the dots its design computes a visible pair (the pair: both
        # kernels' dots)
        sizes = fa.bwd_sizes(d)
        row["sizes"] = sizes
        done = {"dq": sizes["dq"]["dots_a_pair"],
                "dkdv": sizes["dkdv"]["dots_a_pair"]}
        done["pair"] = done["dq"] + done["dkdv"]
        for name, _, reads, writes in FA_BWD_WORK:
            bound = flash_bwd_bound_ms(qs, ks, done[name], reads, writes,
                                       causal=causal, window=window)
            row[name].update(dots_done=done[name],
                             bound_on_dots_done_ms=bound["ms"],
                             rate_on_dots_done=bound["ms"] / row[name]["ms"])
        out.append(row)
    return out


# K4's bf16 training kernels at the bf16 train path's layers and
# phi4-mini's (D = 128)
FA_BWD_BF16_SHAPES = FA_BWD_SHAPES[:3]

def flash_attention_bwd_bf16_times(per_step):
    """K4's bf16 training kernels at ``FA_BWD_BF16_SHAPES``: the forward
    with lse (and out_lo) beside the forward without, dq and dkdv alone
    (direct launches of the built library, not counted) and the pair
    through the wrapper's backward, in turns; on the same call the f32
    pair on the same values, the plain backward
    (``flash_attention_bwd_plain`` on the bf16 inputs, f32 math) and
    autograd of ``scaled_dot_product_attention`` in bf16 (kv repeated in
    the graph; the backend PyTorch picks, named) and its bf16 forward;
    each beside its bound (``flash_bwd_bf16_bound_ms``)."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    bf16 = torch.bfloat16
    out = []
    for arch, qs, ks, window in FA_BWD_BF16_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(35)
        q, do = (torch.randn(qs, generator=gen, device="cuda").to(bf16)
                 for _ in "qd")
        k, v = (torch.randn(ks, generator=gen, device="cuda").to(bf16)
                for _ in "kv")
        o, lse, o_lo = fa._kernel_forward(q, k, v, True, window, 0,
                                          with_lse=True)
        b, s, h, d = qs
        t, hkv = ks[1], ks[2]
        lib = fa._bwd_lib(bf16)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty((b, h, s), device="cuda")
        args = (b, s, t, h, hkv, d, 1, window, 0, 1.0 / math.sqrt(d))

        def dq_kernel():
            lib.flash_attention_bwd_dq_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                o_lo.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), *args,
                torch.cuda.current_stream().cuda_stream, 0.0)

        def dkdv_kernel():
            lib.flash_attention_bwd_dkdv_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *args,
                torch.cuda.current_stream().cuda_stream, 0.0)

        def pair():
            return fa._kernel_backward(q, k, v, o, lse, do, True, window,
                                       0, o_lo)

        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        of, lsef, _ = fa._kernel_forward(qf, kf, vf, True, window, 0,
                                         with_lse=True)

        def pair_f32():
            return fa._kernel_backward(qf, kf, vf, of, lsef, dof, True,
                                       window, 0)

        o_full = o.float() + o_lo.float()

        def plain():
            return fa.flash_attention_bwd_plain(q, k, v, o_full, lse, do,
                                                window=window)

        def fwd_lse():
            return fa._kernel_forward(q, k, v, True, window, 0,
                                      with_lse=True)

        def fwd():
            return fa._kernel_forward(q, k, v, True, window, 0,
                                      with_lse=False)

        rep = h // hkv
        if window and window < t:
            qp = torch.arange(s, device="cuda")[:, None]
            kp = torch.arange(t, device="cuda")[None, :]
            lib_kw = {"attn_mask": (kp <= qp) & (kp > qp - window)}
        else:
            lib_kw = {"is_causal": True}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(rep, dim=1),
            vt.repeat_interleave(rep, dim=1), **lib_kw)
        lib_node = lib_out.grad_fn.name()
        lib_do = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, (qt, kt, vt), lib_do,
                                       retain_graph=True)

        lib_q, lib_k, lib_v = (x.detach() for x in (
            qt, kt.repeat_interleave(rep, dim=1),
            vt.repeat_interleave(rep, dim=1)))

        def library_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(lib_q, lib_k, lib_v,
                                                      **lib_kw)

        turns = {name: [] for name in ("dq", "dkdv", "pair", "fwd_lse",
                                       "fwd")}
        for _ in range(2):
            turns["dq"].append(median_ms(dq_kernel, runs=5, per_run=5))
            turns["dkdv"].append(median_ms(dkdv_kernel, runs=5, per_run=5))
            turns["pair"].append(median_ms(pair, runs=5, per_run=3))
            turns["fwd_lse"].append(median_ms(fwd_lse, runs=5, per_run=5))
            turns["fwd"].append(median_ms(fwd, runs=5, per_run=5))
        pair_f32_ms = median_ms(pair_f32, runs=5, per_run=3)
        plain_ms = median_ms(plain, runs=3, per_run=2)
        lib_ms = median_ms(library, runs=5, per_run=3)
        lib_fwd_ms = median_ms(library_fwd, runs=5, per_run=5)
        got, want = pair(), plain()
        errs = {}
        for tag, a, c in zip(("dq", "dk", "dv"), got, want):
            err, _, ok = _grad_close_bf16(
                f"flash_attention_bwd_bf16_times.{tag}", a, c)
            errs[tag] = err
            if not ok:
                fail(f"flash_attention_bwd_bf16_times {arch}: {tag} {err}")
        steps = per_step.get(arch, {})
        row = {"arch": arch, "q": list(qs), "k": list(ks), "window": window,
               "causal": True, "dtype": "torch.bfloat16",
               "turns": turns, "pair_f32_ms": pair_f32_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": f"autograd of scaled_dot_product_attention, "
                          f"bf16, kv repeated in the graph ({lib_node})",
               "library_fwd_ms": lib_fwd_ms, "max_abs_err": errs,
               "tol": BF16_BWD_TOL,
               "sizes": fa.bwd_sizes(d, bf16),
               "launches_per_train_step": {
                   "fwd_lse": steps.get("flash_attention_tc", 0),
                   "dq": steps.get("flash_attention_bwd_dq_bf16", 0),
                   "dkdv": steps.get("flash_attention_bwd_dkdv_bf16", 0)}}
        for name, dots, reads, writes in FA_BWD_BF16_WORK + (
                ("fwd_lse",) + FA_FWD_BF16_WORK,):
            ms = min(turns[name])
            bound = flash_bwd_bf16_bound_ms(qs, ks, dots, reads, writes,
                                            window=window)
            row[name] = {"ms": ms, "bound_ms": bound["ms"],
                         "bound_by": bound["by"],
                         "flops": bound["flops"], "exps": bound["exps"],
                         "bytes": bound["bytes"],
                         "rate_on_bound": bound["ms"] / ms}
        # each backward kernel's rate on the dots its design computes a
        # visible pair (P and dS in two bf16 parts; the pair: both's)
        done = {kind: row["sizes"][kind]["dots_a_pair"]
                for kind in ("dq", "dkdv")}
        done["pair"] = done["dq"] + done["dkdv"]
        for name, _, reads, writes in FA_BWD_BF16_WORK:
            bound = flash_bwd_bf16_bound_ms(qs, ks, done[name], reads,
                                            writes, window=window)
            row[name].update(dots_done=done[name],
                             bound_on_dots_done_ms=bound["ms"],
                             rate_on_dots_done=bound["ms"]
                             / row[name]["ms"])
        row["fwd_ms"] = min(turns["fwd"])
        out.append(row)
    return out


def ssm_scan_bwd_bf16_times(per_step):
    """K5's backward on bf16 inputs at hymba's training shape (B=1,
    S=2048, D=3200, N=16; no h0, no h_end gradient), in turns, beside
    the f32 backward on the same values, the plain twin
    (``ssm_scan_bwd_plain``, a Python loop: host time included) and the
    bound: bf16 x, dt, dy, B, C read and bf16 dx, ddt, dB, dC written,
    a_log and dA_log f32, against HBM; the B*S*D*N exps at the SFU's
    rate."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(36)
    b, s, d, n = 1, 2048, 3200, 16
    x, dt, bi, co, al = ssm_inputs(gen, b, s, d, n, torch.bfloat16)
    dy = torch.randn(b, s, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    carries = ss._kernel_forward(x, dt, bi, co, al, None)[2]
    xf, dtf, bcf = x.float(), dt.float(), torch.cat([bi, co], -1).float()
    bif, cof = bcf[..., :n], bcf[..., n:]
    carries_f = ss._kernel_forward(xf, dtf, bif, cof, al, None)[2]

    def kernel():
        return ss._kernel_backward(x, dt, bi, co, al, None, dy, None,
                                   carries)

    def kernel_f32():
        return ss._kernel_backward(xf, dtf, bif, cof, al, None, dy.float(),
                                   None, carries_f)

    def plain():
        return ss.ssm_scan_bwd_plain(x, dt, bi, co, al, None, dy)

    kernel_a = median_ms(kernel)
    f32_ms = median_ms(kernel_f32)
    plain_ms = median_ms(plain, hide_host=False, warmup=1, runs=3,
                         per_run=1)
    kernel_b = median_ms(kernel)
    got, want = kernel(), plain()
    errs = {}
    for tag, a, c in zip(("dx", "ddt", "db", "dc", "da_log"), got, want):
        err, _, ok = _grad_close_bf16(f"ssm_scan_bwd_bf16_times.{tag}",
                                      a.to(torch.bfloat16)
                                      if tag != "da_log" else a, c)
        errs[tag] = err
        if not ok:
            fail(f"ssm_scan_bwd_bf16_times: {tag} {err}")
    by_bytes, by_ops = ssm_bwd_bound_ms(b, s, d, n, 2)
    return {"case": "hymba-train-bf16", "b": b, "s": s, "d": d, "n": n,
            "dtype": "torch.bfloat16", "ms": min(kernel_a, kernel_b),
            "ms_turns": [kernel_a, kernel_b], "f32_ms": f32_ms,
            "plain_ms": plain_ms, "plain_includes_host": True,
            "library_ms": None, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes_ms": by_bytes, "bound_exps_ms": by_ops,
            "max_abs_err": errs, "tol": BF16_BWD_TOL,
            "launches_per_train_step":
                per_step["hymba-1.5b"]["ssm_scan_bwd_bf16"]}


def ssm_bwd_split(b, s, d, n):
    """The time split K5's backward takes for one call, as the built
    libraries report it: the forward's segment length, segments a chunk
    and chunks (``ssm_scan.time_split``), and the backward's steps
    between checkpoints and of a register half block
    (``ssm_scan_bwd_sizes`` which = 4, 5)."""
    from repro_torch.kernels import ssm_scan as ss
    seg, warps, chunks = ss.time_split(b, s, d, n)
    lib = ss._bwd_lib()
    return {"seg": seg, "warps": warps, "chunks": chunks,
            "block": int(lib.ssm_scan_bwd_sizes(b, s, d, n, chunks, 4)),
            "half": int(lib.ssm_scan_bwd_sizes(b, s, d, n, chunks, 5))}


def ssm_bwd_design_exps(b, s, d, n, split):
    """The exps K5's backward takes for one call under ``split``
    (``ssm_bwd_split``), per (d, n): for each segment of L steps, L in
    each pass from zero (forward, and g backward), the checkpoint walk
    up to the last block's start, each block of l steps replayed (l,
    and 4 more for a block whose later half is reached from the
    checkpoint), L in the walk back; and the folds, N per segment a
    warp crosses: every earlier one (the state) and every later one (g),
    and warp 0's own (the chunk's carry out)."""
    warps, seg, blk, half = (split[k] for k in ("warps", "seg", "block",
                                                "half"))
    per_state = 0
    for k in range(split["chunks"]):
        for w in range(warps):
            tb = (k * warps + w) * seg
            length = max(0, min(tb + seg, s) - tb)
            if length == 0:
                continue
            blocks = [min(blk, length - j) for j in range(0, length, blk)]
            per_state += 3 * length + (length - blocks[-1]) + sum(
                bl + (half if bl > half else 0) for bl in blocks)
        per_state += warps * (warps - 1) + 1
    return b * d * n * per_state


def ssm_scan_bwd_times(per_step):
    """K5's backward at hymba's training shape (B=1, S=2048, D=3200,
    N=16, f32, no h0, an incoming h_end gradient of zeros as the model
    gives), its plain twin (``ssm_scan_bwd_plain``, a Python loop of S
    steps: host time included), in turns, beside its bound, the
    design's exp floor from the split it reports, and its time before
    the redesign; no PyTorch call computes a selective scan's gradient,
    so there is no library yardstick."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(24)
    b, s, d, n = 1, 2048, 3200, 16
    x, dt, bi, co, al = ssm_inputs(gen, b, s, d, n, torch.float32)
    dy = torch.randn(b, s, d, generator=gen, device="cuda")
    carries = ss._kernel_forward(x, dt, bi, co, al, None)[2]

    def kernel():
        return ss._kernel_backward(x, dt, bi, co, al, None, dy, None,
                                   carries)

    def plain():
        return ss.ssm_scan_bwd_plain(x, dt, bi, co, al, None, dy)

    kernel_a = median_ms(kernel)
    plain_ms = median_ms(plain, hide_host=False, warmup=1, runs=3,
                         per_run=1)
    kernel_b = median_ms(kernel)
    got, want = kernel(), plain()
    errs = {}
    for tag, a, c in zip(("dx", "ddt", "db", "dc", "da_log"), got, want):
        err, _, ok = _grad_close(f"ssm_scan_bwd_times.{tag}", a, c)
        errs[tag] = err
        if not ok:
            fail(f"ssm_scan_bwd_times: {tag} {err}")
    # bytes: x, dt, dy read, dx, ddt written (B,S,D); B, C read and dB,
    # dC written (B,S,N); a_log read, dA_log written (D,N); f32.  Exps:
    # one a_t per (t, d, n).
    by_bytes, by_ops = ssm_bwd_bound_ms(b, s, d, n, 4)
    split = ssm_bwd_split(b, s, d, n)
    ms = min(kernel_a, kernel_b)
    return {"case": "hymba-train", "b": b, "s": s, "d": d, "n": n,
            "dtype": "torch.float32", "ms": ms,
            "ms_turns": [kernel_a, kernel_b], "plain_ms": plain_ms,
            "plain_includes_host": True, "library_ms": None,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes_ms": by_bytes, "bound_exps_ms": by_ops,
            "split": split,
            "design_exps_ms": ssm_bwd_design_exps(b, s, d, n, split)
            / SFU_EXP_PER_S * 1e3,
            "earlier_ms": SS_BWD_EARLIER_MS,
            "max_abs_err": errs,
            "launches_per_train_step": per_step["hymba-1.5b"]["ssm_scan_bwd"]}


# K5's backward before its split over time (one warp a (row, channel
# group), serial in time), at the shape above on an H100 80GB HBM3 at
# 700 W (PERF.md), printed beside this run's
SS_BWD_EARLIER_MS = 3.9254


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    for key, value in FLEX_ENV.items():
        os.environ.setdefault(key, value)
    corpora = start_corpora()
    warm = start_flex_warm()
    try:
        return run_phases(warm)
    finally:
        warm[0].terminate()
        warm[0].join()
        corpora.terminate()
        corpora.join()


# ---------------------------------------------------------------------
# K1-K3 past 4,096 rows: the tiled route (a preamble launch, then the
# stream over tiles of coefficients)
# ---------------------------------------------------------------------

ROWS_P = 131_072          # f32 columns: 4.3 GB of rows at 8,192
ROWS_LIVE = 5000          # live rows padded with zero rows to 8,192


def _bitwise(name, got, want):
    import torch
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name}: not equal bit for bit, max abs "
             f"{float((got - want).abs().max())}")


def _tiled_calls(fn):
    """fn()'s result and the tiled route's calls it made."""
    from repro_torch.kernels import fedagg as fa
    before = fa.tiled_launches
    out = fn()
    return out, fa.tiled_launches - before


def _once_ms(fn):
    """One call's time between CUDA events (the plain versions' Python
    row loops: host included)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def fedagg_entry(mode, u, x, y, out):
    """The single-launch entry of K1 (``x`` weights, ``y`` alphas or
    None), K2 (``x`` the global row, ``y`` the coefficients) or K3 (``x``
    the coefficients) on the rows ``u`` into ``out``, and its arguments
    but the stream (``fedagg._launch`` passes them to the tiled twin
    too)."""
    from repro_torch.kernels import fedagg as fa
    n, p = u.shape
    if mode == "fedagg":
        entry, ptrs, rows = ("fedagg_f32", (x.data_ptr(), None if y is None
                                            else y.data_ptr()), (u, out))
    elif mode == "fedagg_fold":
        entry, ptrs, rows = ("fedagg_fold_f32", (x.data_ptr(), y.data_ptr()),
                             (u, x, out))
    else:
        entry, ptrs, rows = "fedagg_partial_f32", (x.data_ptr(),), (u, out)
    return entry, (u.data_ptr(), *ptrs, out.data_ptr(), n, p,
                   fa._vector_width(p, *rows))


def single_launch(mode, u, x, y=None):
    """The single launch of ``fedagg_entry``'s mode, its entry called
    directly whatever route the wrappers (``fedagg.tiled_route``) take
    for the shape: the batch loop of 16 rows in flight.  Counts no
    launch."""
    import torch
    from repro_torch.kernels import fedagg as fa
    out = torch.empty(u.shape[1], device=u.device)
    entry, args = fedagg_entry(mode, u, x, y, out)
    err = fa._launch(fa._lib(), entry, None, args,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"{entry}: launch failed, CUDA error {err}")
    return out


def fedagg_rows_checks():
    """K1-K3 at N in {4,096, 4,097, 8,192} rows of P = 131,072 f32 and
    K2 at K + 1 = 4,097 and 8,192 coefficients: (b) a 4,096-row call
    (K2: 4,096 coefficients) of the single launch (``single_launch``:
    the wrappers route such a call to the tiled route) with
    zero-coefficient rows appended up to 4,097 and 8,192 equals it bit
    for bit, the appended rows past 4,096 holding inf and nan, and so
    does the wrappers' own 4,096-row call; (c) 5,000 live rows padded
    with zero rows to 8,192 equal the unpadded 5,000 bit for bit; (d) at
    4,097 and 8,192 rows each kernel is within RTOL/ATOL of its plain
    twin.  Then each kernel's ms at 8,192 rows beside its plain twin
    (one call), its library yardstick and roofline/cost.py's bound
    (``_rows_times``); each at 4,096 rows (K2: 4,095) through the
    wrappers' route beside the single launch and its library call
    (``_at_4096``); and at the row width of resnet8-cifar10's tree
    (``resnet8_p``: the vec = 2 path) (b) again and the times."""
    import torch
    from repro_torch.kernels import fedagg as fa
    gen = torch.Generator(device="cuda").manual_seed(11)
    n_max, single = 8192, 4096
    u = torch.randn(n_max, ROWS_P, generator=gen, device="cuda")
    u[single + 3] = float("inf")            # rows that only ever carry
    u[n_max - 1] = float("nan")             # coefficient 0
    g = torch.randn(ROWS_P, generator=gen, device="cuda")
    w = 40.0 + 40.0 * torch.rand(n_max, generator=gen, device="cuda")
    a = torch.rand(n_max, generator=gen, device="cuda")
    c = torch.rand(n_max + 1, generator=gen, device="cuda")
    for x in (w, a):
        x[single + 3] = x[n_max - 1] = 0.0
    c[single + 4] = c[n_max] = 0.0          # fold: global first
    c3 = c[1:] / c[1:].sum()                # K3: a sum of order one
    zeros = torch.zeros(n_max + 1, device="cuda")

    def padded(x, live, n):
        return torch.cat([x[:live], zeros[:n - live]])

    out = {"p": ROWS_P, "single_launch_rows": single}
    # (b) appended zero-coefficient rows change no bit: the single launch
    # called directly, the wrappers' own call of its rows, and the rows
    # padded past it
    calls, routes = [], {}
    for n in (single + 1, n_max):
        for name, base, own, pad in _appended(u, g, w, a, c, c3, padded,
                                              single, n):
            want = base()
            got_own, t0 = _tiled_calls(own)
            got, t1 = _tiled_calls(pad)
            if t1 != 1:
                fail(f"{name}: {n} rows took the tiled route {t1} times")
            _bitwise(f"{name} (b): the wrappers' {single} rows", got_own,
                     want)
            _bitwise(f"{name} (b): {single} rows padded to {n}", got, want)
            calls.append(f"{name}:{single}->{n}")
            routes[name] = "tiled" if t0 else "single"
    out["b_appended_zero_rows_bitwise"] = calls
    out["b_route_at_4096"] = routes
    # (c) 5,000 live rows padded to 8,192
    calls = []
    for name, base, pad in (
            ("fedagg", lambda: fa.fedagg(u[:ROWS_LIVE], w[:ROWS_LIVE]),
             lambda: fa.fedagg(u, padded(w, ROWS_LIVE, n_max))),
            ("fedagg_fold", lambda: fa.fedagg_fold(u[:ROWS_LIVE], g,
                                                   c[:ROWS_LIVE + 1]),
             lambda: fa.fedagg_fold(u, g, padded(c, ROWS_LIVE + 1,
                                                 n_max + 1))),
            ("fedagg_partial", lambda: fa.fedagg_partial(u[:ROWS_LIVE],
                                                         c3[:ROWS_LIVE]),
             lambda: fa.fedagg_partial(u, padded(c3, ROWS_LIVE, n_max)))):
        want, t0 = _tiled_calls(base)
        got, t1 = _tiled_calls(pad)
        if (t0, t1) != (1, 1):
            fail(f"{name} (c): tiled calls {t0}, {t1}")
        _bitwise(f"{name} (c): {ROWS_LIVE} live rows padded to {n_max}",
                 got, want)
        calls.append(f"{name}:{ROWS_LIVE}->{n_max}")
    out["c_live_rows_padded_bitwise"] = calls
    # (d) within the K1-K3 tolerance of the plain twins
    errs = {}
    for n in (single + 1, n_max):
        errs[f"fedagg_{n}"] = check_fedagg(f"rows-{n}", u[:n], w[:n],
                                           a[:n])["max_abs_err"]
        errs[f"fedagg_fold_{n}"] = check_fold(f"rows-{n}", u[:n - 1], g,
                                              c[:n])["max_abs_err"]
        errs[f"fedagg_partial_{n}"] = check_partial(f"rows-{n}", u[:n],
                                                    c3[:n])["max_abs_err"]
    out["d_max_abs_err_vs_plain"] = errs
    out["tolerance"] = {"rtol": RTOL, "atol": ATOL}
    # the times at 8,192 rows (4.3 GB: no copies needed to miss the L2)
    out["at_8192_rows"] = _rows_times(u, g, w, c, c3, ROWS_P)
    # each at 4,096 rows beside it, on the same buffer
    out.update(_at_4096(u, g, w, c, c3, single))
    del u
    torch.cuda.empty_cache()
    # the paper's cross-device width: resnet8-cifar10's tree (an odd
    # count of float2s: the vec = 2 path), (b) bit for bit, then timed
    p8 = resnet8_p()
    u = torch.randn(n_max, p8, generator=gen, device="cuda")
    u[single + 3] = float("inf")
    u[n_max - 1] = float("nan")
    g = torch.randn(p8, generator=gen, device="cuda")
    calls = []
    for name, base, own, pad in _appended(u, g, w, a, c, c3, padded,
                                          single, n_max):
        want = base()
        got_own, t0 = _tiled_calls(own)
        got, t1 = _tiled_calls(pad)
        if t1 != 1:
            fail(f"{name} at p {p8}: {n_max} rows: tiled calls {t1}")
        _bitwise(f"{name} (b) at p {p8}: the wrappers' {single} rows",
                 got_own, want)
        _bitwise(f"{name} (b) at p {p8}: {single} rows padded to {n_max}",
                 got, want)
        calls.append(f"{name}:{single}->{n_max}")
        routes[f"{name}_at_resnet8_width"] = "tiled" if t0 else "single"
    out["b_route_at_4096"] = routes
    out["resnet8_p"] = p8
    out["b_at_resnet8_width_bitwise"] = calls
    out["at_8192_rows_resnet8_width"] = _rows_times(u, g, w, c, c3, p8)
    del u
    torch.cuda.empty_cache()
    return out


def _appended(u, g, w, a, c, c3, padded, single, n):
    """(mode, the single launch on ``single`` rows (K2: ``single``
    coefficients), the wrapper on them, the wrapper on them padded with
    zero-coefficient rows to ``n``) for the three modes."""
    from repro_torch.kernels import fedagg as fa
    return (
        ("fedagg",
         lambda: single_launch("fedagg", u[:single], w[:single], a[:single]),
         lambda: fa.fedagg(u[:single], w[:single], alphas=a[:single]),
         lambda: fa.fedagg(u[:n], padded(w, single, n), alphas=a[:n])),
        ("fedagg_fold",
         lambda: single_launch("fedagg_fold", u[:single - 1], g, c[:single]),
         lambda: fa.fedagg_fold(u[:single - 1], g, c[:single]),
         lambda: fa.fedagg_fold(u[:n - 1], g, padded(c, single, n))),
        ("fedagg_partial",
         lambda: single_launch("fedagg_partial", u[:single], c3[:single]),
         lambda: fa.fedagg_partial(u[:single], c3[:single]),
         lambda: fa.fedagg_partial(u[:n], padded(c3, single, n))))


def _at_4096(u, g, w, c, c3, single):
    """K1 and K3 on ``single`` rows of ``u``, K2 on ``single`` - 1 rows
    (``single`` coefficients): the wrappers' route (which it is: the
    tiled calls it made), its ms, the single launch's ms (the batch
    loop: the route before the crossover) in turns with it, the library
    call and the bound."""
    import torch
    from repro_torch.kernels import fedagg as fa
    p = u.shape[1]
    us, ws = u[:single], w[:single]
    eff = ws / ws.sum()
    k2_c = c[:single]
    fc = k2_c / k2_c.sum()
    cases = {
        "fedagg": (lambda: fa.fedagg(us, ws),
                   lambda: single_launch("fedagg", us, ws),
                   lambda: torch.matmul(eff, us), "matmul",
                   fedagg_bound_ms(ws, p)),
        "fedagg_fold": (lambda: fa.fedagg_fold(us[:-1], g, k2_c),
                        lambda: single_launch("fedagg_fold", us[:-1], g,
                                              k2_c),
                        lambda: torch.addmv(g * fc[0], us[:-1].t(), fc[1:]),
                        "addmv", fold_bound_ms(k2_c, p)),
        "fedagg_partial": (lambda: fa.fedagg_partial(us, c3[:single]),
                           lambda: single_launch("fedagg_partial", us,
                                                 c3[:single]),
                           lambda: torch.mv(us.t(), c3[:single]), "mv",
                           partial_bound_ms(c3[:single], p))}
    out = {}
    for name, (route, batch, library, lib_name, bound) in cases.items():
        _, tiled = _tiled_calls(route)
        turns = {"route": [], "single_launch": []}
        for which in ("route", "single_launch", "single_launch", "route"):
            fn = route if which == "route" else batch
            turns[which].append(median_ms(fn, warmup=2, runs=5, per_run=5))
        ms = min(turns["route"])
        lib_ms = median_ms(library, warmup=2, runs=5, per_run=5)
        key = "fedagg_at_4096" if name == "fedagg" else f"{name}_at_4096"
        out[key] = {
            "rows": single - (name == "fedagg_fold"), "p": p,
            "route": "tiled" if tiled else "single",
            "ms": ms, "single_launch_ms": min(turns["single_launch"]),
            "ms_turns": turns, "library": lib_name, "library_ms": lib_ms,
            "over_library": ms / lib_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "share_of_bound": bound[0] / ms}
    return out


def resnet8_p() -> int:
    """Floats in the resnet8-cifar10 tree as the port builds it
    (``init_cnn``): the aggregation's row width for that model."""
    import torch
    from repro_torch.config.base import get_arch
    from repro_torch.models.cnn import init_cnn

    def count(t):
        if isinstance(t, torch.Tensor):
            return t.numel()
        if isinstance(t, dict):
            return sum(count(x) for x in t.values())
        return sum(count(x) for x in t)
    return count(init_cnn(get_arch("resnet8-cifar10"),
                          torch.Generator().manual_seed(0), device="cpu"))


def _rows_times(u, g, w, c, c3, p):
    """Each tiled kernel's ms on 8,192 rows of ``u`` (8,191 for K2)
    beside its plain twin (one call), its library yardstick and
    roofline/cost.py's bound."""
    import torch
    from repro_torch.kernels import fedagg as fa
    n_max = u.shape[0]
    live_c = c[1:n_max].clone()
    k2_c = c[:n_max]
    eff = w / w.sum()
    cases = {
        "fedagg": (lambda: fa.fedagg(u, w), lambda: fa.fedagg_plain(u, w),
                   lambda: torch.matmul(eff, u), "matmul",
                   fedagg_bound_ms(w, p)),
        "fedagg_fold": (lambda: fa.fedagg_fold(u[:n_max - 1], g, k2_c),
                        lambda: fa.fedagg_fold_plain(u[:n_max - 1], g, k2_c),
                        lambda: torch.addmv(g, u[:n_max - 1].t(), live_c),
                        "addmv", fold_bound_ms(k2_c, p)),
        "fedagg_partial": (lambda: fa.fedagg_partial(u, c3),
                           lambda: fa.fedagg_partial_plain(u, c3),
                           lambda: torch.mv(u.t(), c3), "mv",
                           partial_bound_ms(c3, p))}
    times = {}
    for name, (kernel, plain, library, lib_name, bound) in cases.items():
        ms = median_ms(kernel, warmup=2, runs=5, per_run=5)
        lib_ms = median_ms(library, warmup=2, runs=5, per_run=5)
        times[name] = {"rows": n_max if name != "fedagg_fold"
                       else n_max - 1, "p": p, "ms": ms,
                       "plain_ms": _once_ms(plain),
                       "library_ms": lib_ms, "library": lib_name,
                       "over_library": ms / lib_ms,
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "share_of_bound": bound[0] / ms}
    return times


# An FL run past the cap: FedAvg on SyntheticCohortTrainer with every
# one of ROWS_CLIENTS clients in its round (K1's rows), twice from one
# seed; FedBuff with a window of as many (K2's rows, the store padding
# the window to 8,192), store and dict
ROWS_CLIENTS = 4100


def fl_past_4096_rows():
    from repro_torch.config.base import FLConfig
    from repro_torch.core.baselines import run_method
    from repro_torch.fl.network import WirelessNetwork
    from repro_torch.fl.testing import SyntheticCohortTrainer

    def run(method, fl, **kw):
        net = WirelessNetwork(fl.n_clients, fl.tier_delay_means,
                              fl.delay_std, fl.mu, fl.failure_delay, fl.seed)
        zero_counts()
        t0 = time.perf_counter()
        hist = run_method(method, SyntheticCohortTrainer(device="cuda"), net,
                          fl, use_kernel_agg=True, **kw)
        return hist, counts(), time.perf_counter() - t0

    sync_fl = FLConfig(n_clients=ROWS_CLIENTS, tau=ROWS_CLIENTS, rounds=1,
                       seed=3)
    a, launched, a_s = run("fedavg", sync_fl)
    b, again, b_s = run("fedavg", sync_fl)
    if launched != only(fedagg=1, fedagg_tiled=1) or again != launched:
        fail(f"fl past 4096 rows: fedavg launches {launched}, {again}")
    if a.to_json() != b.to_json():
        fail("fl past 4096 rows: two seeded fedavg runs differ")
    buff_fl = FLConfig(n_clients=ROWS_CLIENTS, tau=ROWS_CLIENTS, rounds=1,
                       seed=2)
    kw = dict(window=ROWS_CLIENTS, eval_every=1)
    store, s_counts, store_s = run("fedbuff", buff_fl, use_store=True, **kw)
    plain, d_counts, dict_s = run("fedbuff", buff_fl, use_store=False, **kw)
    if store.meta["store_path"] != "store" \
            or _without_store_keys(store) != _without_store_keys(plain):
        fail("fl past 4096 rows: fedbuff store != dict")
    for c in (s_counts, d_counts):
        if not c["fedagg_fold"] or c["fedagg_tiled"] != c["fedagg_fold"]:
            fail(f"fl past 4096 rows: fedbuff launches {c}")
    return {"clients": ROWS_CLIENTS,
            "fedavg": {"survivors_per_round": int(a.n_selected[0]),
                       "launches": launched, "seeded_runs_equal": True,
                       "run_s": [a_s, b_s]},
            "fedbuff": {"window": ROWS_CLIENTS,
                        "mean_cohort": store.meta["mean_cohort"],
                        "store_equals_dict": True,
                        "launches_store": s_counts,
                        "launches_dict": d_counts,
                        "run_s": {"store": store_s, "dict": dict_s}}}


# ---------------------------------------------------------------------
# Non-causal banded attention on K4: one launch a q chunk on its band
# ---------------------------------------------------------------------

# hubert-xlarge's layer: q (2, 4096, 16, 80), 16 kv heads, window 1024,
# the reference's chunks (512 q rows, 1024 keys)
BAND_SHAPE = (2, 4096, 16, 80)
BAND_WINDOW = 1024


def band_route_path():
    """The band route (``models/attention.py: _band_kernel``) in bf16 and
    f32 against ``banded_attention``'s plain computation of the same
    function on the card (its CPU branch, routed), at FA_TOL; the f32
    gradients against autograd of that plain computation at the f32
    backward tolerance; the route's launches; and that the band matters:
    the full-window non-causal attention (one launch) differs from it by
    more than 100x the tolerance.  v's keys past the first chunk's band
    (3,072) are shifted by 2, so that what the band cuts shows in every
    dtype's tolerance.  The library yardstick (the port never calls it):
    ``scaled_dot_product_attention`` with the reference's band and the
    window as one boolean (S, T) mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.models import attention as attn
    b, s, h, d = BAND_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(12)
    q32, k32, v32 = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                     for _ in range(3))
    v32[:, 3072:] += 2.0
    kw = dict(window=BAND_WINDOW, causal=False)
    nb = attn._band_chunks(BAND_WINDOW, 512, 1024, s)
    out = {"q": list(BAND_SHAPE), "k": list(BAND_SHAPE),
           "window": BAND_WINDOW, "chunk_q": 512, "chunk_kv": 1024,
           "band_keys": nb * 1024}
    # the function as one mask: row i sees the keys of its chunk's band
    # that lie past i - W
    pos = torch.arange(s, device="cuda")
    k0 = torch.tensor([1024 * attn._band_first(qs, BAND_WINDOW, 0, 1024, s,
                                               nb)
                       for qs in range(0, s, 512)],
                      device="cuda").repeat_interleave(512)[:, None]
    band_mask = (pos[None, :] > pos[:, None] - BAND_WINDOW) \
        & (pos[None, :] >= k0) & (pos[None, :] < k0 + nb * 1024)

    def plain(q, k, v):
        with patched(attn, "_kernel_route", lambda q: False):
            return attn.banded_attention(q, k, v, **kw)

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dtype) for x in (q32, k32, v32))
        zero_counts()
        got = attn.banded_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        launched = counts()
        want = plain(q.float(), k.float(), v.float())
        tol = _tol(FA_TOL, dtype)
        err = float((got.float() - want).abs().max())
        if launched != only(flash_attention=s // 512,
                            flash_attention_tc=(s // 512) * (dtype ==
                                                             torch.bfloat16)):
            fail(f"band route launches {launched}")
        if not _close(got, want, tol):
            fail(f"band route {dtype}: {err} from the plain computation "
                 f"(rtol, atol {tol})")
        full = kernel_ops.gqa_flash_attention(q, k, v, causal=False,
                                              window=BAND_WINDOW)
        cut = float((full.float() - got.float()).abs().max())
        if cut <= 100 * tol[1]:
            fail(f"band route {dtype}: the band's cut moves the output by "
                 f"{cut} only")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=band_mask)

        lib_out = library().transpose(1, 2)
        lib_err = float((lib_out.float() - want).abs().max())
        lib_ok = _close(lib_out, want, tol)
        del lib_out
        backend = _sdpa_backend(library)
        ms = median_ms(lambda: attn.banded_attention(q, k, v, **kw),
                       warmup=2, runs=5, per_run=3)
        full_ms = median_ms(lambda: kernel_ops.gqa_flash_attention(
            q, k, v, causal=False, window=BAND_WINDOW), warmup=2, runs=5,
            per_run=3)
        library_ms = median_ms(library, warmup=2, runs=5, per_run=3)
        # the launches' bounds summed: each q chunk against its band
        bound = sum(flash_bound_ms(
            (b, 512, h, d), (b, nb * 1024, h, d), q.element_size(), False,
            BAND_WINDOW, qs - 1024 * attn._band_first(
                qs, BAND_WINDOW, 0, 1024, s, nb))[0]
            for qs in range(0, s, 512))
        out[str(dtype).removeprefix("torch.")] = {
            "launches": launched, "max_abs_err": err, "tol": tol,
            "full_window_minus_band_max_abs": cut, "ms": ms,
            "bound_ms": bound, "one_launch_full_window_ms": full_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "library_within_tol": lib_ok,
            "library": f"scaled_dot_product_attention ({backend}), "
                       f"the band and window as one boolean mask"}
    # f32 gradients through each launch's FlashAttentionFn
    cot = torch.randn(b, s, h, d, generator=gen, device="cuda")

    def grads(fn):
        ins = [x.clone().requires_grad_(True) for x in (q32, k32, v32)]
        return torch.autograd.grad((fn(*ins) * cot).sum(), ins)

    zero_counts()
    got = grads(lambda q, k, v: attn.banded_attention(q, k, v, **kw))
    torch.cuda.synchronize()
    launched = counts()
    want = grads(plain)
    errs = {}
    for n, g, w in zip("qkv", got, want):
        err, _, ok = _grad_close(f"band route d{n}", g, w)
        if not ok:
            fail(f"band route d{n}: {err} from autograd of the plain "
                 f"computation (rtol {BWD_RTOL}, atol {BWD_ATOL} x max)")
        errs[n] = err
    if launched["flash_attention_bwd_dq"] != s // 512:
        fail(f"band route backward launches {launched}")
    out["f32_grads"] = {"max_abs_err": errs, "launches": launched}
    return out


# ---------------------------------------------------------------------
# The logit softcap in K4's two serving forwards
# ---------------------------------------------------------------------

SOFTCAP_CAPS = (50.0, 5.0)
# (b, s, t, h, hkv, causal, window, q_offset): causal with tails of S
# and T; causal under a window, q_offset past S; a non-causal window past
# T's start (rows that see few keys)
SOFTCAP_MASKS = ((1, 200, 200, 4, 2, True, 0, 0),
                 (1, 136, 264, 4, 2, True, 48, 128),
                 (1, 136, 264, 4, 2, False, 64, 96))
# q scaled by 2 caps of 50: normal q x 100, so that every score comes
# out of dot terms ~100x normal and carries their f32 rounding.  Both
# the f32 kernel (split TF32) and its f32 twin are held against the f64
# answer instead of each other, at F32_LARGE_TERM_TOL, and the kernel no
# farther from it than F32_LARGE_TERM_RATIO x the twin, in max abs and
# in root mean square, on every case.  The kernels' first design (the
# split cut toward zero, the score products chained on the tensor
# cores) read 1.2-2.5x in max abs at llama's serving layer (three draws)
# and up to 2.5x in root mean square on the small cases of
# softcap_checks.
LARGE_TERM_Q_FACTOR = 100.0
F32_LARGE_TERM_TOL = (2e-5, 1e-4)
F32_LARGE_TERM_RATIO = 1.5


def _f64_gate(dtype, cap) -> bool:
    """Whether an f32 case on q scaled by 2 caps has scores built of
    large terms (``LARGE_TERM_Q_FACTOR``): its output is then held,
    with its twin's, against the f64 answer."""
    import torch
    return dtype == torch.float32 and 2 * cap >= LARGE_TERM_Q_FACTOR


def f64_attention(q, k, v, cap, *, causal=True, window=0, q_offset=0):
    """The capped attention of ``gqa_plain`` computed in f64 (the twin
    itself computes in f32 whatever it is given), a batch row at a time:
    the exact answer."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    h, d = q.shape[2], q.shape[3]
    keep = fa._mask(q.shape[1], k.shape[1], causal, window, q_offset,
                    q.device)
    rows = []
    for i in range(q.shape[0]):
        qd = q[i].double().movedim(1, 0)
        kd, vd = (fa.repeat_kv_heads(x[i:i + 1], h)[0].double().movedim(1, 0)
                  for x in (k, v))
        sc = fa.softcap_scores(torch.einsum("hsd,htd->hst", qd, kd)
                               / math.sqrt(d), cap)
        p = torch.softmax(sc.masked_fill(~keep, fa.NEG), dim=-1)
        rows.append(torch.einsum("hst,htd->hsd", p, vd).movedim(0, 1))
        del sc, p
    return torch.stack(rows)


def check_against_f64(name, got, twin, q, k, v, cap, **kw):
    """The f32 kernel's output and its twin's, both held against
    ``f64_attention`` at ``F32_LARGE_TERM_TOL``; the kernel's max abs
    and root mean square distances from it each at most
    ``F32_LARGE_TERM_RATIO`` x the twin's; returns the distances."""
    import torch
    exact = f64_attention(q, k, v, cap, **kw)
    kd, td = got.double() - exact, twin.double() - exact
    row = {"kernel_vs_twin": float((got.float() - twin).abs().max()),
           "kernel_vs_f64": float(kd.abs().max()),
           "twin_vs_f64": float(td.abs().max()),
           "kernel_rms_vs_f64": float(kd.square().mean().sqrt()),
           "twin_rms_vs_f64": float(td.square().mean().sqrt()),
           "f64_tol": F32_LARGE_TERM_TOL,
           "ratio_limit": F32_LARGE_TERM_RATIO}
    del kd, td
    row["kernel_over_twin_vs_f64"] = row["kernel_vs_f64"] / max(
        row["twin_vs_f64"], 1e-30)
    row["kernel_over_twin_rms"] = row["kernel_rms_vs_f64"] / max(
        row["twin_rms_vs_f64"], 1e-30)
    rtol, atol = F32_LARGE_TERM_TOL
    for tag, x in (("kernel", got), ("twin", twin)):
        if not torch.allclose(x.double(), exact, rtol=rtol, atol=atol):
            fail(f"{name}: the {tag} is {row[f'{tag}_vs_f64']} from the f64 "
                 f"answer (rtol, atol {F32_LARGE_TERM_TOL})")
    for what, mine, theirs in (
            ("max abs", "kernel_vs_f64", "twin_vs_f64"),
            ("root mean square", "kernel_rms_vs_f64", "twin_rms_vs_f64")):
        if row[mine] > F32_LARGE_TERM_RATIO * row[theirs]:
            fail(f"{name}: the kernel is {row[mine]} from the f64 answer "
                 f"in {what}, more than {F32_LARGE_TERM_RATIO} x its "
                 f"twin's {row[theirs]}")
    del exact
    return row


def check_softcap(name, q, k, v, cap, *, f64_gate=False, **kw):
    """A softcap forward against its plain twin on the same card tensors
    at FA_TOL (with ``f64_gate``, both against the f64 answer:
    ``check_against_f64``), twice bit for bit, and the cap biting: the
    twin without it is more than 100x the tolerance away."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    got = fa.flash_attention(q, k, v, softcap=cap, **kw)
    again = fa.flash_attention(q, k, v, softcap=cap, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"softcap[{name}]: two runs differ")
    want = fa.gqa_plain(q.float(), k.float(), v.float(), softcap=cap, **kw)
    tol = _tol(FA_TOL, q.dtype)
    err = float((got.float() - want).abs().max())
    if not bool(torch.isfinite(got).all()) or (
            not f64_gate and not _close(got, want, tol)):
        fail(f"softcap[{name}]: {err} from its plain twin (rtol, atol "
             f"{tol})")
    row = {"case": name, "max_abs_err": err, "tol": tol}
    if f64_gate:
        row["f64"] = check_against_f64(f"softcap[{name}]", got, want, q, k,
                                       v, cap, **kw)
    uncapped = fa.gqa_plain(q.float(), k.float(), v.float(), **kw)
    row["cap_moves"] = float((uncapped - want).abs().max())
    if row["cap_moves"] <= 100 * tol[1]:
        fail(f"softcap[{name}]: the cap moves the output by "
             f"{row['cap_moves']} only")
    return row


def softcap_checks():
    """Every head dim in f32 and bf16, under ``SOFTCAP_MASKS``, at caps of
    50 and 5 with q scaled by 2 caps (scores reach several caps; f32 on
    q x 100 held against f64: ``LARGE_TERM_Q_FACTOR``); a cap
    with lse launches the capped lse forward (one launch, its output the
    serving forward's bit for bit, its lse the twin's); the forwards'
    launch sizes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    zero_counts()
    for d in HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for b, s, t, h, hkv, causal, window, off in SOFTCAP_MASKS:
                q = torch.randn(b, s, h, d, generator=gen, device="cuda")
                k, v = (torch.randn(b, t, hkv, d, generator=gen,
                                    device="cuda") for _ in range(2))
                for cap in SOFTCAP_CAPS:
                    rows.append(check_softcap(
                        f"d{d}-{str(dtype)[6:]}-"
                        f"{'causal' if causal else 'full'}-w{window}-"
                        f"off{off}-cap{cap:g}",
                        (q * (2 * cap)).to(dtype), k.to(dtype), v.to(dtype),
                        cap, f64_gate=_f64_gate(dtype, cap), causal=causal,
                        window=window, q_offset=off))
    launched = counts()
    n = len(rows) * 2
    if launched != only(flash_attention=n, flash_attention_softcap=n,
                        flash_attention_tc=n // 2):
        fail(f"softcap checks launched {launched}")
    q = torch.randn(1, 200, 2, 64, generator=gen, device="cuda") * 10.0
    served = fa.flash_attention(q, q, q, softcap=5.0)
    zero_counts()
    out, lse, _ = fa._kernel_forward(q, q, q, True, 0, 0, with_lse=True,
                                     softcap=5.0)
    torch.cuda.synchronize()
    if counts() != only(flash_attention=1, flash_attention_softcap=1):
        fail(f"softcap with lse launched {counts()}")
    lse_want = fa.flash_attention_fwd_plain(q, q, q, softcap=5.0)[1]
    if not torch.equal(out, served) \
            or not _close(lse, lse_want, FA_TOL["float32"]):
        fail(f"softcap with lse: out equal {torch.equal(out, served)}, lse "
             f"{float((lse - lse_want).abs().max())} from the twin's")
    return {"cases": rows, "launches": launched,
            "max_abs_err": {dt: max(r["max_abs_err"] for r in rows
                                    if dt in r["case"])
                            for dt in ("float32", "bfloat16")},
            "f32_large_terms_vs_f64": {
                tag: max(r["f64"][tag] for r in rows if "f64" in r)
                for tag in ("kernel_vs_f64", "twin_vs_f64",
                            "kernel_over_twin_vs_f64",
                            "kernel_over_twin_rms")},
            "fwd_sizes": {f"{str(dt)[6:]}_d{d}": fa.fwd_sizes(d, dt)
                          for d in HEAD_DIMS
                          for dt in (torch.float32, torch.bfloat16)}}


def _scaled_q_errors(q, k, v, factor, gated):
    """The softcap forward on normal q scaled by ``factor`` (scores of
    std ~``factor``/8 at D = 64 come out of dots whose terms are far
    larger, so each score carries the f32 rounding of those terms),
    against its f32 plain twin and both against the f64 answer: with
    ``gated``, held there (``check_against_f64``); without, reported
    (``tools/k4_variants.py`` compares variants by it)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    qs = (q.float() * factor).to(q.dtype)
    kw = dict(causal=True, softcap=SERVE_SOFTCAP)
    got = fa.flash_attention(qs, k, v, **kw).float()
    twin = fa.gqa_plain(qs.float(), k.float(), v.float(), **kw)
    if gated:
        out = check_against_f64(f"softcap q x {factor:g}", got, twin, qs, k,
                                v, SERVE_SOFTCAP, causal=True)
    else:
        exact = f64_attention(qs, k, v, SERVE_SOFTCAP, causal=True)
        out = {"kernel_vs_twin": float((got - twin).abs().max()),
               "kernel_vs_f64": float((got.double() - exact).abs().max()),
               "twin_vs_f64": float((twin.double() - exact).abs().max())}
        del exact
    del got, twin
    torch.cuda.empty_cache()
    return {"q_factor": factor, **out}


# flex_attention's compiles (a library yardstick no gate reads) put
# under build/, one compile thread each
FLEX_ENV = {"TORCHINDUCTOR_CACHE_DIR": str(ROOT / "build" / "inductor"),
            "TRITON_CACHE_DIR": str(ROOT / "build" / "triton"),
            "TORCHINDUCTOR_COMPILE_THREADS": "1"}


def _flex_softcap(q, k, v, cap):
    """The library yardstick of K4's causal softcap kernels (the port
    never calls it): ``flex_attention`` compiled, with ``cap * tanh(s /
    cap)`` as its ``score_mod``, a causal block mask and ``enable_gqa``,
    for q, k, v of shape (B, S, H, D).  Returns the call (q, k, v in
    that layout -> output (B, S, H, D); autograd through it gives dq,
    dk, dv) and the seconds to its first call's end on q, k, v, the
    block mask and the compile included."""
    import torch
    import torch._functorch.config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    # the backward is timed alone, again and again on one forward's graph
    # (retain_graph), which a backward with donated buffers refuses
    torch._functorch.config.donated_buffer = False

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def causal(b, h, q_idx, kv_idx):
        return q_idx >= kv_idx

    t0 = time.perf_counter()
    mask = create_block_mask(causal, None, None, q.shape[1], k.shape[1],
                             device="cuda")
    compiled = torch.compile(flex_attention, dynamic=False)

    def call(q_, k_, v_):
        return compiled(q_.transpose(1, 2), k_.transpose(1, 2),
                        v_.transpose(1, 2), score_mod=score_mod,
                        block_mask=mask, enable_gqa=True).transpose(1, 2)

    call(q, k, v)
    torch.cuda.synchronize()
    return call, time.perf_counter() - t0


def _flex_warm():
    """A spawned worker's body: compile, into ``FLEX_ENV``'s caches, the
    ``flex_attention`` graphs that ``lm_softcap_serve_path`` (the
    forward at llama's serving layer) and ``softcap_layer_times`` (the
    forward under grad and its backward at the training layer) time,
    in bf16 and f32, on tensors of the same shapes, dtypes and grad, so
    that their own compiles load from the caches."""
    import torch
    from repro_torch import set_full_f32
    from repro_torch.config import get_arch
    set_full_f32()
    cfg = get_arch(SOFTCAP_PREFILL[0])
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for (b, s), grad in ((SOFTCAP_PREFILL[1:], False),
                         (SOFTCAP_TRAIN[1:], True)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros(b, s, h, d, device="cuda", dtype=dtype)
            k, v = (torch.zeros(b, s, hkv, d, device="cuda", dtype=dtype)
                    for _ in "kv")
            if grad:
                q, k, v = (x.requires_grad_(True) for x in (q, k, v))
            call = _flex_softcap(q, k, v, SERVE_SOFTCAP)[0]
            if grad:
                torch.autograd.grad(call(q, k, v), (q, k, v),
                                    torch.zeros_like(q))
            del q, k, v, call
            torch.cuda.empty_cache()


def start_flex_warm():
    """Start ``_flex_warm`` in a spawned process; returns the process and
    its start time, for ``join_flex_warm``.  It overlaps the kernels'
    build and the phases after it, on one CPU core (as
    ``start_corpora``'s workers do), and runs each graph once on the
    card (milliseconds)."""
    import multiprocessing
    proc = multiprocessing.get_context("spawn").Process(target=_flex_warm,
                                                        daemon=True)
    proc.start()
    return proc, time.perf_counter()


def import_compiler():
    """Import dynamo and inductor (~14 s on the card's host), which
    ``flex_attention``'s compiles in this process need: in a thread
    while nvcc builds the kernels."""
    import torch._dynamo  # noqa: F401
    import torch._inductor.compile_fx  # noqa: F401


def join_flex_warm(warm):
    """Wait for ``start_flex_warm``'s worker: its exit code (not 0 leaves
    the caches cold, and the compiles in the timed phases then take
    their full time), seconds since its start, and seconds waited."""
    proc, t0 = warm
    t1 = time.perf_counter()
    proc.join(timeout=300)
    if proc.is_alive():
        proc.terminate()
        proc.join()
    return {"exitcode": proc.exitcode, "seconds": time.perf_counter() - t0,
            "waited_s": time.perf_counter() - t1}


# the cap of Gemma 2's published config (attn_logit_softcapping)
SERVE_SOFTCAP = 50.0
SOFTCAP_PREFILL = ("llama3.2-1b", 2, 4096)
SOFTCAP_DECODE_STEPS = 4
# the prefill == decode check (f32, CONSISTENCY_LAYERS deep): long
# enough for the chunked route (S*T > 256^2) in chunks of 64
SOFTCAP_CONSISTENCY_S = 320


def lm_softcap_serve_path():
    """llama3.2-1b at full width, all 16 layers in bf16, with the cap of
    50 (``dataclasses.replace(cfg, attn_logit_softcap=50.0)``): prefill
    at 2 x 4096 through ``make_prefill_step`` (K4's softcap forward once
    a layer) and a few decode steps through ``make_serve_step`` (the
    plain ring-cache decode), tokens/s beside the same model without a
    cap; then prefill == decode at CONSISTENCY_LAYERS in f32.  Then the
    softcap forward's ms at the prefill's layer shape beside the
    forward without a cap, its plain twin and its bound."""
    import dataclasses

    import torch
    from repro_torch.config.base import InputShape, TrainConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import decode_step, init_decode_state
    arch, b, s = SOFTCAP_PREFILL
    base, params = _lm_params(arch, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(14)
    toks = torch.randint(0, base.vocab_size, (b, s), generator=gen,
                         device="cuda")
    out = {"arch": arch, "num_layers": base.num_layers, "batch": b,
           "seq_len": s, "softcap": SERVE_SOFTCAP, "dtype": "bfloat16"}
    logits = {}
    for cap in (SERVE_SOFTCAP, 0.0):
        cfg = dataclasses.replace(base, attn_logit_softcap=cap)
        prefill = make_prefill_step(cfg, TrainConfig())
        prefill(params, {"tokens": toks})          # warm
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[cap] = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launched = counts()
        want = only(flash_attention=cfg.num_layers,
                    flash_attention_tc=cfg.num_layers,
                    flash_attention_softcap=cfg.num_layers * (cap > 0))
        if launched != want:
            fail(f"softcap prefill (cap {cap}) launches {launched}")
        shape = InputShape("serve", SOFTCAP_DECODE_STEPS + 2, b, "decode")
        step = make_serve_step(cfg, shape, TrainConfig())
        state = init_decode_state(cfg, b, SOFTCAP_DECODE_STEPS + 2,
                                  dtype=torch.bfloat16, device="cuda")
        dec, state = step(params, state, {"tokens": toks[:, :1]})  # warm
        tok = torch.argmax(dec[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SOFTCAP_DECODE_STEPS):
            dec, state = step(params, state, {"tokens": tok})
            tok = torch.argmax(dec[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if not bool(torch.isfinite(logits[cap]).all()) \
                or not bool(torch.isfinite(dec).all()):
            fail(f"softcap serve (cap {cap}): non-finite logits")
        out["with_cap" if cap else "without_cap"] = {
            "prefill_s": prefill_s, "prefill_tokens_per_s": b * s / prefill_s,
            "decode_steps": SOFTCAP_DECODE_STEPS,
            "decode_tokens_per_s": b * SOFTCAP_DECODE_STEPS / decode_s,
            "launches_prefill": launched}
    moved = float((logits[SERVE_SOFTCAP].float()
                   - logits[0.0].float()).abs().max())
    out["cap_moves_logits"] = moved
    del params, logits
    torch.cuda.empty_cache()

    # prefill == decode, f32, CONSISTENCY_LAYERS deep
    cfg, params = _lm_params(arch, torch.float32,
                             num_layers=CONSISTENCY_LAYERS)
    cfg = dataclasses.replace(cfg, attn_logit_softcap=SERVE_SOFTCAP)
    ctoks = torch.randint(0, cfg.vocab_size, (1, SOFTCAP_CONSISTENCY_S),
                          generator=gen, device="cuda")
    prefill = make_prefill_step(cfg, TrainConfig(attn_chunk_q=64,
                                                 attn_chunk_kv=64))
    zero_counts()
    got = prefill(params, {"tokens": ctoks})
    torch.cuda.synchronize()
    if counts() != only(flash_attention=cfg.num_layers,
                        flash_attention_softcap=cfg.num_layers):
        fail(f"softcap consistency prefill launches {counts()}")
    state = init_decode_state(cfg, 1, SOFTCAP_CONSISTENCY_S,
                              dtype=torch.float32, device="cuda")
    for i in range(SOFTCAP_CONSISTENCY_S):
        dec, state = decode_step(cfg, params, state, ctoks[:, i:i + 1])
    torch.cuda.synchronize()
    vs_decode = float((got - dec[:, -1]).abs().max())
    if vs_decode > CONSISTENCY_ATOL or \
            not torch.equal(got.argmax(-1), dec[:, -1].argmax(-1)):
        fail(f"softcap prefill vs decode {vs_decode} (atol "
             f"{CONSISTENCY_ATOL})")
    out["consistency"] = {"num_layers": cfg.num_layers,
                          "seq_len": SOFTCAP_CONSISTENCY_S,
                          "dtype": "float32",
                          "prefill_vs_decode_max_abs": vs_decode,
                          "atol": CONSISTENCY_ATOL}
    del params, state
    torch.cuda.empty_cache()

    # the layer's forward with and without the cap, in turns; gated
    # against the plain twin at this shape on the timed inputs and on q
    # scaled by 2 caps (scores reach several caps, so the cap bites)
    h, hkv, d = base.n_heads, base.n_kv_heads, base.head_dim
    times = []
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(b, s, h, d, generator=gen, device="cuda",
                        dtype=dtype)
        k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda",
                            dtype=dtype) for _ in range(2))

        def fwd(cap):
            return lambda: fa.flash_attention(q, k, v, causal=True,
                                              softcap=cap)

        cap_a = median_ms(fwd(SERVE_SOFTCAP), warmup=2, runs=5, per_run=5)
        none_a = median_ms(fwd(0.0), warmup=2, runs=5, per_run=5)
        cap_b = median_ms(fwd(SERVE_SOFTCAP), warmup=2, runs=5, per_run=5)
        none_b = median_ms(fwd(0.0), warmup=2, runs=5, per_run=5)
        bound = flash_softcap_bound_ms(q.shape, k.shape, q.element_size(),
                                       True, 0, 0)
        tol = _tol(FA_TOL, dtype)
        want = fa.gqa_plain(q.float(), k.float(), v.float(), causal=True,
                            softcap=SERVE_SOFTCAP)
        got = fa.flash_attention(q, k, v, causal=True, softcap=SERVE_SOFTCAP)
        err = float((got.float() - want).abs().max())
        if not bool(torch.isfinite(got).all()) or not _close(got, want, tol):
            fail(f"softcap llama layer {dtype}: {err} from its plain twin "
                 f"(rtol, atol {tol})")
        library, library_compile_s = _flex_softcap(q, k, v, SERVE_SOFTCAP)
        library_ms = median_ms(lambda: library(q, k, v), warmup=2, runs=5,
                               per_run=5)
        lib_out = library(q, k, v)
        library_err = float((lib_out.float() - want).abs().max())
        library_ok = _close(lib_out, want, tol)
        del want, got, library, lib_out
        # the cap biting at this shape: integer q in [-64, 64] and k in
        # [-6, 6], so that every score is exact in f32, in split TF32 and
        # from bf16 inputs (|q.k| <= 64*64*6 < 2^24; the scale 1/8 is a
        # power of two) and reaches several caps (std ~140)
        qi = torch.randint(-64, 65, q.shape, generator=gen, device="cuda")
        ki = torch.randint(-6, 7, k.shape, generator=gen, device="cuda")
        bites = check_softcap(
            f"llama-layer-{str(dtype)[6:]}-cap{SERVE_SOFTCAP:g}-exact-scores",
            qi.to(dtype), ki.to(dtype), v, SERVE_SOFTCAP, causal=True)
        del qi, ki
        scaled = _scaled_q_errors(q, k, v, 2 * SERVE_SOFTCAP,
                                  _f64_gate(dtype, SERVE_SOFTCAP))
        times.append({"dtype": str(dtype)[6:], "q": list(q.shape),
                      "k": list(k.shape), "causal": True,
                      "ms": min(cap_a, cap_b),
                      "without_cap_ms": min(none_a, none_b),
                      "cap_over_without": min(cap_a, cap_b)
                      / min(none_a, none_b),
                      "plain_ms": _once_ms(lambda: fa.gqa_plain(
                          q, k, v, causal=True, softcap=SERVE_SOFTCAP)),
                      "bound_ms": bound[0], "bound_by": bound[1],
                      "bound_ops": bound[2],
                      # bf16: the floor of its tanh (softcap_r)
                      "design_sfu_floor_ms": sfu_floor_ms(
                          q.shape, k.shape, SOFTCAP_TC_SFU_PER_PAIR)
                      if dtype == torch.bfloat16 else None,
                      "max_abs_err": err, "tol": tol,
                      "exact_scores_cap_bites": bites,
                      "q_scaled_by_2_caps": scaled,
                      "library_ms": library_ms,
                      "library_max_abs_err": library_err,
                      "library_within_tol": library_ok,
                      "library_compile_s": library_compile_s,
                      "library": "flex_attention (torch.compile), tanh "
                                 "score_mod, causal block mask, "
                                 "enable_gqa"})
    out["forward_times"] = times
    return out


# ---------------------------------------------------------------------
# Training with a logit softcap: K4's lse forwards and both backward
# pairs with a cap
# ---------------------------------------------------------------------

def check_softcap_bwd(name, q, k, v, do, cap, *, f64_gate=False, **kw):
    """K4's capped forward with lse and its capped backward pair on card
    tensors of q's dtype (f32 or bf16) through ``flash_attention`` with
    grad: the launches exact; the gradients twice bit for bit and
    against autograd of ``gqa_plain`` with the cap in f32 on the upcast
    inputs (``_grad_close``, ``_grad_close_bf16``); the cap biting (the
    twin's gradients without it more than 100x the atol away); the
    forward with lse: its out the Function's, and out (FA_TOL), lse
    (FA_TOL f32, atol scaled by max(1, max |lse|): a capped score of
    magnitude up to the cap carries the f32 rounding of its terms, as
    the gradients' atol is scaled) and, in bf16, out + out_lo against
    ``flash_attention_fwd_plain`` with the cap; with ``f64_gate`` (f32
    on scores built of large terms) the out and the twin's are held
    against the f64 answer instead (``check_against_f64``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    bf16 = q.dtype == torch.bfloat16
    ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
    before = counts()
    out = fa.flash_attention(*ins, softcap=cap, **kw)
    got = torch.autograd.grad(out, ins, do)
    again = torch.autograd.grad(fa.flash_attention(*ins, softcap=cap, **kw),
                                ins, do)
    torch.cuda.synchronize()
    launched = _launched_since(before)
    want_launched = {
        "flash_attention": 2, "flash_attention_softcap": 2,
        "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkdv": 2,
        "flash_attention_softcap_bwd": 4,
        **({"flash_attention_tc": 2, "flash_attention_bwd_dq_bf16": 2,
            "flash_attention_bwd_dkdv_bf16": 2} if bf16 else {})}
    if launched != want_launched:
        fail(f"softcap_bwd[{name}]: launches {launched}, expected "
             f"{want_launched}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"softcap_bwd[{name}]: two runs differ")
    if any(g.dtype != q.dtype for g in got):
        fail(f"softcap_bwd[{name}]: gradient dtypes {[g.dtype for g in got]}")
    o, lse, o_lo = fa._kernel_forward(q, k, v, kw.get("causal", True),
                                      kw.get("window", 0),
                                      kw.get("q_offset", 0), with_lse=True,
                                      softcap=cap)
    full_want, lse_want = fa.flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), softcap=cap, **kw)
    row = {"case": name, "q": list(q.shape), "k": list(k.shape),
           "softcap": cap, **kw,
           "out_max_abs_err": float((o.float() - full_want).abs().max()),
           "lse_max_abs_err": float((lse - lse_want).abs().max())}
    if not torch.equal(o, out.detach()):
        fail(f"softcap_bwd[{name}]: the forward with lse differs from the "
             "Function's output")
    lse_rtol, lse_atol = FA_TOL["float32"]
    lse_tol = (lse_rtol, lse_atol * max(1.0, float(lse_want.abs().max())))
    row["lse_tol"] = lse_tol
    if f64_gate:
        row["f64"] = check_against_f64(f"softcap_bwd[{name}]", o, full_want,
                                       q, k, v, cap, **kw)
    if (not f64_gate and not _close(o, full_want, _tol(FA_TOL, q.dtype))) \
            or not _close(lse, lse_want, lse_tol):
        fail(f"softcap_bwd[{name}]: the forward with lse is "
             f"{row['out_max_abs_err']} (out) / {row['lse_max_abs_err']} "
             f"(lse) from its plain twin")
    if bf16:
        full = o.float() + o_lo.float()
        row["out_plus_out_lo_max_abs_err"] = float((full - full_want).abs()
                                                   .max())
        if not _close(full, full_want, BF16_OUT_LO_TOL):
            fail(f"softcap_bwd[{name}]: out + out_lo is "
                 f"{row['out_plus_out_lo_max_abs_err']} from the twin's "
                 f"f32 output (rtol, atol {BF16_OUT_LO_TOL})")
    ref = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(fa.gqa_plain(*ref, softcap=cap, **kw), ref,
                               do.float())
    without = torch.autograd.grad(fa.gqa_plain(*ref, **kw), ref, do.float())
    close, (rtol, atol) = ((_grad_close_bf16, BF16_BWD_TOL) if bf16
                           else (_grad_close, (BWD_RTOL, BWD_ATOL)))
    for tag, a, b, c in zip(("dq", "dk", "dv"), got, want, without):
        err, scale, ok = close(f"softcap_bwd[{name}].{tag}", a, b)
        bite = float((c - b).abs().max())
        row[f"{tag}_max_abs_err"] = err
        row[f"{tag}_scale"] = scale
        row[f"{tag}_cap_moves"] = bite
        if not ok:
            fail(f"softcap_bwd[{name}]: {tag} disagrees with autograd of "
                 f"the capped plain twin, max abs err {err} (rtol {rtol}, "
                 f"atol {atol} x {scale})")
        if bite <= 100 * atol * scale:
            fail(f"softcap_bwd[{name}]: the cap moves {tag} by {bite} only "
                 f"(100 x atol {atol} x {scale})")
    return row


def softcap_bwd_checks():
    """The capped training kernels at every head dim in f32 and bf16,
    under ``SOFTCAP_MASKS``, at caps of 50 and 5 with q scaled by 2 caps
    (scores reach several caps; f32 on q x 100 held against f64):
    ``check_softcap_bwd`` each; the launch counts of the whole phase
    exact."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(41)
    rows = []
    zero_counts()
    for d in HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for b, s, t, h, hkv, causal, window, off in SOFTCAP_MASKS:
                q, do = (torch.randn(b, s, h, d, generator=gen,
                                     device="cuda") for _ in "qd")
                k, v = (torch.randn(b, t, hkv, d, generator=gen,
                                    device="cuda") for _ in "kv")
                for cap in SOFTCAP_CAPS:
                    rows.append(check_softcap_bwd(
                        f"d{d}-{str(dtype)[6:]}-"
                        f"{'causal' if causal else 'full'}-w{window}-"
                        f"off{off}-cap{cap:g}",
                        (q * (2 * cap)).to(dtype), k.to(dtype), v.to(dtype),
                        do.to(dtype), cap, f64_gate=_f64_gate(dtype, cap),
                        causal=causal, window=window, q_offset=off))
    n = len(rows)
    want = only(flash_attention=3 * n, flash_attention_softcap=3 * n,
                flash_attention_tc=3 * n // 2,
                flash_attention_bwd_dq=2 * n, flash_attention_bwd_dkdv=2 * n,
                flash_attention_bwd_dq_bf16=n,
                flash_attention_bwd_dkdv_bf16=n,
                flash_attention_softcap_bwd=4 * n)
    if counts() != want:
        fail(f"softcap_bwd_checks launched {counts()}, expected {want}")
    worst = {dt: {tag: max(r[f"{tag}_max_abs_err"] for r in rows
                           if dt in r["case"]) for tag in ("dq", "dk", "dv")}
             for dt in ("float32", "bfloat16")}
    return {"cases": len(rows), "rows": rows, "launches": counts(),
            "max_abs_err": worst,
            "f32_large_terms_vs_f64": {
                tag: max(r["f64"][tag] for r in rows if "f64" in r)
                for tag in ("kernel_vs_f64", "twin_vs_f64",
                            "kernel_over_twin_vs_f64",
                            "kernel_over_twin_rms")},
            "cap_moves_min": min(min(r[f"{t}_cap_moves"] / r[f"{t}_scale"]
                                     for t in ("dq", "dk", "dv"))
                                 for r in rows)}


# llama3.2-1b bf16 training with Gemma 2's cap: LM_TRAIN's llama shape,
# three steps a run, two seeded runs
SOFTCAP_TRAIN = ("llama3.2-1b", 2, 2048)
SOFTCAP_TRAIN_STEPS = 3
# the cap of the one-block gradient check: the block's scores at init
# have std ~0.8, so a cap of 50 moves no leaf's gradient by more than
# 0.2 % of its largest |gradient| (a CPU estimate at S = 512), a cap of
# 2 the MLP's by 1.6 % at S = 2048, and a cap of 1 every leaf by 2.6-72 %
SOFTCAP_BLOCK_CAP = 1.0


def _flex_layer(q, k, v, do, cap):
    """``_flex_softcap`` at a training layer: its forward under grad (out
    and the lse it keeps for the backward: the capped forward with lse's
    yardstick) and its backward alone (autograd of that forward: dq, dk
    and dv, the capped pair's), each timed and its compile's seconds;
    out and the gradients against the plain twin (``gqa_plain``, autograd
    of it) at the tolerances of ``check_softcap_bwd``, reported."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
    call, fwd_compile_s = _flex_softcap(*ins, cap)
    out = call(*ins)
    t0 = time.perf_counter()
    grads = torch.autograd.grad(out, ins, do, retain_graph=True)
    torch.cuda.synchronize()
    bwd_compile_s = time.perf_counter() - t0
    row = {"name": "flex_attention (torch.compile), tanh score_mod, causal "
                   "block mask, enable_gqa; its forward under grad and "
                   "its backward",
           "fwd_lse_ms": median_ms(lambda: call(*ins), warmup=2, runs=5,
                                   per_run=3),
           "bwd_ms": median_ms(lambda: torch.autograd.grad(
               out, ins, do, retain_graph=True), warmup=2, runs=5,
               per_run=3),
           "bwd_covers": "dq, dk and dv (both kernels' work)",
           "compile_s": {"fwd": fwd_compile_s, "bwd": bwd_compile_s}}
    ref = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    want = fa.gqa_plain(*ref, softcap=cap)
    row["out_max_abs_err"] = float((out.float() - want).abs().max())
    wants = torch.autograd.grad(want, ref, do.float())
    row["grads_max_abs_err"] = {t: float((a.float() - w).abs().max())
                                for t, a, w in zip(("dq", "dk", "dv"), grads,
                                                   wants)}
    row["grads_scale"] = {t: float(w.abs().max())
                          for t, w in zip(("dq", "dk", "dv"), wants)}
    del ins, call, out, grads, ref, want, wants
    torch.cuda.empty_cache()
    return row


def softcap_layer_times(gen):
    """At llama's training layer (q (2,2048,32,64), kv 8, causal), bf16
    and f32, with the cap of 50 and without, in turns: the forward with
    lse, dq and dkdv alone (direct launches of the built libraries, not
    counted) and the pair through the wrapper's backward, each beside
    its bound (two SFU operations a visible pair with the cap) and the
    plain computation's ms; the capped kernels gated against the twin
    (FA_TOL on the forward, the backward tolerances on the gradients)
    on two inputs: the integer exact-score inputs of
    ``lm_softcap_serve_path`` and normal q scaled by 2 caps (the f32
    forward's output on the latter held against the f64 answer);
    ``flex_attention``'s forward and backward on the timed inputs
    (``_flex_layer``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    arch, b, s = SOFTCAP_TRAIN
    h, hkv, d = 32, 8, 64
    qs, ks = (b, s, h, d), (b, s, hkv, d)
    cap = SERVE_SOFTCAP
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        q, do = (torch.randn(qs, generator=gen, device="cuda").to(dtype)
                 for _ in "qd")
        k, v = (torch.randn(ks, generator=gen, device="cuda").to(dtype)
                for _ in "kv")
        lib = fa._bwd_lib(dtype)
        dq_entry, dkdv_entry = (getattr(lib, n)
                                for n in fa._BWD_ENTRIES[dtype])
        calls = {}
        for c in (cap, 0.0):
            o, lse, o_lo = fa._kernel_forward(q, k, v, True, 0, 0,
                                              with_lse=True, softcap=c)
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            delta = torch.empty((b, h, s), device="cuda")
            args = (b, s, s, h, hkv, d, 1, 0, 0, 1.0 / math.sqrt(d))

            def dq_kernel(o=o, lse=lse, o_lo=o_lo, dq=dq, delta=delta, c=c):
                dq_entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(),
                         *((o_lo.data_ptr(),) if bf16 else ()),
                         do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                         dq.data_ptr(), *args,
                         torch.cuda.current_stream().cuda_stream, c)

            def dkdv_kernel(lse=lse, delta=delta, dk=dk, dv=dv, c=c):
                dkdv_entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), *args,
                           torch.cuda.current_stream().cuda_stream, c)

            dq_kernel()                    # delta for the dkdv timing
            calls[c] = {
                "fwd_lse": lambda c=c: fa._kernel_forward(
                    q, k, v, True, 0, 0, with_lse=True, softcap=c),
                "dq": dq_kernel, "dkdv": dkdv_kernel,
                "pair": lambda o=o, lse=lse, o_lo=o_lo, c=c:
                    fa._kernel_backward(q, k, v, o, lse, do, True, 0, 0,
                                        o_lo, c)}
        turns = {c: {n: [] for n in calls[c]} for c in calls}
        for _ in range(2):
            for c in (cap, 0.0):
                for name, fn in calls[c].items():
                    turns[c][name].append(median_ms(fn, warmup=2, runs=3,
                                                    per_run=3))
        row = {"dtype": str(dtype)[6:], "q": list(qs), "k": list(ks),
               "causal": True, "softcap": cap,
               "library": _flex_layer(q, k, v, do, cap)}
        o, lse, o_lo = fa._kernel_forward(q, k, v, True, 0, 0,
                                          with_lse=True, softcap=cap)
        o_full = o.float() + o_lo.float() if bf16 else o
        row["plain_ms"] = {
            "fwd_lse": _once_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, softcap=cap)),
            "pair": _once_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o_full, lse, do, softcap=cap))}
        bound = flash_bwd_bf16_bound_ms if bf16 else flash_bwd_bound_ms
        work = (FA_BWD_BF16_WORK + (("fwd_lse",) + FA_FWD_BF16_WORK,)
                if bf16 else FA_BWD_WORK + (("fwd_lse",) + FA_FWD_WORK,))
        for name, dots, reads, writes in work:
            ms = min(turns[cap][name])
            without = min(turns[0.0][name])
            bd = bound(qs, ks, dots, reads, writes,
                       sfu_per_pair=SOFTCAP_SFU_PER_PAIR)
            # bf16: the floor of its tanh (softcap_r), in both kernels
            # of the pair
            floor = sfu_floor_ms(qs, ks, SOFTCAP_TC_SFU_PER_PAIR
                                 * (2 if name == "pair" else 1)) \
                if bf16 else None
            row[name] = {"ms": ms, "without_cap_ms": without,
                         "cap_over_without": ms / without,
                         "bound_ms": bd["ms"], "bound_by": bd["by"],
                         "design_sfu_floor_ms": floor,
                         "rate_on_bound": bd["ms"] / ms,
                         "turns_ms": turns[cap][name],
                         "without_cap_turns_ms": turns[0.0][name]}
        row["gates"] = {}
        # the integer exact-score inputs (every score exact in f32, in
        # split TF32 and from bf16 inputs; std ~140: several caps)
        qi = torch.randint(-64, 65, qs, generator=gen,
                           device="cuda").to(dtype)
        ki = torch.randint(-6, 7, ks, generator=gen, device="cuda").to(dtype)
        row["gates"]["exact_scores"] = check_softcap_bwd(
            f"llama-layer-{str(dtype)[6:]}-exact-scores", qi, ki, v, do,
            cap, causal=True)
        del qi, ki
        qc = (q.float() * (2 * cap)).to(dtype)
        row["gates"]["q_scaled_by_2_caps"] = check_softcap_bwd(
            f"llama-layer-{str(dtype)[6:]}-q-x{2 * cap:g}", qc, k, v, do,
            cap, f64_gate=_f64_gate(dtype, cap), causal=True)
        del qc, calls
        torch.cuda.empty_cache()
        out.append(row)
    return out


def lm_softcap_train_path(bf16_train):
    """llama3.2-1b at full width (16 layers, 32 / 8 heads, D = 64),
    bf16 ``make_train_step(cfg, TrainConfig())`` with Gemma 2's cap of
    50 (``dataclasses.replace(cfg, attn_logit_softcap=50.0)``) at
    ``SOFTCAP_TRAIN``'s shape, ``SOFTCAP_TRAIN_STEPS`` steps: warm
    s/step and tokens/s beside ``lm_bf16_train_path``'s llama step (the
    same call's), first step, peak memory; the exact launches a step
    (remat full: the capped bf16 forward with lse twice a layer, the
    capped dq and dkdv once, no K4 launch without the cap); finite
    losses; two seeded runs equal bit for bit in losses, parameters and
    moments.  Then one full-width llama block's gradients with a cap
    (``SOFTCAP_BLOCK_CAP``) through the kernels against the plain twins
    in f32 and bf16 (``lm_block_grads_vs_plain``), and the capped
    kernels' times at the layer (``softcap_layer_times``)."""
    import math
    import statistics
    import torch
    from repro_torch.tree import tree_leaves
    arch, b, s = SOFTCAP_TRAIN

    def run():
        return _bf16_train_run(arch, b, s, softcap=SERVE_SOFTCAP,
                               steps=SOFTCAP_TRAIN_STEPS)

    r = run()
    n = r["layers"] * SOFTCAP_TRAIN_STEPS
    want = only(flash_attention=2 * n, flash_attention_tc=2 * n,
                flash_attention_softcap=2 * n,
                flash_attention_bwd_dq=n, flash_attention_bwd_dkdv=n,
                flash_attention_bwd_dq_bf16=n,
                flash_attention_bwd_dkdv_bf16=n,
                flash_attention_softcap_bwd=2 * n)
    if r["launches"] != want:
        fail(f"lm_softcap_train_path: launches {r['launches']}, expected "
             f"{want}")
    if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
        fail(f"lm_softcap_train_path: losses {r['losses']}, grad norms "
             f"{r['grad_norms']}")
    first = [t.clone() for t in tree_leaves((r["params"], r["state"]))]
    row = {"arch": arch, "batch": b, "seq": s, "dtype": "bfloat16",
           "softcap": SERVE_SOFTCAP,
           "train_config": "TrainConfig() (remat full, AdamW, clip 1.0)",
           "layers": r["layers"], "steps": SOFTCAP_TRAIN_STEPS,
           "losses": r["losses"], "grad_norms": r["grad_norms"],
           "step_s": r["step_s"], "first_step_s": r["step_s"][0],
           "warm_s_per_step": statistics.median(r["step_s"][1:]),
           "peak_bytes": r["peak_bytes"], "launches": r["launches"],
           "launches_per_step": {k: v // SOFTCAP_TRAIN_STEPS
                                 for k, v in r["launches"].items() if v}}
    row["tokens_per_s"] = b * s / row["warm_s_per_step"]
    plain = next(x for x in bf16_train["runs"] if x["arch"] == arch)
    row["without_cap"] = {k: plain[k] for k in (
        "warm_s_per_step", "tokens_per_s", "first_step_s", "peak_bytes")}
    row["step_over_without_cap"] = (row["warm_s_per_step"]
                                    / plain["warm_s_per_step"])
    losses = r["losses"]
    r = None
    torch.cuda.empty_cache()
    again = run()
    same = again["losses"] == losses and all(
        torch.equal(a, c) for a, c in zip(
            first, tree_leaves((again["params"], again["state"]))))
    if not same:
        fail(f"lm_softcap_train_path: two seeded runs differ: {losses} vs "
             f"{again['losses']}")
    row["second_run_bitwise_equal"] = True
    row["second_run_step_s"] = again["step_s"]
    del first, again
    torch.cuda.empty_cache()
    blocks = [lm_block_grads_vs_plain(dt, arch="llama3.2-1b",
                                      softcap=SOFTCAP_BLOCK_CAP)
              for dt in (torch.float32, torch.bfloat16)]
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(43)
    return {"train": row, "block_grads_vs_plain": blocks,
            "layer_times": softcap_layer_times(gen)}


def run_phases(warm) -> int:
    """Every phase in order; the last two lines are the kernels line and
    the result line.  ``warm``: ``start_flex_warm``'s worker, joined
    before the softcap phases, whose ``flex_attention`` compiles load
    from its caches."""
    import torch
    from repro_torch import set_full_f32
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    set_full_f32()

    importer = threading.Thread(target=import_compiler)
    importer.start()
    t0 = time.perf_counter()
    libs = _build.build(["fedagg", "flash_attention", "flash_attention_bwd",
                         "flash_attention_bwd_tc", "ssm_scan",
                         "ssm_scan_bwd"])
    build_s = time.perf_counter() - t0
    importer.join()
    emit({"phase": "build", "seconds": build_s,
          "imports_waited_s": time.perf_counter() - t0 - build_s,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()}})

    emit({"phase": "kernel_checks", "rtol": RTOL, "atol": ATOL,
          "fedagg": fedagg_cases(), "fedagg_fold": fold_cases(),
          "fedagg_partial": partial_cases(),
          "flash_attention_tol": FA_TOL, "flash_attention": flash_cases(),
          "ssm_scan_tol": SS_TOL, "ssm_scan": ssm_cases()})
    emit({"phase": "kernel_bwd_checks", "card": card,
          **kernel_bwd_checks()})
    emit({"phase": "train_round_vs_cpu", **cpu_agreement()})

    summary, launches, shapes, summary_hist = main_path()
    emit({"phase": "main_path", **summary})

    async_summary, fold_launches, fold_calls = async_path()
    emit({"phase": "async_path", **async_summary})

    emit({"phase": "traced_main_path", "card": card, **traced_main_path()})
    traced_async, f32_async = traced_async_path()
    emit({"phase": "traced_async_path", "card": card, **traced_async})
    quant = quant_async_path(f32_async)
    emit({"phase": "quant_async_path", "card": card, **quant})
    tiered = tiered_async_path()
    emit({"phase": "tiered_async_path", "card": card, **tiered})

    mesh_summary, mesh_counts, partial_calls = mesh_path(summary_hist)
    emit({"phase": "mesh_path", **mesh_summary})
    emit({"phase": "mesh_async_path", **mesh_async_path()})
    secure = secure_agg_path()
    emit({"phase": "secure_agg_path", "card": card, **secure})

    models = {}
    prefill, attn_calls = lm_prefill_path(models)
    emit({"phase": "lm_prefill_path", "card": card, "runs": prefill})
    serve = lm_serve_path(models)
    emit({"phase": "lm_serve_path", "card": card, **serve})
    emit({"phase": "lm_bf16_kernel_vs_plain",
          **lm_bf16_kernel_vs_plain(models)})
    # the LM mesh's hymba prefill on these weights (lm_mesh_path)
    cp_prefills = {"hymba-1.5b": mesh_cp_prefill(*models["hymba-1.5b"],
                                                 *LM_PREFILL[0][1:3])}
    models.clear()
    torch.cuda.empty_cache()
    emit({"phase": "lm_consistency", **lm_consistency()})
    lm_train, per_step = lm_train_path()
    emit({"phase": "lm_train_path", "card": card, **lm_train})
    bf16_train, bf16_per_step = lm_bf16_train_path()
    emit({"phase": "lm_bf16_train_path", "card": card, **bf16_train})
    fl_lm = fl_lm_path()
    emit({"phase": "fl_lm_path", "card": card, "runs": fl_lm})
    moe_serve, moe_calls = lm_moe_serve_path()
    emit({"phase": "lm_moe_serve_path", "card": card, **moe_serve})
    wide_rows, wide_calls = lm_wide_head_prefill(cp_prefills)
    emit({"phase": "lm_wide_head_prefill", "card": card, "runs": wide_rows})
    lm_mesh = lm_mesh_path(cp_prefills, fl_lm)
    emit({"phase": "lm_mesh_path", "card": card, **lm_mesh})
    emit({"phase": "lm_moe_consistency", **lm_moe_consistency()})
    wide_train, per_step[WIDE_TRAIN[0]] = lm_wide_train_step()
    emit({"phase": "lm_wide_train_step", "card": card, **wide_train})
    moe_train, per_step[MOE_TRAIN[0]] = lm_moe_train_step()
    emit({"phase": "lm_moe_train_step", "card": card, **moe_train})
    emit({"phase": "lm_xlstm_serve_path", "card": card,
          **lm_xlstm_serve_path()})
    emit({"phase": "lm_xlstm_consistency", **lm_xlstm_consistency()})
    emit({"phase": "lm_xlstm_train_step", "card": card,
          **lm_xlstm_train_step()})
    audio, audio_calls = lm_audio_encode_path()
    emit({"phase": "lm_audio_encode_path", "card": card, **audio})
    audio_train, per_step[AUDIO] = lm_audio_train_step()
    emit({"phase": "lm_audio_train_step", "card": card, **audio_train})
    rows = fedagg_rows_checks()
    emit({"phase": "fedagg_past_4096_rows", "card": card, **rows})
    fl_rows = fl_past_4096_rows()
    emit({"phase": "fl_past_4096_rows", "card": card, **fl_rows})
    band = band_route_path()
    emit({"phase": "band_route_path", "card": card, **band})
    emit({"phase": "flex_warm", **join_flex_warm(warm)})
    cap_checks = softcap_checks()
    emit({"phase": "softcap_checks", **cap_checks})
    cap_serve = lm_softcap_serve_path()
    emit({"phase": "lm_softcap_serve_path", "card": card, **cap_serve})
    cap_bwd = softcap_bwd_checks()
    emit({"phase": "softcap_bwd_checks", **cap_bwd})
    cap_train = lm_softcap_train_path(bf16_train)
    emit({"phase": "lm_softcap_train_path", "card": card, **cap_train})

    at_main = fedagg_times(MAIN_N, MAIN_P)
    seen = [fedagg_times(n, p)
            for n, p in sorted({(n, p) for n, p, _ in shapes})]
    emit({"phase": "fedagg_times", "card": card,
          "at_full_cohort_shape": at_main, "at_main_path_shapes": seen,
          "k1_against_library": k1_against_library(at_main)})

    import numpy as np
    from repro_torch.core.aggregation import staleness_merge_coefficients
    full = staleness_merge_coefficients(
        np.random.default_rng(4).uniform(0.1, 0.9, FOLD_K))
    fold_at_k = fedagg_fold_times(FOLD_K, MAIN_P, full)
    # one timing per distinct (rows, coefficient vector) the path formed
    distinct = {(k, p, tuple(c)): c for k, p, _, _, c in fold_calls}
    fold_seen = [fedagg_fold_times(k, p, np.asarray(c, np.float32))
                 for (k, p, _), c in sorted(distinct.items())]
    emit({"phase": "fedagg_fold_times", "card": card,
          f"at_k{FOLD_K}": fold_at_k, "at_async_path_shapes": fold_seen})

    full_r = fedagg_partial_times(
        PARTIAL_R, MAIN_P,
        np.random.default_rng(7).uniform(0.05, 1.0, PARTIAL_R)
        .astype(np.float32))
    # one timing per distinct (rows, live rows) the path formed: the
    # time depends on which rows are live, not on their coefficients
    distinct_c = {(r, p, tuple(x > 0 for x in c)): c
                  for r, p, _, c in partial_calls if any(x > 0 for x in c)}
    partial_seen = [fedagg_partial_times(r, p, np.asarray(c, np.float32))
                    for (r, p, _), c in sorted(distinct_c.items())]
    # shards of padding only (no live row): the kernel writes zeros
    zero_live = [fedagg_partial_times(r, MAIN_P, np.zeros(r, np.float32))
                 for r in sorted({r for r, _, _, c in partial_calls
                                  if not any(x > 0 for x in c)})]
    emit({"phase": "fedagg_partial_times", "card": card,
          f"at_r{PARTIAL_R}": full_r, "at_mesh_path_shapes": partial_seen,
          "at_padding_only_shards": zero_live})

    fa_times = flash_attention_times(attn_calls + moe_calls + wide_calls
                                     + audio_calls)
    emit({"phase": "flash_attention_times", "card": card,
          "at_prefill_path_shapes": fa_times})
    ss_times = ssm_scan_times()
    emit({"phase": "ssm_scan_times", "card": card,
          "at_serving_path_shapes": ss_times})
    fa_bwd = flash_attention_bwd_times(per_step)
    emit({"phase": "flash_attention_bwd_times", "card": card,
          "at_train_path_shapes": fa_bwd})
    ss_bwd = ssm_scan_bwd_times(per_step)
    emit({"phase": "ssm_scan_bwd_times", "card": card,
          "at_train_path_shape": ss_bwd})
    fa_bwd16 = flash_attention_bwd_bf16_times(bf16_per_step)
    emit({"phase": "flash_attention_bwd_bf16_times", "card": card,
          "at_train_path_shapes": fa_bwd16})
    ss_bwd16 = ssm_scan_bwd_bf16_times(bf16_per_step)
    emit({"phase": "ssm_scan_bwd_bf16_times", "card": card,
          "at_train_path_shape": ss_bwd16})
    hymba_train = lm_train["runs"][0]["launches"]
    hymba_bf16 = bf16_train["runs"][0]["launches"]
    # elapsed_s: the script's wall time, the build and import included
    emit({"phase": "script_wall_time"})

    widest = seen[-1]          # the largest cohort the main path formed
    fold_widest = max(fold_seen, key=lambda t: t["k_live"])
    partial_widest = max(partial_seen, key=lambda t: t["r_live"])
    print(card, flush=True)
    emit({"kernels": [{
        "name": "fedagg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedagg.cu",
        "replaces": "src/repro/kernels/fedagg.py:49",
        "launches": launches,
        "max_abs_err": max(t["max_abs_err"] for t in seen + [at_main]),
        "shape": [widest["n"], widest["p"]],
        "ms": widest["ms"], "plain_ms": widest["plain_ms"],
        "bound_ms": widest["bound_ms"], "bound_by": widest["bound_by"],
        "library_ms": widest["library_ms"],
        # past 4,096 rows: the tiled route (FedAvg's round of every one
        # of ROWS_CLIENTS clients; the checks' 8,192 rows)
        "past_4096_rows": {
            "fl_launches": fl_rows["fedavg"]["launches"]["fedagg_tiled"],
            "max_abs_err": max(v for k, v in
                               rows["d_max_abs_err_vs_plain"].items()
                               if k.startswith("fedagg_4")
                               or k.startswith("fedagg_8")),
            **rows["at_8192_rows"]["fedagg"],
            "at_resnet8_width": rows["at_8192_rows_resnet8_width"]
            ["fedagg"],
            "at_4096_rows": rows["fedagg_at_4096"]}}, {
        "name": "fedagg_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedagg.cu",
        "replaces": "src/repro/kernels/fedagg.py:102",
        "launches": fold_launches,
        "q8_path_launches": quant["launches"]["fedagg_fold"],
        "tiered_path_launches": tiered["tiered_path_launches"],
        "max_abs_err": max(t["max_abs_err"]
                           for t in fold_seen + [fold_at_k]),
        "shape": [fold_widest["k"], fold_widest["p"]],
        "k_live": fold_widest["k_live"],
        "ms": fold_widest["ms"], "plain_ms": fold_widest["plain_ms"],
        "bound_ms": fold_widest["bound_ms"],
        "bound_by": fold_widest["bound_by"],
        "library_ms": fold_widest["library_ms"],
        # past 4,096 coefficients: FedBuff's window of ROWS_CLIENTS
        "past_4096_rows": {
            "fl_launches": fl_rows["fedbuff"]["launches_store"]
            ["fedagg_tiled"],
            "max_abs_err": max(v for k, v in
                               rows["d_max_abs_err_vs_plain"].items()
                               if k.startswith("fedagg_fold")),
            **rows["at_8192_rows"]["fedagg_fold"],
            "at_resnet8_width": rows["at_8192_rows_resnet8_width"]
            ["fedagg_fold"],
            "at_4095_rows": rows["fedagg_fold_at_4096"]}}, {
        "name": "fedagg_partial", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedagg.cu",
        "replaces": "src/repro/kernels/fedagg.py:163",
        "launches": mesh_counts["fedagg_partial"],
        # the server's sum of secure aggregation (secure_agg_path)
        "secure_agg_launches": secure["k3_launches"],
        "max_abs_err": max(t["max_abs_err"]
                           for t in partial_seen + [full_r]),
        "shape": [partial_widest["r"], partial_widest["p"]],
        "r_live": partial_widest["r_live"],
        "ms": partial_widest["ms"], "plain_ms": partial_widest["plain_ms"],
        "bound_ms": partial_widest["bound_ms"],
        "bound_by": partial_widest["bound_by"],
        "library_ms": partial_widest["library_ms"],
        "secure_sum": {k: secure[f"k3_{k}"] for k in (
            "rows", "ms", "plain_ms", "library_ms", "library", "bound_ms",
            "bound_by")},
        "past_4096_rows": {
            "max_abs_err": max(v for k, v in
                               rows["d_max_abs_err_vs_plain"].items()
                               if k.startswith("fedagg_partial")),
            **rows["at_8192_rows"]["fedagg_partial"],
            "at_resnet8_width": rows["at_8192_rows_resnet8_width"]
            ["fedagg_partial"],
            "at_4096_rows": rows["fedagg_partial_at_4096"]}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        # one hymba-1.5b prefill at S=4096 (the path's first case), all
        # of them the tensor-core kernel
        "launches": prefill[0]["launches"]["flash_attention"],
        "tc_launches": prefill[0]["launches"]["flash_attention_tc"],
        # a prefill of each wide-head path (D = 128: mixtral, arctic,
        # phi4-mini, chameleon; D = 192: nemotron) and hubert's encoder
        # forward (D = 80), the tensor-core kernel each layer
        "wide_head_launches": {
            r["arch"]: {"head_dim": r["head_dim"],
                        "flash_attention": r["launches"]["flash_attention"],
                        "flash_attention_tc":
                            r["launches"]["flash_attention_tc"]}
            for r in (moe_serve["mixtral"], moe_serve["arctic"],
                      *wide_rows,
                      {"arch": AUDIO, "head_dim": audio["head_dim"],
                       "launches": audio["forward"]["launches"]})},
        # the context-parallel routes: one launch a model shard a layer
        "cp_launches": lm_mesh["cp_k4_launches"],
        # non-causal banded attention: one launch a q chunk on its band
        # (hubert-xlarge's layer shape)
        "band_route": {"q": band["q"], "window": band["window"],
                       "launches_a_layer": band["bfloat16"]["launches"]
                       ["flash_attention"],
                       **{dt: {k: band[dt][k] for k in (
                           "ms", "bound_ms", "one_launch_full_window_ms",
                           "max_abs_err", "library_ms")}
                          for dt in ("bfloat16", "float32")}},
        "max_abs_err": max(t["max_abs_err"] for t in fa_times),
        "shape": {"q": fa_times[0]["q"], "k": fa_times[0]["k"],
                  "window": fa_times[0]["window"]},
        "ms": fa_times[0]["ms"], "plain_ms": fa_times[0]["plain_ms"],
        "bound_ms": fa_times[0]["bound_ms"],
        "bound_by": fa_times[0]["bound_by"],
        "bound_ops": fa_times[0]["bound_ops"],
        "library_ms": fa_times[0]["library_ms"],
        "library": fa_times[0]["library"],
        "routes": [{k: t[k] for k in ("arch", "route", "q", "k", "window",
                                      "ms", "tflops", "plain_ms",
                                      "bound_ms", "bound_by", "bound_ops",
                                      "rate_on_bound",
                                      "library_ms", "library_max_abs_err",
                                      "library_within_tol",
                                      "f32_kernel_ms", "f32_kernel_lse_ms",
                                      "sizes")}
                   for t in fa_times],
        # the f32 forward with lse that training launches, at its two
        # layer shapes, beside SDPA's f32 forward (memory-efficient)
        "train_f32_forward": [{
            "arch": r["arch"], "q": r["q"], "k": r["k"],
            "window": r["window"], "ms": r["fwd_f32_lse_ms"],
            "f32_tflops": r["fwd_f32_tflops"],
            "plain_ms": r["fwd_plain_ms"],
            "bound_ms": r["fwd_bound"]["ms"],
            "bound_by": r["fwd_bound"]["by"],
            "bound_route": r["fwd_bound"]["route"],
            "rate_on_bound": r["fwd_rate_on_bound"],
            "sizes": r["fwd_sizes"],
            "library_ms": r["fwd_library_ms"],
            "launches_per_train_step":
                r["launches_per_train_step"]["fwd_lse"]}
            for r in fa_bwd],
        # the bf16 forward with lse (and out_lo) that bf16 training
        # launches, two a layer a step (remat), at its layer shapes
        "train_bf16_forward": [{
            "arch": r["arch"], "q": r["q"], "k": r["k"],
            "window": r["window"], "ms": r["fwd_lse"]["ms"],
            "without_lse_ms": r["fwd_ms"],
            "bound_ms": r["fwd_lse"]["bound_ms"],
            "bound_by": r["fwd_lse"]["bound_by"],
            "library_ms": r["library_fwd_ms"],
            "launches_per_train_step":
                r["launches_per_train_step"]["fwd_lse"]}
            for r in fa_bwd16]}, {
        "name": "flash_attention_softcap", "route": "cuda",
        # the kernels' bodies; their CAP instantiations are built in a
        # unit of their own
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "instantiated_in":
            "src/repro_torch/kernels/csrc/flash_attention_softcap.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "replaces_note": "the forward with the logit softcap, which the "
                         "reference computes in jnp around its attention "
                         "(models/attention.py:58); its Pallas kernel has "
                         "none",
        # one full-width llama3.2-1b bf16 prefill at 2 x 4096, cap 50
        "launches": cap_serve["with_cap"]["launches_prefill"]
        ["flash_attention_softcap"],
        "max_abs_err": max(cap_checks["max_abs_err"].values()),
        "shape": {"q": cap_serve["forward_times"][0]["q"],
                  "k": cap_serve["forward_times"][0]["k"],
                  "causal": True, "softcap": SERVE_SOFTCAP},
        **{k: cap_serve["forward_times"][0][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "without_cap_ms")},
        "library_ms": cap_serve["forward_times"][0]["library_ms"],
        "library": cap_serve["forward_times"][0]["library"],
        "f32": {k: cap_serve["forward_times"][1][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "without_cap_ms",
            "library_ms")}}] + [{
        # the capped training kernels: one full-width llama3.2-1b bf16
        # training run of SOFTCAP_TRAIN_STEPS steps with a cap of 50
        "name": f"flash_attention_softcap_{part}", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/" + (
            "flash_attention.cu" if part == "fwd_lse"
            else "flash_attention_bwd_tc.cu"),
        "instantiated_in": "src/repro_torch/kernels/csrc/" + (
            "flash_attention_softcap.cu" if part == "fwd_lse"
            else "flash_attention_bwd_tc_softcap.cu"),
        "f32_source": "src/repro_torch/kernels/csrc/" + (
            "flash_attention.cu" if part == "fwd_lse"
            else "flash_attention_bwd.cu"),
        "f32_instantiated_in": "src/repro_torch/kernels/csrc/" + (
            "flash_attention_softcap.cu" if part == "fwd_lse"
            else "flash_attention_bwd_softcap.cu"),
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "replaces_note": "training with the logit softcap, which the "
                         "reference computes in jnp around its attention "
                         "(models/attention.py:58) and differentiates "
                         "with jax.grad; its Pallas kernel has none",
        "launches": (cap_train["train"]["launches"]
                     ["flash_attention_softcap"] if part == "fwd_lse"
                     else cap_train["train"]["launches"]
                     ["flash_attention_softcap_bwd"] // 2),
        "max_abs_err": max(r[f"{tag}_max_abs_err"] for r in cap_bwd["rows"]
                           for tag in {"fwd_lse": ("out",), "dq": ("dq",),
                                       "dkdv": ("dk", "dv")}[part]),
        "shape": {"q": cap_train["layer_times"][0]["q"],
                  "k": cap_train["layer_times"][0]["k"], "causal": True,
                  "softcap": SERVE_SOFTCAP},
        **{k: cap_train["layer_times"][0][part][k] for k in (
            "ms", "bound_ms", "bound_by", "without_cap_ms")},
        "plain_ms": cap_train["layer_times"][0]["plain_ms"][
            "fwd_lse" if part == "fwd_lse" else "pair"],
        "library_ms": cap_train["layer_times"][0]["library"][
            "fwd_lse_ms" if part == "fwd_lse" else "bwd_ms"],
        "library": cap_train["layer_times"][0]["library"]["name"],
        **({} if part == "fwd_lse" else {
            "library_and_plain_cover": "dq, dk and dv (both kernels' "
                                       "work)"}),
        "f32": {**{k: cap_train["layer_times"][1][part][k] for k in (
            "ms", "bound_ms", "bound_by", "without_cap_ms")},
                "plain_ms": cap_train["layer_times"][1]["plain_ms"][
                    "fwd_lse" if part == "fwd_lse" else "pair"],
                "library_ms": cap_train["layer_times"][1]["library"][
                    "fwd_lse_ms" if part == "fwd_lse" else "bwd_ms"]}}
        for part in ("fwd_lse", "dq", "dkdv")] + [{
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:28",
        "launches": prefill[0]["launches"]["ssm_scan"],
        "max_abs_err": max(t["max_abs_err"] for t in ss_times),
        "shape": [ss_times[0][k] for k in ("b", "s", "d", "n")],
        "ms": ss_times[0]["ms"], "plain_ms": ss_times[0]["plain_ms"],
        "bound_ms": ss_times[0]["bound_ms"],
        "bound_by": ss_times[0]["bound_by"], "library_ms": None,
        "decode": {k: ss_times[1][k] for k in ("b", "s", "ms", "plain_ms",
                                               "bound_ms", "bound_by")},
        "decode_launches": serve["launches"]["ssm_scan"]}] + [{
        "name": f"flash_attention_bwd_{part}_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "replaces_note": "the backward of that kernel: the JAX package "
                         "differentiates the jnp attention and has no "
                         "Pallas backward",
        # one full-width hymba-1.5b training run of LM_TRAIN_STEPS steps
        "launches": hymba_train[f"flash_attention_bwd_{part}"],
        "max_abs_err": max(fa_bwd[0]["max_abs_err"].values()),
        "shape": {"q": fa_bwd[0]["q"], "k": fa_bwd[0]["k"],
                  "window": fa_bwd[0]["window"]},
        "ms": fa_bwd[0][part]["ms"], "plain_ms": fa_bwd[0]["plain_ms"],
        "bound_ms": fa_bwd[0][part]["bound_ms"],
        "bound_by": fa_bwd[0][part]["bound_by"],
        "bound_route": fa_bwd[0][part]["bound_route"],
        "library_ms": fa_bwd[0]["library_ms"],
        "library": fa_bwd[0]["library"],
        "library_math_ms": fa_bwd[0]["library_math_ms"],
        "library_and_plain_cover": "dq, dk and dv (both kernels' work)",
        "llama": {**{k: fa_bwd[1][part][k] for k in ("ms", "bound_ms",
                                                     "bound_by",
                                                     "bound_route")},
                  "library_ms": fa_bwd[1]["library_ms"]},
        # the wide heads: phi4-mini and mixtral (D = 128; launches from
        # their train steps), a nemotron layer (D = 192; no train run)
        # and hubert's (D = 80; launches from its train step)
        "wide_heads": [{
            "arch": r["arch"], "q": r["q"], "k": r["k"],
            **{k: r[part][k] for k in ("ms", "bound_ms", "bound_by",
                                       "bound_route")},
            "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
            "sizes": r["sizes"][part],
            "rate_on_dots_done": r[part]["rate_on_dots_done"],
            "max_abs_err": max(r["max_abs_err"].values()),
            "launches_per_train_step":
                r["launches_per_train_step"][part]} for r in fa_bwd[2:]]}
        for part in ("dq", "dkdv")] + [{
        "name": "ssm_scan_bwd_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:28",
        "replaces_note": "the backward of that kernel: the JAX package "
                         "differentiates the jnp scan and has no Pallas "
                         "backward",
        "launches": hymba_train["ssm_scan_bwd"],
        "max_abs_err": max(ss_bwd["max_abs_err"].values()),
        "shape": [ss_bwd[k] for k in ("b", "s", "d", "n")],
        "ms": ss_bwd["ms"], "plain_ms": ss_bwd["plain_ms"],
        "bound_ms": ss_bwd["bound_ms"], "bound_by": ss_bwd["bound_by"],
        "library_ms": None, "split": ss_bwd["split"],
        "design_exps_ms": ss_bwd["design_exps_ms"]}] + [{
        "name": f"flash_attention_bwd_{part}_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "replaces_note": "the backward of that kernel on bf16 inputs: the "
                         "JAX package differentiates the jnp attention "
                         "and has no Pallas backward",
        # one full-width hymba-1.5b bf16 run of LM_BF16_STEPS steps
        "launches": hymba_bf16[f"flash_attention_bwd_{part}_bf16"],
        "max_abs_err": max(fa_bwd16[0]["max_abs_err"].values()),
        "shape": {"q": fa_bwd16[0]["q"], "k": fa_bwd16[0]["k"],
                  "window": fa_bwd16[0]["window"]},
        "ms": fa_bwd16[0][part]["ms"], "plain_ms": fa_bwd16[0]["plain_ms"],
        "bound_ms": fa_bwd16[0][part]["bound_ms"],
        "bound_by": fa_bwd16[0][part]["bound_by"],
        "bound_on_dots_done_ms": fa_bwd16[0][part]["bound_on_dots_done_ms"],
        "sizes": fa_bwd16[0]["sizes"][part],
        "library_ms": fa_bwd16[0]["library_ms"],
        "library": fa_bwd16[0]["library"],
        "library_and_plain_cover": "dq, dk and dv (both kernels' work)",
        "pair_ms": fa_bwd16[0]["pair"]["ms"],
        "f32_pair_ms": fa_bwd16[0]["pair_f32_ms"],
        "other_layers": [{
            "arch": r["arch"], "q": r["q"], "k": r["k"],
            **{k: r[part][k] for k in ("ms", "bound_ms", "bound_by",
                                       "bound_on_dots_done_ms")},
            "pair_ms": r["pair"]["ms"], "f32_pair_ms": r["pair_f32_ms"],
            "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
            "library": r["library"],
            "max_abs_err": max(r["max_abs_err"].values()),
            "launches_per_train_step":
                r["launches_per_train_step"][part]} for r in fa_bwd16[1:]]}
        for part in ("dq", "dkdv")] + [{
        "name": "ssm_scan_bwd_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:28",
        "replaces_note": "the backward of that kernel on bf16 inputs: the "
                         "JAX package differentiates the jnp scan and has "
                         "no Pallas backward",
        "launches": hymba_bf16["ssm_scan_bwd_bf16"],
        "max_abs_err": max(ss_bwd16["max_abs_err"].values()),
        "shape": [ss_bwd16[k] for k in ("b", "s", "d", "n")],
        "ms": ss_bwd16["ms"], "plain_ms": ss_bwd16["plain_ms"],
        "f32_ms": ss_bwd16["f32_ms"],
        "bound_ms": ss_bwd16["bound_ms"], "bound_by": ss_bwd16["bound_by"],
        "library_ms": None}]})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
