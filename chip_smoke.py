#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's
two main paths through those kernels — the sync path
(``repro_torch.launch.fl_train``: FedDCT on full-width ``cnn-mnist``, 50
clients, 5 rounds; kernel ``fedagg``) and the async path (semi-async
FedDCT and FedBuff over the client-state store; kernel
``fedagg_fold``) — and prints one JSON object per phase.  Any failure
exits non-zero; there is no CPU path.  The last line of standard output
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM: the yardsticks of ``bound_ms``.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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
# meta keys that name the snapshot path, and so differ store vs dict
STORE_KEYS = {"store", "store_path", "store_reason", "residency",
              "hot_rows", "store_bytes_hot", "store_bytes_cold",
              "store_bytes_ef"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def fedagg_bound_ms(weights, p: int):
    """Least time for this call: live rows read once, output written
    once, two operations per live element."""
    n_live = int((weights > 0).sum())
    n = weights.numel()
    by_bytes = ((n_live * p + p) * 4 + 2 * n * 4) / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * n_live * p / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


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


def fold_bound_ms(coef, p: int):
    """Least time for one folded merge: live rows and the global row
    (when its coefficient is positive) read once, the output written
    once, the coefficients read once; two operations per element read."""
    c = torch_f32(coef)
    c = c.clamp(min=0.0).nan_to_num(0.0)
    n_live = int((c[1:] > 0).sum())
    g_read = 1 if float(c[0]) > 0 else 0
    by_bytes = (((n_live + g_read) * p + p) * 4
                + 4 * c.numel()) / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * (n_live + g_read) * p / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


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
        fedagg_mod.launches = 0
        t0 = time.perf_counter()
        hist = fl_train.main(MAIN_ARGV)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = fedagg_mod.launches
    finally:
        ops.fedagg = real

    live_rounds = sum(1 for s, g in zip(hist.n_selected, hist.n_stragglers)
                      if s - g > 0)
    if len(hist.rounds) != 5:
        fail(f"main path recorded {len(hist.rounds)} rounds, not 5")
    if launches != live_rounds or launches < 1:
        fail(f"fedagg launched {launches} times on the main path, "
             f"{live_rounds} rounds had survivors")
    if any(dev != "cuda" or p != MAIN_P for _, p, dev in shapes):
        fail(f"main path gave fedagg unexpected buffers: {shapes}")
    if hist.meta.get("kernel_agg") is not True:
        fail(f"meta['kernel_agg'] is {hist.meta.get('kernel_agg')!r}")
    if not all(0.0 <= a <= 1.0 for a in hist.accuracy):
        fail(f"accuracies not finite in [0,1]: {hist.accuracy}")

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
            "fedagg_launches": launches,
            "fedagg_shapes": [[n, p] for n, p, _ in shapes],
            "first_run_s": first_s, "warm_run_s": run_s,
            "warm_s_per_round": run_s / fl.rounds,
            "two_runs_identical": True}, launches, shapes


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
        fedagg_mod.fold_launches = 0
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    from repro_torch import set_full_f32
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    set_full_f32()

    t0 = time.perf_counter()
    libs = _build.build(["fedagg"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()}})

    emit({"phase": "kernel_checks", "rtol": RTOL, "atol": ATOL,
          "fedagg": fedagg_cases(), "fedagg_fold": fold_cases()})
    emit({"phase": "train_round_vs_cpu", **cpu_agreement()})

    summary, launches, shapes = main_path()
    emit({"phase": "main_path", **summary})

    async_summary, fold_launches, fold_calls = async_path()
    emit({"phase": "async_path", **async_summary})

    at_main = fedagg_times(MAIN_N, MAIN_P)
    seen = [fedagg_times(n, p)
            for n, p in sorted({(n, p) for n, p, _ in shapes})]
    emit({"phase": "fedagg_times", "card": card,
          "at_full_cohort_shape": at_main, "at_main_path_shapes": seen})

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

    widest = seen[-1]          # the largest cohort the main path formed
    fold_widest = max(fold_seen, key=lambda t: t["k_live"])
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
        "library_ms": widest["library_ms"]}, {
        "name": "fedagg_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedagg.cu",
        "replaces": "src/repro/kernels/fedagg.py:102",
        "launches": fold_launches,
        "max_abs_err": max(t["max_abs_err"]
                           for t in fold_seen + [fold_at_k]),
        "shape": [fold_widest["k"], fold_widest["p"]],
        "k_live": fold_widest["k_live"],
        "ms": fold_widest["ms"], "plain_ms": fold_widest["plain_ms"],
        "bound_ms": fold_widest["bound_ms"],
        "bound_by": fold_widest["bound_by"],
        "library_ms": fold_widest["library_ms"]}]})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
