"""Baseline FL methods the paper compares against (§5.1).

* FedAvg  [McMahan'17]: random tau clients per round; server waits for
  every selected client (failures hurt: round = max client time).
* TiFL    [Chai'20]: one-off profiling -> STATIC tiers; clients whose
  profiled time >= Omega are dropped for good; credit + accuracy based
  adaptive tier selection; round capped at Omega (slower uploads lost).
* FedProx [Li'20]: FedAvg + proximal blend toward the global model
  (extra baseline beyond the paper).

* FedAsync [Xie'19]: staleness-weighted one-at-a-time merges; FedBuff
  [Nguyen'22]: K-completion aggregation goal; semi-async FedDCT: tier
  timeouts as aggregation windows.  All three run on the event-driven
  runtime (``repro_torch.runtime``).

All methods share the trainer + WirelessNetwork realization with FedDCT
and run their per-round cohort through the batched execution engine
(core/engine.py) — one batched device program per round instead of a
per-client Python loop (pass ``engine="looped"`` for the reference
path).  Sync rounds keep the all-masked guard on device
(``engine.train_round``).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np

from repro_torch.config.base import FLConfig
from repro_torch.core.aggregation import staleness_merge
from repro_torch.core.engine import (make_engine, mesh_devices,
                                     resolve_kernel_agg)
from repro_torch.core.tiering import evaluate_client, tiering
from repro_torch.fl.metrics import RunHistory
from repro_torch.obs import flstats
from repro_torch.obs import telemetry as obs
from repro_torch.tree import tree_map


def run_fedavg(trainer, network, fl: FLConfig, *,
               use_kernel_agg: Optional[bool] = None,
               engine: str = "batched", verbose: bool = False,
               eval_every: int = 1, mesh=None) -> RunHistory:
    use_kernel_agg = resolve_kernel_agg(use_kernel_agg, trainer)
    rng = np.random.default_rng(fl.seed + 11)
    tel = obs.TEL
    run_span = tel.span("run", method="fedavg").start()
    hist = RunHistory(method="fedavg", arch=trainer.cfg.arch_id,
                      meta={"mu": fl.mu, "primary_frac": fl.primary_frac,
                            "engine": engine,
                            "kernel_agg": use_kernel_agg,
                            "mesh_devices": mesh_devices(mesh)})
    eng = make_engine(trainer, use_kernel_agg=use_kernel_agg, engine=engine,
                      mesh=mesh)
    params = trainer.init_params(fl.seed)
    clock = 0.0
    for rnd in range(1, fl.rounds + 1):
        tel.set_virtual_time(clock)
        sel = [int(c) for c in rng.choice(fl.n_clients,
                                          size=min(fl.tau, fl.n_clients),
                                          replace=False)]
        flstats.record_selection(sel, population=fl.n_clients)
        times = network.delays(sel, rnd)
        params = eng.train_round(params, sel, rnd)
        clock += float(times.max())              # waits for everyone
        if rnd % eval_every == 0:
            with tel.span("eval"):
                acc = trainer.evaluate(params)
            hist.record(time=clock, rnd=rnd, acc=acc,
                        n_selected=len(sel))
            if verbose:
                print(f"[fedavg] r={rnd:4d} t={clock:9.1f}s acc={acc:.4f}")
            if fl.target_accuracy and acc >= fl.target_accuracy:
                break
    run_span.end()
    tel.summarize_into(hist.meta)
    return hist


def run_tifl(trainer, network, fl: FLConfig, *,
             use_kernel_agg: Optional[bool] = None,
             engine: str = "batched", verbose: bool = False,
             eval_every: int = 1, mesh=None) -> RunHistory:
    use_kernel_agg = resolve_kernel_agg(use_kernel_agg, trainer)
    rng = np.random.default_rng(fl.seed + 13)
    tel = obs.TEL
    run_span = tel.span("run", method="tifl").start()
    hist = RunHistory(method="tifl", arch=trainer.cfg.arch_id,
                      meta={"mu": fl.mu, "primary_frac": fl.primary_frac,
                            "engine": engine,
                            "kernel_agg": use_kernel_agg,
                            "mesh_devices": mesh_devices(mesh)})
    eng = make_engine(trainer, use_kernel_agg=use_kernel_agg, engine=engine,
                      mesh=mesh)
    params = trainer.init_params(fl.seed)
    clock = 0.0

    # one-off profiling (static tiers; >=Omega dropped permanently — the
    # behaviour the paper criticises when mu>0 mis-classifies clients)
    at: Dict[int, float] = {}
    spent_all = []
    for c in range(fl.n_clients):
        t_avg, spent = evaluate_client(network, c, rnd=0, kappa=fl.kappa,
                                       omega=fl.omega)
        spent_all.append(spent)
        if t_avg < fl.omega:
            at[c] = t_avg
    clock += max(spent_all)
    m = max(fl.n_clients // fl.n_tiers, 1)
    tiers = tiering(at, m)
    # TiFL's tiers are STATIC — recorded once, so the migration matrix
    # of a TiFL trace is empty by construction (the FedDCT contrast).
    flstats.record_tiering(tiers, population=fl.n_clients)
    n_tiers = len(tiers)
    credits = [fl.rounds // max(n_tiers, 1) + 1] * n_tiers
    tier_acc = [0.0] * n_tiers
    probs = np.ones(n_tiers) / max(n_tiers, 1)

    for rnd in range(1, fl.rounds + 1):
        tel.set_virtual_time(clock)
        live = [k for k in range(n_tiers) if credits[k] > 0 and tiers[k]]
        if not live:
            live = [k for k in range(n_tiers) if tiers[k]]
        p = np.array([probs[k] for k in live], np.float64)
        p = p / p.sum() if p.sum() > 0 else np.ones(len(live)) / len(live)
        k = int(rng.choice(live, p=p))
        credits[k] -= 1
        members = tiers[k]
        sel = [int(c) for c in rng.choice(members,
                                          size=min(fl.tau, len(members)),
                                          replace=False)]
        flstats.record_selection([(c, k) for c in sel],
                                 population=fl.n_clients)
        times, survivors = [], []
        for c, st in zip(sel, network.delays(sel, rnd)):
            times.append(min(st, fl.omega))
            flstats.record_response(k + 1, float(st), fl.omega,
                                    timed_out=st >= fl.omega)
            if st >= fl.omega:               # lost this round
                flstats.record_straggler("dropped", tier=k + 1)
                continue
            survivors.append(c)
        params = eng.train_round(params, survivors, rnd)
        clock += max(times) if times else 0.0
        if rnd % eval_every == 0:
            with tel.span("eval"):
                acc = trainer.evaluate(params)
        else:
            acc = None
        if acc is not None:
            tier_acc[k] = acc
            # adaptive: favour tiers with lower observed accuracy (TiFL §4)
            inv = np.array([1.0 - a for a in tier_acc], np.float64)
            probs = inv / inv.sum() if inv.sum() > 0 else probs
            hist.record(time=clock, rnd=rnd, acc=acc, tier=k + 1,
                        n_selected=len(sel),
                        n_stragglers=len(sel) - len(survivors))
            if verbose:
                print(f"[tifl]   r={rnd:4d} t={clock:9.1f}s tier={k+1} "
                      f"acc={acc:.4f}")
            if fl.target_accuracy and acc >= fl.target_accuracy:
                break
    run_span.end()
    tel.summarize_into(hist.meta)
    return hist


def run_fedasync_sequential(trainer, network, fl: FLConfig, *,
                            engine: str = "batched", verbose: bool = False,
                            eval_every: int = 5) -> RunHistory:
    """The sequential FedAsync loop: one merge per event.

    Kept as the reference implementation the event-driven runtime is
    equivalence-tested against (``run_fedasync(window=0)`` must produce
    an identical ``RunHistory``).  New callers should use
    ``run_fedasync``.
    """
    hist = RunHistory(method="fedasync", arch=trainer.cfg.arch_id,
                      meta={"mu": fl.mu, "primary_frac": fl.primary_frac,
                            "alpha": fl.async_alpha, "a": fl.async_a})
    eng = make_engine(trainer, engine=engine)
    params = trainer.init_params(fl.seed)
    clock = 0.0
    version = 0
    # true async: each client trains from the global model snapshot taken
    # when it STARTED (not finished) — that is what staleness weights fix.
    snapshot: Dict[int, object] = {c: params for c in range(fl.n_clients)}
    # event queue: (finish_time, client, model_version_at_start, round_idx)
    heap: List = []
    for t, c in zip(network.delays(np.arange(fl.n_clients), 0),
                    range(fl.n_clients)):
        heapq.heappush(heap, (float(t), c, 0, 0))
    # budget: same number of aggregations as sync methods have rounds*tau
    max_updates = fl.rounds * fl.tau
    upd = 0
    for upd in range(1, max_updates + 1):
        finish, c, v0, ridx = heapq.heappop(heap)
        clock = finish
        # events are inherently sequential (each merge precedes the next
        # event), so the engine runs a cohort of one
        stacked, _ = eng.train_clients(snapshot[c], [c], ridx * 977 + c)
        new_p = tree_map(lambda l: l[0], stacked)
        staleness = version - v0
        if fl.async_staleness == "poly":
            alpha_t = fl.async_alpha * (staleness + 1.0) ** (-fl.async_a)
        else:
            alpha_t = fl.async_alpha
        params = staleness_merge(params, new_p, alpha_t)
        version += 1
        snapshot[c] = params
        heapq.heappush(heap, (clock + network.delay(c, ridx + 1), c,
                              version, ridx + 1))
        if upd % eval_every == 0:
            acc = trainer.evaluate(params)
            hist.record(time=clock, rnd=upd, acc=acc, n_selected=1)
            if verbose:
                print(f"[fedasync] u={upd:5d} t={clock:9.1f}s acc={acc:.4f}")
            if fl.target_accuracy and acc >= fl.target_accuracy:
                break
    # terminal eval: the budget can run out between eval points — record
    # the true final state so RunHistory ends where the model ends.
    if not hist.rounds or hist.rounds[-1] != upd:
        hist.record(time=clock, rnd=upd, acc=trainer.evaluate(params),
                    n_selected=1)
    return hist


def run_fedasync(trainer, network, fl: FLConfig, *, engine: str = "batched",
                 use_kernel_agg: Optional[bool] = None,
                 verbose: bool = False, eval_every: int = 5,
                 window: int = 0, window_secs: float = 0.0, mesh=None,
                 use_store=None, store_capacity=None, store_cold_dir=None,
                 quant_bits: int = 32,
                 error_feedback: bool = True) -> RunHistory:
    """FedAsync on the event-driven runtime.

    ``window=0`` (default) reproduces the sequential one-merge-per-event
    loop history-identically; ``window=K`` / ``window_secs=T`` batch
    concurrently-finishing completions into one cohort merged with
    per-client staleness weights (FedBuff / time-triggered semantics).
    Windowed runs keep snapshots in the device-resident
    ``ClientStateStore`` by default; ``use_store`` is tri-state (None =
    auto: store exactly when windows batch, False = dict-of-trees
    reference path — histories bit-identical either way).
    """
    from repro_torch.runtime.async_loop import AsyncRunner
    return AsyncRunner(trainer, network, fl, method="fedasync",
                       engine=engine, use_kernel_agg=use_kernel_agg,
                       window=window, window_secs=window_secs,
                       eval_every=eval_every, verbose=verbose, mesh=mesh,
                       use_store=use_store, store_capacity=store_capacity,
                       store_cold_dir=store_cold_dir,
                       quant_bits=quant_bits,
                       error_feedback=error_feedback).run()


def run_fedbuff(trainer, network, fl: FLConfig, *, engine: str = "batched",
                use_kernel_agg: Optional[bool] = None, verbose: bool = False,
                eval_every: int = 5, window: int = 0,
                window_secs: float = 0.0, mesh=None, use_store=None,
                store_capacity=None, store_cold_dir=None,
                quant_bits: int = 32,
                error_feedback: bool = True) -> RunHistory:
    """FedBuff [Nguyen'22]: async with a K-completion aggregation goal
    (default K = fl.tau, the sync methods' per-round cohort size)."""
    from repro_torch.runtime.async_loop import AsyncRunner
    return AsyncRunner(trainer, network, fl, method="fedbuff",
                       engine=engine, use_kernel_agg=use_kernel_agg,
                       window=window or fl.tau, window_secs=window_secs,
                       eval_every=eval_every, verbose=verbose, mesh=mesh,
                       use_store=use_store, store_capacity=store_capacity,
                       store_cold_dir=store_cold_dir,
                       quant_bits=quant_bits,
                       error_feedback=error_feedback).run()


def run_feddct_async(trainer, network, fl: FLConfig, **kw) -> RunHistory:
    """Semi-async FedDCT (tier timeouts as aggregation windows); see
    repro_torch.runtime.async_loop.run_feddct_async."""
    from repro_torch.runtime.async_loop import run_feddct_async as _run
    return _run(trainer, network, fl, **kw)


def run_method(method: str, trainer, network, fl: FLConfig, **kw
               ) -> RunHistory:
    from repro_torch.core.scheduler import run_feddct
    fns = {"feddct": run_feddct, "fedavg": run_fedavg, "tifl": run_tifl,
           "fedasync": run_fedasync, "fedprox": run_fedprox,
           "fedbuff": run_fedbuff, "feddct_async": run_feddct_async}
    return fns[method](trainer, network, fl, **kw)


def run_fedprox(trainer, network, fl: FLConfig, *, prox_mu: float = 0.01,
                use_kernel_agg: Optional[bool] = None,
                engine: str = "batched", verbose: bool = False,
                eval_every: int = 1, mesh=None) -> RunHistory:
    """FedProx [Li et al. 2020]: FedAvg + proximal term pulling local
    models toward the global model (extra baseline beyond the paper).

    Implemented generically: after local training, each update is blended
    toward the global params by 1/(1+prox_mu_eff) — the closed form of
    the proximal step for quadratic regularization applied post-hoc,
    which keeps the trainer interface unchanged.  The blend runs on the
    STACKED cohort (broadcast over the client axis), so the whole round
    stays a device program.
    """
    use_kernel_agg = resolve_kernel_agg(use_kernel_agg, trainer)
    rng = np.random.default_rng(fl.seed + 17)
    tel = obs.TEL
    run_span = tel.span("run", method="fedprox").start()
    hist = RunHistory(method="fedprox", arch=trainer.cfg.arch_id,
                      meta={"mu": fl.mu, "prox_mu": prox_mu,
                            "engine": engine,
                            "kernel_agg": use_kernel_agg,
                            "mesh_devices": mesh_devices(mesh)})
    eng = make_engine(trainer, use_kernel_agg=use_kernel_agg, engine=engine,
                      mesh=mesh)
    params = trainer.init_params(fl.seed)
    clock = 0.0
    blend = 1.0 / (1.0 + prox_mu * 10)
    for rnd in range(1, fl.rounds + 1):
        tel.set_virtual_time(clock)
        sel = [int(c) for c in rng.choice(fl.n_clients,
                                          size=min(fl.tau, fl.n_clients),
                                          replace=False)]
        flstats.record_selection(sel, population=fl.n_clients)
        times = network.delays(sel, rnd)
        with tel.span("round.train", cohort=len(sel)):
            stacked, sizes = eng.train_clients(params, sel, rnd)
        with tel.span("round.aggregate", cohort=len(sel)):
            prox = tree_map(
                lambda n, g: (blend * n.float()
                              + (1 - blend) * g.float()[None]
                              ).to(n.dtype), stacked, params)
            params = eng.aggregate(prox, sizes)
        clock += float(times.max())
        if rnd % eval_every == 0:
            with tel.span("eval"):
                acc = trainer.evaluate(params)
            hist.record(time=clock, rnd=rnd, acc=acc, n_selected=len(sel))
            if verbose:
                print(f"[fedprox] r={rnd:4d} t={clock:9.1f}s acc={acc:.4f}")
            if fl.target_accuracy and acc >= fl.target_accuracy:
                break
    run_span.end()
    tel.summarize_into(hist.meta)
    return hist
