"""FedDCT training loop (paper Alg. 2) over a virtual clock.

Round flow:
  1. Tier the currently-available clients on their running-average
     times (Alg. 3 — dynamic: re-split every round).
  2. CSTT (Alg. 4): move the tier pointer by the accuracy delta (Eq. 3),
     select tau low-participation clients from every tier 1..t (Eq. 4 as
     stated in the text), compute per-tier timeouts (Eq. 7).
  3. Clients train for real; their virtual cost comes from the
     wireless model.  A client whose time st >= D_max of its tier is a
     straggler: its update is dropped and it enters the parallel
     re-evaluation lane for kappa rounds (Alg. 2 "Async:" line).
     Survivors train as ONE batched step via the execution
     engine (core/engine.py) — virtual stragglers are known before
     training, so the cohort is trimmed first and the whole round is a
     single device program.
  4. Aggregate survivors weighted by sample count, on device — the
     all-masked guard is a device-side select inside
     ``engine.train_round`` (no per-round host sync of the weight
     sum); clock advances by Eq. 5/6: D = max over used tiers of
     min(max(st in tier), D_max^t, Ω).
  5. Clients whose evaluation lane finished (virtual time passed) rejoin
     with their refreshed average time.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.config.base import FLConfig
from repro_torch.core.engine import (make_engine, mesh_devices,
                                     resolve_kernel_agg)
from repro_torch.core.selection import cstt
from repro_torch.core.tiering import evaluate_client, tiering, update_avg_time
from repro_torch.fl.metrics import RunHistory
from repro_torch.obs import flstats
from repro_torch.obs import telemetry as obs


def run_feddct(trainer, network, fl: FLConfig, *,
               use_kernel_agg: Optional[bool] = None,
               engine: str = "batched", verbose: bool = False,
               eval_every: int = 1, mesh=None) -> RunHistory:
    use_kernel_agg = resolve_kernel_agg(use_kernel_agg, trainer)
    rng = np.random.default_rng(fl.seed + 7)
    tel = obs.TEL
    run_span = tel.span("run", method="feddct").start()
    hist = RunHistory(method="feddct", arch=trainer.cfg.arch_id,
                      meta={"mu": fl.mu, "primary_frac": fl.primary_frac,
                            "beta": fl.beta, "kappa": fl.kappa,
                            "omega": fl.omega, "tau": fl.tau,
                            "n_tiers": fl.n_tiers, "engine": engine,
                            "kernel_agg": use_kernel_agg,
                            "mesh_devices": mesh_devices(mesh)})
    eng = make_engine(trainer, use_kernel_agg=use_kernel_agg, engine=engine,
                      mesh=mesh)
    params = trainer.init_params(fl.seed)
    clock = 0.0

    # ---- initial kappa-round evaluation of every client (parallel) ----
    at: Dict[int, float] = {}
    ct: Dict[int, int] = {}
    setup_times = []
    for c in range(fl.n_clients):
        t_avg, spent = evaluate_client(network, c, rnd=0, kappa=fl.kappa,
                                       omega=fl.omega)
        at[c] = t_avg
        ct[c] = 0
        setup_times.append(spent)
    clock += max(setup_times)               # all clients evaluate in parallel

    # straggler re-evaluation lane: client -> (rejoin_time, new_at)
    eval_lane: Dict[int, tuple] = {}
    t_ptr = 1
    # Alg. 4 compares v_r (accuracy of the current global model) with
    # v_{r-1}.  We evaluate once per round, after aggregation; that value
    # is v_r for the next round's tier move.
    v_curr = 0.0        # v_{r-1}: accuracy of the model entering this round
    v_prev = 0.0        # v_{r-2}
    m = max(fl.n_clients // fl.n_tiers, 1)

    for rnd in range(1, fl.rounds + 1):
        tel.set_virtual_time(clock)
        # ---- rejoin clients whose re-evaluation completed --------------
        for c in [c for c, (tr, _) in eval_lane.items() if tr <= clock]:
            at[c] = eval_lane.pop(c)[1]

        avail_at = {c: v for c, v in at.items() if c not in eval_lane}
        sel_span = tel.span("round.select", avail=len(avail_at)).start()
        tiers = tiering(avail_at, m)
        if not tiers:
            sel_span.end()
            break

        selected, d_max, t_ptr = cstt(
            t_ptr, v_prev, v_curr, tiers, avail_at, ct, fl.tau, fl.beta,
            fl.omega, rng)
        flstats.record_tiering(tiers, thresholds=d_max,
                               population=fl.n_clients)
        flstats.record_selection(selected)

        # ---- virtual delays decide survivors BEFORE any training ------
        survivors: List[int] = []
        times_per_tier: Dict[int, List[float]] = {}
        n_straggle = 0
        sts = network.delays([c for c, _ in selected], rnd)
        for (c, k), st in zip(selected, sts):
            times_per_tier.setdefault(k, []).append(min(st, d_max[k]))
            flstats.record_response(k + 1, float(st), d_max[k],
                                    timed_out=st >= d_max[k])
            if st >= d_max[k]:
                # straggler: drop update, enter evaluation lane
                n_straggle += 1
                flstats.record_straggler("dropped", tier=k + 1)
                new_at, spent = evaluate_client(network, c, rnd, fl.kappa,
                                                fl.omega)
                eval_lane[c] = (clock + spent, new_at)
                continue
            survivors.append(c)
            at[c] = update_avg_time(at[c], ct[c], st)
            ct[c] += 1
        sel_span.end()
        if n_straggle:
            tel.inc("stragglers.dropped", n_straggle)

        # ---- one batched device program for the whole cohort ----------
        params = eng.train_round(params, survivors, rnd)

        # Eq. 5/6 round duration
        d_round = 0.0
        for k, ts_k in times_per_tier.items():
            d_round = max(d_round, min(max(ts_k), d_max[k], fl.omega))
        clock += d_round

        if rnd % eval_every == 0:
            with tel.span("eval"):
                v_now = trainer.evaluate(params)
            hist.record(time=clock, rnd=rnd, acc=v_now, tier=t_ptr,
                        n_selected=len(selected), n_stragglers=n_straggle)
            v_prev, v_curr = v_curr, v_now
            if verbose:
                print(f"[feddct] r={rnd:4d} t={clock:9.1f}s tier={t_ptr} "
                      f"acc={v_now:.4f} sel={len(selected)} str={n_straggle}")
            if fl.target_accuracy and v_now >= fl.target_accuracy:
                break
    run_span.end()
    tel.summarize_into(hist.meta)
    return hist
