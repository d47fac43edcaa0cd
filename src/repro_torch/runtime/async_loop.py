"""Event-driven async federation over a virtual clock.

``AsyncRunner`` is the FedAsync/FedBuff loop: client completions stream
through a deterministic ``EventQueue``, an ``AggregationBuffer`` drains
them in windows, and each drained window trains as ONE batched cohort
through the execution engine (every client from its OWN model
snapshot, with its own data-stream seed) before a single fused
staleness-weighted merge (``alpha_i = alpha * (s_i + 1)^-a`` per row).

Client snapshots live in a device-resident ``ClientStateStore`` — one
flat (N, P) buffer, gathered per window and re-scattered in place by
the merge+scatter step — instead of a ``Dict[int, tree]`` of N
scattered copies; ``use_store=False`` keeps the dict path as the
bit-identical A/B reference.

* ``window=0``            -> one event per drain: history-identical to
  the sequential FedAsync implementation (singleton windows take its
  exact code path: ``train_clients`` + ``staleness_merge``).
* ``window=K``            -> FedBuff [Nguyen'22]-style semi-async: wait
  for K completions, merge them as one cohort.
* ``window_secs=T``       -> time-triggered batching [Zhou'22]: merge
  everything that lands within T virtual seconds of the anchor event.

``run_feddct_async`` is the semi-async FedDCT variant: CSTT still
selects tau clients from tiers 1..t every round, but the per-tier
timeout D_max^t (Eq. 7) becomes the round's aggregation-window
*deadline* instead of a drop threshold — a selected client that misses
the window is NOT discarded; its completion stays queued and merges in
a later round, discounted by its staleness.

The window step reads no tensor back: the only readback of a run is
``trainer.evaluate``.  ``mesh=`` (a client mesh of several shards)
trains every window's cohort sharded; the dict path's window merge is
then the sharded reduction (kernel ``fedagg_partial``), the store
path's stays ``merge_scatter`` (kernel ``fedagg_fold``), as in the
reference.  ``quant_bits=8`` keeps the store's rows as int8 with
error feedback (``core/state.py``).  ``store_capacity`` keeps only that
many rows on the device (``core/residency.py``: the rest in pinned host
memory, or npz chunks under ``store_cold_dir``), staged ahead of each
window from the ``EventQueue`` lookahead; histories stay bit-identical.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.config.base import FLConfig
from repro_torch.core.aggregation import staleness_merge
from repro_torch.core.engine import (make_engine, mesh_devices,
                                     resolve_kernel_agg)
from repro_torch.core.residency import TieredClientStateStore
from repro_torch.core.selection import cstt
from repro_torch.core.state import ClientStateStore, wire_bytes
from repro_torch.core.tiering import evaluate_client, tiering, update_avg_time
from repro_torch.fl.metrics import RunHistory
from repro_torch.obs import flstats
from repro_torch.obs import telemetry as obs
from repro_torch.runtime.buffer import AggregationBuffer
from repro_torch.runtime.events import ClientEvent, EventQueue
from repro_torch.tree import tree_map


def _resolve_store(params, n_clients: int, mesh, use_store,
                   window_active: bool, capacity=None, cold_dir=None,
                   quant_bits: int = 32, error_feedback: bool = True):
    """-> ``(ClientStateStore or None, reason)`` applying the store
    policy in one place.  ``None`` store means the dict-of-trees path;
    ``reason`` is a machine-checkable tag recorded on the
    ``RunHistory`` (``meta["store_reason"]``):

    * ``use_store=None`` (default) enables the store exactly when
      windows can batch — a pure ``window=0`` sequential loop has no
      stacking to amortize, so the dict path's free reference rebind
      wins there (reason ``"window0-sequential"``);
    * ``use_store=False`` keeps the dict reference path (reason
      ``"forced-off"``);
    * otherwise the store is constructed (``"forced-on"`` /
      ``"auto-windowed"``).  A template the store cannot hold exactly
      (64-bit leaves) raises ``TypeError`` instead of silently changing
      paths.

    ``capacity`` (client rows the device keeps hot) selects tiered
    residency: the store becomes a ``TieredClientStateStore`` whose
    cold tier is pinned host memory, or npz-chunk disk spill when
    ``cold_dir`` is set.  Asking for a capacity implies wanting the
    store (reason ``"auto-tiered"``) — except under an explicit
    ``use_store=False``, which still wins.  Histories are bit-identical
    across all residency layouts, so this only moves memory.

    ``quant_bits=8`` selects int8 rows (+ ``error_feedback`` residuals).
    The quantized format IS the store — the dict path has no rendition
    of it — so it forces the store on even for a sequential
    ``window=0`` loop (reason ``"quant-int8"``), and ``use_store=False``
    raises instead of silently running unquantized.
    """
    if int(quant_bits) not in (8, 32):
        raise ValueError(f"quant_bits must be 8 or 32, got {quant_bits}")
    quant = int(quant_bits) != 32
    if use_store is False:
        if quant:
            raise ValueError(
                "quant_bits=8 lives in the client-state store; it cannot "
                "combine with use_store=False (the dict path has no "
                "quantized rows)")
        return None, "forced-off"
    qkw = dict(quant_bits=quant_bits, error_feedback=error_feedback)
    if capacity is not None:
        reason = "forced-on" if use_store is True else "auto-tiered"
        return TieredClientStateStore(
            params, n_clients, capacity=capacity,
            cold="disk" if cold_dir else "host", cold_dir=cold_dir,
            mesh=mesh, **qkw), reason
    if use_store is None and not window_active:
        if quant:
            return (ClientStateStore(params, n_clients, mesh=mesh, **qkw),
                    "quant-int8")
        return None, "window0-sequential"
    reason = "forced-on" if use_store is True else "auto-windowed"
    return ClientStateStore(params, n_clients, mesh=mesh, **qkw), reason


def _alphas(fl: FLConfig, stalenesses: List[int]) -> List[float]:
    """Per-row merge weights alpha_i = alpha * (s_i + 1)^-a (or the
    constant-alpha variant), matching the sequential scalar formula."""
    if fl.async_staleness == "poly":
        return [fl.async_alpha * (s + 1.0) ** (-fl.async_a)
                for s in stalenesses]
    return [fl.async_alpha] * len(stalenesses)


def _event_seed(e: ClientEvent) -> int:
    """Data-stream seed of one completion — shared by the dict and store
    merge paths so the bit-identity gate cannot drift on a one-sided
    edit."""
    return e.rnd * 977 + e.client


def _window_alphas(fl: FLConfig, batch: List[ClientEvent],
                   version: int) -> List[float]:
    """Per-row merge weights of a drained window: staleness of row i is
    ``(version + i) - event.version`` — exactly the bookkeeping a
    one-at-a-time merge loop would produce."""
    return _alphas(fl, [version + i - e.version
                        for i, e in enumerate(batch)])


def _merge_window(eng, params, snapshots: Dict[int, object],
                  batch: List[ClientEvent], fl: FLConfig, version: int):
    """Train one drained window and merge it into ``params`` (the
    dict-of-trees reference path, kept for A/B tests against the
    store-backed path).

    Row order = heap-pop order = sequential merge order.  A singleton
    window takes the sequential path (same functions, same float ops)
    so ``window=0`` reproduces sequential FedAsync bit-for-bit.
    """
    if len(batch) == 1:
        e = batch[0]
        stacked, _ = eng.train_clients(snapshots[e.client], [e.client],
                                       _event_seed(e))
        new_p = tree_map(lambda l: l[0], stacked)
        return staleness_merge(params, new_p,
                               _window_alphas(fl, batch, version)[0])
    starts = [snapshots[e.client] for e in batch]
    ids = [e.client for e in batch]
    seeds = [_event_seed(e) for e in batch]
    stacked, _ = eng.train_cohort(starts, ids, seeds)
    return eng.merge_staleness(params, stacked,
                               _window_alphas(fl, batch, version))


def _merge_window_store(eng, store: ClientStateStore, params,
                        batch: List[ClientEvent], fl: FLConfig,
                        version: int):
    """Store-backed ``_merge_window``: snapshots are gathered from the
    device-resident (N, P) buffer and the merged window scatters the new
    global row back in place (``engine.train_window``).  Histories are
    bit-identical to the dict path: gather/scatter round-trips are
    exact, the merge is the same function, and padded rows add exact
    zero terms to a row sum taken in row order.  A singleton window
    still takes the sequential train + ``staleness_merge`` path,
    preserving the ``window=0`` sequential-FedAsync gate."""
    if len(batch) == 1:
        e = batch[0]
        stacked, _ = eng.train_clients(store.gather_one(e.client),
                                       [e.client], _event_seed(e))
        new_p = tree_map(lambda l: l[0], stacked)
        params = staleness_merge(params, new_p,
                                 _window_alphas(fl, batch, version)[0])
        store.scatter_params([e.client], params)
        return params
    ids = [e.client for e in batch]
    seeds = [_event_seed(e) for e in batch]
    params, _ = eng.train_window(store, params, ids, seeds,
                                 _window_alphas(fl, batch, version))
    return params


def _store_meta(store, reason: str, kernel_agg: bool, wb: int,
                mesh) -> Dict:
    """The snapshot-path keys every async ``RunHistory.meta`` carries."""
    return {"store": store is not None,
            "store_path": "store" if store is not None else "dict",
            "store_reason": reason,
            "residency": store.residency if store is not None else "dict",
            "hot_rows": store.rows if store is not None else 0,
            "kernel_agg": kernel_agg,
            "quant_bits": store.quant_bits if store is not None else 32,
            "error_feedback": (store.error_feedback if store is not None
                               else False),
            "wire_bytes_per_update": wb,
            "mesh_devices": mesh_devices(mesh)}


def _close_meta(hist: RunHistory, store, cohort_sizes: List[int],
                merged: int, wb: int) -> None:
    hist.meta["mean_cohort"] = (float(np.mean(cohort_sizes))
                                if cohort_sizes else 0.0)
    hist.meta["n_drains"] = len(cohort_sizes)
    # cumulative modeled uplink: every merged update paid one wire row
    hist.meta["bytes_up"] = merged * wb
    if store is not None:
        bt = store.bytes_by_tier()
        hist.meta["store_bytes_hot"] = bt["hot"]
        hist.meta["store_bytes_cold"] = bt["cold"]
        hist.meta["store_bytes_ef"] = bt["ef"]


class AsyncRunner:
    """Virtual-clock event loop: drain window -> batched cohort -> fused
    staleness merge -> reschedule the merged clients."""

    def __init__(self, trainer, network, fl: FLConfig, *,
                 method: str = "fedasync", engine: str = "batched",
                 use_kernel_agg: Optional[bool] = None, window: int = 0,
                 window_secs: float = 0.0, eval_every: int = 5,
                 verbose: bool = False, mesh=None, use_store=None,
                 store_capacity=None, store_cold_dir=None,
                 quant_bits: int = 32, error_feedback: bool = True):
        self.trainer = trainer
        self.network = network
        self.fl = fl
        self.method = method
        self.engine = engine
        self.use_kernel_agg = resolve_kernel_agg(use_kernel_agg, trainer)
        # client mesh for the distributed engine: windowed cohorts train
        # sharded, and the store's rows are padded to a mesh multiple
        self.mesh = mesh
        # device-resident client-state store: all N snapshots live as
        # one flat (N, P) buffer.  Tri-state: None (default) = on for
        # windowed modes, off for the pure sequential window=0 loop;
        # False = dict-of-trees A/B reference (bit-identical histories);
        # True = force (window=0 included).  Resolved at run().
        self.use_store = use_store
        self.store_capacity = store_capacity
        self.store_cold_dir = store_cold_dir
        # row format: 32 = the f32 path, 8 = int8 rows (+ per-client
        # error-feedback residuals unless error_feedback=False)
        self.quant_bits = int(quant_bits)
        self.error_feedback = bool(error_feedback)
        # resolved snapshot-path tag, set by run() and also recorded on
        # the RunHistory meta
        self.store_reason = None
        self.buffer = AggregationBuffer(window, window_secs)
        self.eval_every = max(int(eval_every), 1)
        self.verbose = verbose
        self.cohort_sizes: List[int] = []

    def run(self) -> RunHistory:
        fl, net = self.fl, self.network
        tel = obs.TEL
        run_span = tel.span("run", method=self.method).start()
        eng = make_engine(self.trainer, use_kernel_agg=self.use_kernel_agg,
                          engine=self.engine, mesh=self.mesh)
        params = self.trainer.init_params(fl.seed)
        # true async: each client trains from the global model snapshot
        # taken when it STARTED (not finished) — staleness weights exist
        # to correct exactly that lag.
        store, self.store_reason = _resolve_store(
            params, fl.n_clients, self.mesh, self.use_store,
            window_active=(self.buffer.window > 0
                           or self.buffer.window_secs > 0),
            capacity=self.store_capacity, cold_dir=self.store_cold_dir,
            quant_bits=self.quant_bits, error_feedback=self.error_feedback)
        # modeled uplink bytes of one merged client update in the run's
        # row format (the store's if one runs, else dense f32)
        wb = (store.wire_bytes_per_update if store is not None
              else wire_bytes(params, self.quant_bits))
        snapshots: Dict[int, object] = {}
        if store is None:
            snapshots = {c: params for c in range(fl.n_clients)}
        hist = RunHistory(
            method=self.method, arch=self.trainer.cfg.arch_id,
            meta={"mu": fl.mu, "primary_frac": fl.primary_frac,
                  "alpha": fl.async_alpha, "a": fl.async_a,
                  "engine": self.engine, "window": self.buffer.window,
                  "window_secs": self.buffer.window_secs,
                  **_store_meta(store, self.store_reason,
                                self.use_kernel_agg, wb, self.mesh)})
        first = net.delays(np.arange(fl.n_clients), 0)
        q = EventQueue([ClientEvent(float(t), c, 0, 0, cost=float(t))
                        for c, t in enumerate(first)])
        # budget: same number of merges as the sync methods have
        # rounds * tau client updates
        max_updates = fl.rounds * fl.tau
        version, upd, clock = 0, 0, 0.0
        prev_peek = None   # lookahead accuracy: last prefetch's forecast
        while upd < max_updates and q:
            limit = max_updates - upd
            batch = self.buffer.drain(q, limit=limit)
            # count-closed windows close at the K-th arrival; time-closed
            # windows close at anchor + window_secs (the server must wait
            # out the deadline — it cannot know nothing else is coming)
            clock = self.buffer.close_time(batch, limit=limit)
            tel.set_virtual_time(clock)
            tel.observe("cohort.size", len(batch))
            if prev_peek is not None:
                hits = sum(1 for e in batch if e.client in prev_peek)
                tel.inc("lookahead.hit", hits)
                tel.inc("lookahead.miss", len(batch) - hits)
                prev_peek = None
            if hasattr(store, "prefetch") and q and limit > len(batch):
                # a tiered store stages the NEXT window's rows while the
                # current cohort trains (a dense store has no prefetch)
                with tel.span("window.prefetch"):
                    upcoming = self.buffer.peek_window(
                        q, limit=limit - len(batch))
                    store.prefetch([e.client for e in upcoming],
                                   keep=[e.client for e in batch])
                prev_peek = {e.client for e in upcoming}
            if tel.enabled:
                flstats.record_staleness(
                    [version + i - e.version for i, e in enumerate(batch)])
                flstats.record_client_updates([e.client for e in batch])
                # tier-less runners: one unlabeled uplink count per window
                flstats.record_uplink(len(batch) * wb)
            with tel.span("window.merge", cohort=len(batch)):
                if store is not None:
                    # the merged clients' snapshot rows are re-scattered
                    # inside the window step itself
                    params = _merge_window_store(eng, store, params, batch,
                                                 fl, version)
                else:
                    params = _merge_window(eng, params, snapshots, batch,
                                           fl, version)
            version += len(batch)
            self.cohort_sizes.append(len(batch))
            with tel.span("window.reschedule", cohort=len(batch)):
                rnds = np.asarray([e.rnd + 1 for e in batch])
                nxt = net.delays([e.client for e in batch], rnds)
                for e, t in zip(batch, nxt):
                    if store is None:
                        snapshots[e.client] = params
                    q.push(ClientEvent(clock + float(t), e.client, version,
                                       e.rnd + 1, cost=float(t)))
            prev_upd, upd = upd, upd + len(batch)
            if upd // self.eval_every > prev_upd // self.eval_every:
                with tel.span("eval"):
                    acc = self.trainer.evaluate(params)
                hist.record(time=clock, rnd=upd, acc=acc,
                            n_selected=len(batch))
                if self.verbose:
                    print(f"[{self.method}] u={upd:5d} t={clock:9.1f}s "
                          f"acc={acc:.4f} cohort={len(batch)}")
                if fl.target_accuracy and acc >= fl.target_accuracy:
                    break
        # terminal eval: the loop can exit between eval points (budget
        # exhausted off-cadence) — always record the true final state.
        if not hist.rounds or hist.rounds[-1] != upd:
            with tel.span("eval"):
                acc = self.trainer.evaluate(params)
            hist.record(time=clock, rnd=upd, acc=acc,
                        n_selected=self.cohort_sizes[-1]
                        if self.cohort_sizes else 0)
        _close_meta(hist, store, self.cohort_sizes, upd, wb)
        run_span.end()
        tel.summarize_into(hist.meta)
        return hist


def run_feddct_async(trainer, network, fl: FLConfig, *,
                     engine: str = "batched",
                     use_kernel_agg: Optional[bool] = None,
                     verbose: bool = False, eval_every: int = 1,
                     mesh=None, use_store=None, store_capacity=None,
                     store_cold_dir=None, quant_bits: int = 32,
                     error_feedback: bool = True) -> RunHistory:
    """Semi-async FedDCT: tier timeouts become aggregation windows.

    Per round: dynamic tiering + CSTT selection exactly as the sync
    scheduler (over clients not currently in flight), but selected
    clients are pushed as completion events and the round drains every
    completion inside ``deadline = max_k min(D_max^k, Omega)`` (Eq. 7
    as a window, Eq. 5/6 as the clock advance).  Clients that miss the
    window stay in flight — merged later with a staleness-discounted
    alpha instead of being dropped, so no local work is ever wasted
    (there is no re-evaluation lane: the merge itself refreshes the
    client's running-average time).
    """
    use_kernel_agg = resolve_kernel_agg(use_kernel_agg, trainer)
    rng = np.random.default_rng(fl.seed + 19)
    tel = obs.TEL
    run_span = tel.span("run", method="feddct_async").start()
    eng = make_engine(trainer, use_kernel_agg=use_kernel_agg, engine=engine,
                      mesh=mesh)
    params = trainer.init_params(fl.seed)
    # snapshot-at-selection state: store rows (device-resident flat
    # buffer) by default — tier windows always batch — with the
    # dict-of-trees path as the A/B reference (use_store=False)
    store, store_reason = _resolve_store(params, fl.n_clients, mesh,
                                         use_store, window_active=True,
                                         capacity=store_capacity,
                                         cold_dir=store_cold_dir,
                                         quant_bits=quant_bits,
                                         error_feedback=error_feedback)
    wb = (store.wire_bytes_per_update if store is not None
          else wire_bytes(params, quant_bits))
    hist = RunHistory(method="feddct_async", arch=trainer.cfg.arch_id,
                      meta={"mu": fl.mu, "primary_frac": fl.primary_frac,
                            "beta": fl.beta, "kappa": fl.kappa,
                            "omega": fl.omega, "tau": fl.tau,
                            "n_tiers": fl.n_tiers, "engine": engine,
                            "alpha": fl.async_alpha, "a": fl.async_a,
                            **_store_meta(store, store_reason,
                                          use_kernel_agg, wb, mesh)})
    clock = 0.0

    # initial kappa-round evaluation of every client (parallel), exactly
    # like the sync scheduler
    at: Dict[int, float] = {}
    ct: Dict[int, int] = {}
    setup_times = []
    for c in range(fl.n_clients):
        t_avg, spent = evaluate_client(network, c, rnd=0, kappa=fl.kappa,
                                       omega=fl.omega)
        at[c] = t_avg
        ct[c] = 0
        setup_times.append(spent)
    clock += max(setup_times)

    q = EventQueue()
    snapshots: Dict[int, object] = {}
    inflight: Dict[int, int] = {}          # client -> tier at selection
    version = 0
    t_ptr = 1
    v_curr = v_prev = 0.0
    m = max(fl.n_clients // fl.n_tiers, 1)
    cohort_sizes: List[int] = []

    for rnd in range(1, fl.rounds + 1):
        tel.set_virtual_time(clock)
        avail_at = {c: v for c, v in at.items() if c not in inflight}
        deadline = clock + fl.omega
        n_sel = 0
        if avail_at:
            sel_span = tel.span("round.select", avail=len(avail_at)).start()
            tiers = tiering(avail_at, m)
            selected, d_max, t_ptr = cstt(
                t_ptr, v_prev, v_curr, tiers, avail_at, ct, fl.tau,
                fl.beta, fl.omega, rng)
            flstats.record_tiering(
                tiers, thresholds=[min(d, fl.omega) for d in d_max],
                population=fl.n_clients)
            flstats.record_selection(selected)
            sts = network.delays([c for c, _ in selected], rnd)
            used = {k for _, k in selected}
            if used:
                deadline = clock + max(min(d_max[k], fl.omega)
                                       for k in used)
            for (c, k), st in zip(selected, sts):
                q.push(ClientEvent(clock + float(st), c, version, rnd,
                                   cost=float(st)))
                if store is None:
                    snapshots[c] = params
                inflight[c] = k
                # a client whose completion lands past the round's
                # window deadline is this design's "timeout hit" — it
                # is carried, not dropped, but it missed its tier's
                # response budget all the same.
                flstats.record_response(
                    k + 1, float(st), min(d_max[k], fl.omega),
                    timed_out=clock + float(st) > deadline)
            if store is not None and selected:
                # one scatter snapshots the whole selection at once
                store.scatter_params([c for c, _ in selected], params)
            n_sel = len(selected)
            sel_span.end()

        peeked = None
        if hasattr(store, "prefetch") and q:
            # a tiered store stages the coming window's rows now: the
            # tier timeout is known BEFORE the window opens
            with tel.span("window.prefetch"):
                upcoming = AggregationBuffer.peek_until(q, deadline)
                store.prefetch([e.client for e in upcoming])
            peeked = {e.client for e in upcoming}
        batch = AggregationBuffer.drain_until(q, deadline)
        tel.observe("cohort.size", len(batch))
        if peeked is not None:
            hits = sum(1 for e in batch if e.client in peeked)
            tel.inc("lookahead.hit", hits)
            tel.inc("lookahead.miss", len(batch) - hits)
        if batch:
            # completions selected in an EARLIER round merging now are
            # stragglers the semi-async design carried instead of drops
            carried = sum(1 for e in batch if e.rnd < rnd)
            if carried:
                tel.inc("stragglers.carried", carried)
            if tel.enabled:
                tiers_of = [inflight[e.client] + 1
                            if e.client in inflight else None
                            for e in batch]
                flstats.record_staleness(
                    [version + i - e.version for i, e in enumerate(batch)],
                    tiers_of)
                flstats.record_client_updates([e.client for e in batch])
                for e, t in zip(batch, tiers_of):
                    # per-tier modeled uplink: tier known at selection
                    flstats.record_uplink(wb, tier=t)
                    if e.rnd < rnd:
                        flstats.record_straggler("carried", tier=t)
            with tel.span("window.merge", cohort=len(batch)):
                if store is not None:
                    params = _merge_window_store(eng, store, params, batch,
                                                 fl, version)
                else:
                    params = _merge_window(eng, params, snapshots, batch,
                                           fl, version)
            version += len(batch)
            cohort_sizes.append(len(batch))
            for e in batch:
                at[e.client] = update_avg_time(at[e.client], ct[e.client],
                                               e.cost)
                ct[e.client] += 1
                inflight.pop(e.client, None)
                snapshots.pop(e.client, None)

        # Eq. 5/6 window close: last arrival if everyone made it, the
        # full deadline if stragglers are still in flight.
        clock = deadline if q else (batch[-1].finish if batch else deadline)
        tel.gauge("queue.inflight", len(q))

        if rnd % eval_every == 0:
            with tel.span("eval"):
                v_now = trainer.evaluate(params)
            hist.record(time=clock, rnd=rnd, acc=v_now, tier=t_ptr,
                        n_selected=n_sel, n_stragglers=len(q))
            v_prev, v_curr = v_curr, v_now
            if verbose:
                print(f"[feddct_async] r={rnd:4d} t={clock:9.1f}s "
                      f"tier={t_ptr} acc={v_now:.4f} merged="
                      f"{len(batch)} inflight={len(q)}")
            if fl.target_accuracy and v_now >= fl.target_accuracy:
                break
    if not hist.rounds or hist.rounds[-1] != rnd:
        with tel.span("eval"):
            acc = trainer.evaluate(params)
        hist.record(time=clock, rnd=rnd, acc=acc,
                    tier=t_ptr, n_stragglers=len(q))
    # version counts merges
    _close_meta(hist, store, cohort_sizes, version, wb)
    run_span.end()
    tel.summarize_into(hist.meta)
    return hist
