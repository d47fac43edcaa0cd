"""FedDCT and its baselines, sync and async, on the paper's CNN workloads
and on any registered LM arch (reduced: ``fl/client.py: LMTrainer``).

    PYTHONPATH=src python -m repro_torch.launch.fl_train --arch llama3.2-1b \\
        --method feddct --rounds 20 --clients 10 --mu 0.2

    PYTHONPATH=src python -m repro_torch.launch.fl_train --arch cnn-mnist \\
        --method feddct --rounds 20 --clients 50 --tiers 5 --tau 5

    PYTHONPATH=src python -m repro_torch.launch.fl_train --arch cnn-mnist \\
        --method feddct_async --rounds 20 --clients 50 --tiers 5 --tau 5

    REPRO_TORCH_FLAGS=--force_client_shards=4 PYTHONPATH=src \\
        python -m repro_torch.launch.fl_train --arch cnn-mnist \\
        --method feddct --mesh-clients 4

Runs on the CUDA device (and raises when there is none) unless
``--device cpu`` is given.  ``--mesh-clients N`` splits every cohort
over a client mesh of N shards: every visible GPU, or — under the
forced count above — N virtual shards of the one device (the
counterpart of the JAX package's forced host devices); without either
it clamps to the devices there are.  On a CUDA device the round's
aggregation and the async window merge go through the hand-written
fedagg kernels by default (``--no-kernel-agg`` selects the per-leaf
path; with a mesh, each shard's partial sum is kernel
``fedagg_partial``).  ``--quant-bits 8`` keeps the async methods'
client rows as int8 with error feedback, ``--hot-rows K`` only K of
them on the card (the rest in pinned host memory, or in npz chunks
under ``--cold-dir``); ``--trace PATH`` /
``--report`` record the run's telemetry (``repro_torch.obs``).  The
wireless delay/failure model supplies virtual time; f32 products run in
full precision (no TF32).
"""

from __future__ import annotations

import argparse

from repro_torch import resolve_device, set_full_f32
from repro_torch.config.base import FLConfig
from repro_torch.core import run_method
from repro_torch.fl.client import build_fl_clients
from repro_torch.fl.network import WirelessNetwork


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--method", default="feddct",
                    choices=["feddct", "fedavg", "tifl", "fedasync",
                             "fedprox", "fedbuff", "feddct_async"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--tiers", type=int, default=5)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--mu", type=float, default=0.0)
    ap.add_argument("--primary-frac", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "looped"],
                    help="batched = one program over the client axis; "
                         "looped = per-client reference path")
    ap.add_argument("--kernel-agg", dest="kernel_agg", default=None,
                    action="store_true",
                    help="aggregate through the fedagg kernel path "
                         "(default on a CUDA device)")
    ap.add_argument("--no-kernel-agg", dest="kernel_agg",
                    action="store_false",
                    help="aggregate leaf by leaf instead")
    ap.add_argument("--window", type=int, default=0,
                    help="async aggregation window: merge up to K "
                         "completions per event drain (fedasync/fedbuff; "
                         "0 = one-at-a-time FedAsync)")
    ap.add_argument("--window-secs", type=float, default=0.0,
                    help="async aggregation window in virtual seconds "
                         "(fedasync/fedbuff; 0 = no time window)")
    ap.add_argument("--no-store", action="store_true",
                    help="async methods only: keep client snapshots as "
                         "a dict of trees instead of the device-resident "
                         "flat ClientStateStore (reference path, "
                         "bit-identical histories)")
    ap.add_argument("--hot-rows", type=int, default=0,
                    help="async methods only: tiered client-state "
                         "residency — keep only this many client rows "
                         "on device (hot tier) and the rest in pinned "
                         "host memory, with EventQueue-driven prefetch "
                         "(0 = dense, every row on device; histories "
                         "are bit-identical at any capacity)")
    ap.add_argument("--cold-dir", default=None,
                    help="with --hot-rows: spill the cold tier to "
                         "ckpt-chunk files under this directory "
                         "instead of pinned host memory")
    ap.add_argument("--quant-bits", type=int, default=32,
                    choices=[8, 32],
                    help="async methods only: client-state row format. "
                         "32 = the byte-for-byte f32 store path; 8 = "
                         "int8 quantized rows with per-leaf scales and "
                         "server-side error feedback (~4x smaller rows "
                         "and uplink, seeded-deterministic)")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="with --quant-bits 8: drop the per-client "
                         "error-feedback residuals (ablation)")
    ap.add_argument("--mesh-clients", type=int, default=0,
                    help="shard cohorts over a 1-D client mesh of N "
                         "devices (0 = single-device engine; for N "
                         "virtual shards of one device set "
                         "REPRO_TORCH_FLAGS=--force_client_shards=N)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises when absent) or cpu")
    ap.add_argument("--scale", type=float, default=0.05,
                    help="fraction of the dataset's cardinality to "
                         "synthesize (1.0 = paper-sized)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record runtime telemetry (spans with host and, "
                         "on the card, device time; counters) and write "
                         "the trace here; the aggregate also lands in "
                         "the history's meta['telemetry']")
    ap.add_argument("--trace-format", default="jsonl",
                    choices=["jsonl", "chrome"],
                    help="--trace output format: 'jsonl' = line-delimited "
                         "event log (repro_torch.obs.validate checks it); "
                         "'chrome' = trace_event JSON for "
                         "chrome://tracing / Perfetto")
    ap.add_argument("--report", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="print the per-tier FL run report after the run "
                         "(implies tracing even without --trace); with a "
                         "PATH also write the structured report JSON "
                         "there (see python -m repro_torch.obs.report)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    set_full_f32()
    fl = FLConfig(n_clients=args.clients, n_tiers=args.tiers, tau=args.tau,
                  rounds=args.rounds, mu=args.mu,
                  primary_frac=args.primary_frac, seed=args.seed,
                  lr=1e-3)
    net = WirelessNetwork(fl.n_clients, fl.tier_delay_means, fl.delay_std,
                          fl.mu, fl.failure_delay, fl.seed)
    trainer = build_fl_clients(args.arch, fl, scale=args.scale,
                               device=device)
    kw = dict(verbose=True, engine=args.engine,
              use_kernel_agg=args.kernel_agg)
    if args.mesh_clients > 0:
        from repro_torch.distributed import client_devices, make_client_mesh
        kw["mesh"] = make_client_mesh(args.mesh_clients,
                                      devices=client_devices(device))
        print(f"[fl_train] client mesh: {kw['mesh'].size} device(s)")
    if args.method in ("fedasync", "fedbuff"):
        kw["window"] = args.window
        kw["window_secs"] = args.window_secs
    if args.no_store and args.method in ("fedasync", "fedbuff",
                                         "feddct_async"):
        kw["use_store"] = False
    if args.hot_rows > 0 and args.method in ("fedasync", "fedbuff",
                                             "feddct_async"):
        kw["store_capacity"] = args.hot_rows
        kw["store_cold_dir"] = args.cold_dir
    if args.quant_bits != 32 and args.method in ("fedasync", "fedbuff",
                                                 "feddct_async"):
        kw["quant_bits"] = args.quant_bits
        kw["error_feedback"] = not args.no_error_feedback
    if args.trace or args.report is not None:
        from repro_torch import obs
        with obs.tracing() as tel:
            hist = run_method(args.method, trainer, net, fl, **kw)
        if args.trace:
            if args.trace_format == "chrome":
                tel.export_chrome(args.trace)
            else:
                tel.export_jsonl(args.trace)
            print(f"[fl_train] trace ({args.trace_format}) -> {args.trace}")
        if args.report is not None:
            import json as _json

            from repro_torch.obs import report as obs_report
            rep = obs_report.build_report(hist.meta["telemetry"],
                                          hist.to_json())
            print(obs_report.format_report(rep, source=args.method))
            if args.report != "-":
                with open(args.report, "w") as f:
                    _json.dump(rep, f, indent=2, sort_keys=True)
                print(f"[fl_train] report json -> {args.report}")
    else:
        hist = run_method(args.method, trainer, net, fl, **kw)
    if hist.accuracy:
        print(f"[fl_train] {args.method} on {args.arch}: "
              f"final acc={hist.accuracy[-1]:.4f} "
              f"virtual time={hist.times[-1]:.1f}s")
    else:
        print(f"[fl_train] {args.method} on {args.arch}: finished before "
              f"the first evaluation (fewer updates than eval_every)")
    if args.out:
        hist.save(args.out)
        print(f"[fl_train] history -> {args.out}")
    return hist


if __name__ == "__main__":
    main()
