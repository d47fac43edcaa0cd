"""Quickstart: FedDCT vs FedAvg on synthetic MNIST.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Shows the paper's headline effect: with unreliable clients (mu=0.3),
FedDCT reaches the same accuracy in a fraction of FedAvg's virtual
wall-clock, because the dynamic tiering + per-tier timeouts stop
stragglers from stalling every round.
"""

import argparse

from repro_torch.config.base import FLConfig
from repro_torch.core import run_method
from repro_torch.fl.client import build_fl_clients
from repro_torch.fl.network import WirelessNetwork


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises when absent) or cpu")
    args = ap.parse_args(argv)
    fl = FLConfig(n_clients=20, n_tiers=5, tau=3, rounds=args.rounds,
                  mu=0.3, primary_frac=0.7, seed=0, lr=0.003)
    print(f"== FedDCT quickstart: {fl.n_clients} clients, mu={fl.mu}, "
          f"#={fl.primary_frac}, {fl.rounds} rounds ==")

    results = {}
    for method in ("feddct", "fedavg"):
        net = WirelessNetwork(fl.n_clients, fl.tier_delay_means,
                              fl.delay_std, fl.mu, fl.failure_delay, fl.seed)
        trainer = build_fl_clients("cnn-mnist", fl, scale=0.02,
                                   device=args.device)
        results[method] = run_method(method, trainer, net, fl, verbose=True,
                                     eval_every=4)

    print("\n== summary ==")
    for m, h in results.items():
        print(f"{m:8s} best_acc={h.best_accuracy(smooth=1):.4f} "
              f"virtual_time={h.times[-1]:8.1f}s")
    speedup = results["fedavg"].times[-1] / results["feddct"].times[-1]
    print(f"\nFedDCT finished the same {fl.rounds} rounds "
          f"{speedup:.1f}x faster in simulated wall-clock (paper Table 2 "
          f"reports 31-68% time reductions).")
    return results


if __name__ == "__main__":
    main()
