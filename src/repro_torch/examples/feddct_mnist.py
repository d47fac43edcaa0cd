"""End to end: federated training of the paper's CNN on
synthetic MNIST for a few hundred rounds, each method's JSON history
saved.

    PYTHONPATH=src python -m repro_torch.examples.feddct_mnist \\
        --rounds 200 --clients 50 --mu 0.1 --scale 0.1 --out runs/mnist

Paper setting: 50 clients, M=5 tiers, tau=5, beta=1.2, kappa=1, Omega=30s,
lr=0.001, batch 10, local epoch 1, #=0.7.
"""

import argparse
import os

from repro_torch.config.base import FLConfig
from repro_torch.core import run_method
from repro_torch.fl.client import build_fl_clients
from repro_torch.fl.network import WirelessNetwork


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=50)
    ap.add_argument("--mu", type=float, default=0.1)
    ap.add_argument("--primary-frac", type=float, default=0.7)
    ap.add_argument("--scale", type=float, default=0.1,
                    help="dataset scale (1.0 = full 60k MNIST)")
    ap.add_argument("--methods", default="feddct,fedavg,tifl,fedasync")
    ap.add_argument("--dataset", default="cnn-mnist",
                    choices=["cnn-mnist", "cnn-fmnist", "resnet8-cifar10"])
    ap.add_argument("--out", default="runs/mnist")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises when absent) or cpu")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    fl = FLConfig(n_clients=args.clients, n_tiers=5, tau=5,
                  rounds=args.rounds, mu=args.mu,
                  primary_frac=args.primary_frac, seed=args.seed,
                  lr=0.001, batch_size=10, local_epochs=1,
                  beta=1.2, kappa=1, omega=30.0)

    summary = []
    for method in args.methods.split(","):
        net = WirelessNetwork(fl.n_clients, fl.tier_delay_means,
                              fl.delay_std, fl.mu, fl.failure_delay, fl.seed)
        trainer = build_fl_clients(args.dataset, fl, scale=args.scale,
                                   device=args.device)
        hist = run_method(method, trainer, net, fl, verbose=True,
                          eval_every=5)
        hist.save(os.path.join(args.out, f"{method}.json"))
        summary.append((method, hist.best_accuracy(), hist.times[-1]))
    print("\nmethod     best_acc   virtual_time")
    for m, acc, t in summary:
        print(f"{m:10s} {acc:8.4f}   {t:10.1f}s")
    return summary


if __name__ == "__main__":
    main()
