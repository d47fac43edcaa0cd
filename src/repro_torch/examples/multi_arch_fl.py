"""FedDCT as a datacenter scheduler: the paper's algorithm coordinating
LLM clients (reduced configs of the assigned architectures), not CNNs.

Each "client" performs a real train step on its own token shard; the
wireless model supplies heterogeneous virtual step times, tiers standing
for replica groups of a pod.

    PYTHONPATH=src python -m repro_torch.examples.multi_arch_fl [--device cpu]
"""

import argparse

from repro_torch.config.base import FLConfig
from repro_torch.core import run_method
from repro_torch.fl.client import build_fl_clients
from repro_torch.fl.network import WirelessNetwork


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="llama3.2-1b,xlstm-350m,hymba-1.5b")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises when absent) or cpu")
    args = ap.parse_args(argv)
    hists = {}
    for arch in args.archs.split(","):
        fl = FLConfig(n_clients=8, n_tiers=4, tau=2, rounds=args.rounds,
                      mu=0.2, primary_frac=0.7, seed=0, lr=1e-3)
        net = WirelessNetwork(fl.n_clients, fl.tier_delay_means,
                              fl.delay_std, fl.mu, fl.failure_delay, fl.seed)
        trainer = build_fl_clients(arch, fl, device=args.device)  # reduced
        hist = hists[arch] = run_method("feddct", trainer, net, fl)
        print(f"{arch:14s} next-token acc {hist.accuracy[0]:.4f} -> "
              f"{hist.accuracy[-1]:.4f}  virtual {hist.times[-1]:.0f}s "
              f"tiers={hist.tier}")
    return hists


if __name__ == "__main__":
    main()
