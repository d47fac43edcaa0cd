"""Centralized (non-FL) training entry point for a registered LM arch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --steps 100 --batch 8 --seq 128

Real optimization (AdamW, global-norm clip 1.0, f32) with the reduced
config by default; ``--full`` trains the arch at its published width.
Runs on the CUDA device (and raises when there is none) unless
``--device cpu`` is given; on the card every attention call of the
chunked and banded branches and every SSM scan runs the hand-written
forward and backward kernels (``kernels/flash_attention.py``,
``kernels/ssm_scan.py``).  f32 products run in full precision (no
TF32).  The step updates the model and the optimizer state in place
(``launch/steps.py: make_train_step``).  ``--mesh`` (the data/model
mesh) waits for the LM mesh slice.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device, set_full_f32
from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import get_arch
from repro_torch.config.base import TrainConfig
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_model
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '1,1' => (data,model) over local devices")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises when absent) or cpu")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh: the data/model mesh of LM training waits for the LM "
            "mesh slice (ROADMAP.md queue 1, items 13e and 14)")
    device = resolve_device(args.device)
    set_full_f32()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "cnn":
        raise SystemExit("use examples/feddct_mnist.py for CNN workloads")
    tcfg = TrainConfig(dtype="float32", lr=args.lr, remat=False,
                       attn_chunk_q=min(128, args.seq),
                       attn_chunk_kv=min(128, args.seq))

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_model(cfg, gen, dtype=torch.float32)
    step, opt = make_train_step(cfg, tcfg)
    opt_state = opt.init(params)

    toks = make_token_dataset(cfg.vocab_size, 400_000, seed=0)
    rng = np.random.default_rng(0)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.arch_id}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq}")

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        starts = rng.integers(0, len(toks) - args.seq - 1, args.batch)
        batch = {"tokens": torch.from_numpy(
            np.stack([toks[s:s + args.seq] for s in starts])).to(device)}
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0:
            dt = (time.time() - t0) / (i + 1)
            print(f"[train] step {i+1:5d} loss={losses[-1]:.4f} "
                  f"({dt*1e3:.0f} ms/step)")
    if args.ckpt:
        save_checkpoint(args.ckpt, args.steps,
                        {"params": params, "opt": opt_state})
        print(f"[train] checkpoint saved to {args.ckpt}")
    print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
