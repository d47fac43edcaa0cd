"""Batched decode server driver (reduced configs).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --batch 4 --prompt-len 32 --gen 32

Prefills a batch of token prompts by decode steps, then serves batched
single-token decode steps with the ring-buffer KV / SSM caches — the
same ``decode_step`` as ``launch/steps.py: make_serve_step``.  Runs on
the CUDA device (and raises when there is none) unless ``--device cpu``
is given; on the card every decode step of a hybrid model runs the
selective-scan kernel once a layer.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import get_arch
from repro_torch.models import decode_step, init_decode_state, init_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises when absent) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: nothing to decode")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_model(cfg, gen, dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int64, device=device)

    cache_len = args.prompt_len + args.gen
    state = init_decode_state(cfg, args.batch, cache_len,
                              dtype=torch.float32, device=device)

    # prefill via repeated decode steps (cache-exact; fine at small scale)
    t0 = time.perf_counter()
    logits = None
    for i in range(args.prompt_len):
        logits, state = decode_step(cfg, params, state, prompts[:, i:i + 1])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prefill_t = time.perf_counter() - t0

    out_tokens = []
    sampler = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(args.gen):
        out_tokens.append(tok[:, 0])
        logits, state = decode_step(cfg, params, state, tok)
        if args.temperature > 0:
            probs = torch.softmax(logits[:, -1].float() / args.temperature,
                                  dim=-1)
            tok = torch.multinomial(probs, 1, generator=sampler)
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    toks = torch.stack(out_tokens, 1).cpu().numpy()
    decode_t = time.perf_counter() - t0
    print(f"[serve] {cfg.arch_id}: prefill {args.prompt_len} toks in "
          f"{prefill_t:.2f}s; decoded {args.gen} x{args.batch} in "
          f"{decode_t:.2f}s ({args.gen*args.batch/max(decode_t,1e-9):.1f} "
          f"tok/s)")
    print(f"[serve] sample continuation ids: {toks[0][:16].tolist()}")
    return toks


if __name__ == "__main__":
    main()
