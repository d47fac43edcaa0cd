#!/usr/bin/env python3
"""The library yardstick of K4's softcap kernels on one GPU:
``flex_attention`` compiled, with ``cap * tanh(s / cap)`` as its
``score_mod``, a causal block mask and ``enable_gqa``.

    python3 tools/flex_softcap.py

At llama3.2-1b's serving layer (q (2,4096,32,64), kv 8 heads) it times
the forward, and at its training layer (q (2,2048,32,64)) the forward
and autograd of the forward (the backward's dq, dk, dv), each in bf16
and f32 with the cap of 50 (Gemma 2's), beside K4's kernels on the same
inputs (the serving forward; the forward with lse and the backward
pair through ``flash_attention`` with grad).  Every call is also held
against the plain twin (``gqa_plain``, autograd of it for gradients):
its max abs error is reported beside the tolerance of
``chip_smoke.py`` (FA_TOL for outputs, the backward tolerances for
gradients), not gated.  ``chip_smoke.py`` times the same yardstick
(``chip_smoke._flex_softcap``) for its kernels line: the serving
forward, and at the training layer the forward under grad and the
backward alone, its compiles loaded from caches that a worker fills
while the kernels build.  This tool adds the forward without grad at
the training layer, forward and backward together beside the kernels',
and each compile's seconds from cold caches (under ``build/``:
``chip_smoke.FLEX_ENV``).  Times are CUDA events
(``chip_smoke.median_ms``).  The last line of standard output
is one JSON object of the rows; the line before it the card as
``nvidia-smi`` names it.  Needs one CUDA card; imports neither ``jax``
nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CAP = 50.0
# (name, batch, sequence, heads, kv heads, head dim, with the backward)
LAYERS = (("llama3.2-1b serving", 2, 4096, 32, 8, 64, False),
          ("llama3.2-1b training", 2, 2048, 32, 8, 64, True))


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def layer_row(name, b, s, h, hkv, d, backward, dtype, gen):
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import flash_attention as fa
    q, do = (torch.randn(b, s, h, d, generator=gen, device="cuda")
             .to(dtype) for _ in "qd")
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
            .to(dtype) for _ in "kv")
    call, compile_s = smoke._flex_softcap(q, k, v, CAP)
    want = fa.gqa_plain(q.float(), k.float(), v.float(), softcap=CAP)
    row = {"layer": name, "dtype": str(dtype)[6:], "q": [b, s, h, d],
           "k": [b, s, hkv, d], "causal": True, "softcap": CAP,
           "compile_s": compile_s,
           "forward_ms": smoke.median_ms(lambda: call(q, k, v), warmup=2,
                                         runs=5, per_run=5),
           "kernel_forward_ms": smoke.median_ms(
               lambda: fa.flash_attention(q, k, v, softcap=CAP), warmup=2,
               runs=5, per_run=5),
           "forward_max_abs_err": _err(call(q, k, v), want),
           "forward_tol": smoke._tol(smoke.FA_TOL, dtype)}
    if not backward:
        return row
    ins = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def flex_grads():
        return torch.autograd.grad(call(*ins), ins, do)

    def kernel_grads():
        return torch.autograd.grad(fa.flash_attention(*ins, softcap=CAP),
                                   ins, do)

    t0 = time.perf_counter()
    got = flex_grads()
    torch.cuda.synchronize()
    row["backward_compile_s"] = time.perf_counter() - t0
    ref = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    wants = torch.autograd.grad(fa.gqa_plain(*ref, softcap=CAP), ref,
                                do.float())
    row["grads_max_abs_err"] = {t: _err(a, w) for t, a, w in
                                zip(("dq", "dk", "dv"), got, wants)}
    row["grads_scale"] = {t: float(w.abs().max()) for t, w in
                          zip(("dq", "dk", "dv"), wants)}
    row["grads_tol"] = (smoke.BF16_BWD_TOL if dtype == torch.bfloat16
                        else (smoke.BWD_RTOL, smoke.BWD_ATOL))
    row["forward_and_backward_ms"] = smoke.median_ms(flex_grads, warmup=2,
                                                     runs=5, per_run=3)
    row["kernel_forward_and_backward_ms"] = smoke.median_ms(
        kernel_grads, warmup=2, runs=5, per_run=3)
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flex_softcap: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    for key, value in smoke.FLEX_ENV.items():
        os.environ.setdefault(key, value)
    from repro_torch import set_full_f32
    set_full_f32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(44)
    rows = []
    for layer in LAYERS:
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(layer_row(*layer, dtype, gen))
            print(json.dumps(rows[-1]), flush=True)
            torch.cuda.empty_cache()
    print(card, flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
