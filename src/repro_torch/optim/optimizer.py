"""Minimal functional optimizer library over trees of tensors.

An optimizer is a pair of pure functions:
    init(params)                      -> state
    update(grads, state, params, lr) -> (updates, state)
Apply with ``apply_updates``.  All moments are f32 regardless of param
dtype.  Every operation is elementwise, so the same functions run on
parameters stacked with a leading client axis (the batched engine's
one-program-per-cohort step).

This is the reference's arithmetic term for term and deliberately not
``torch.optim``: Adam here keeps an int32 step, takes its bias
corrections in f32 and adds ``eps`` after ``sqrt(v / bc2)``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)


def sgd() -> Optimizer:
    def init(params):
        return ()
    def update(grads, state, params, lr):
        return tree_map(lambda g: -lr * g.float(), grads), state
    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    def update(grads, state, params, lr):
        new_m = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m
    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        leaf = tree_leaves(params)[0]
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}
    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()
        def upd(m_, v_, p):
            u = -lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return u
        return tree_map(upd, m, v, params), {"m": m, "v": v, "t": t}
    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    return adam(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adam": adam,
            "adamw": adamw}[name](**kw)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        frac = torch.clamp(torch.as_tensor(step, dtype=torch.float32)
                           / max(total_steps, 1), 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac)
                          * 0.5 * (1 + torch.cos(math.pi * frac)))
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        w = torch.clamp(step / max(warmup, 1), max=1.0)
        return torch.where(step < warmup, base_lr * w, cos(step - warmup))
    return lr
