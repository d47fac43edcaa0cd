"""Top-k token-choice MoE with sort-based capacity dispatch (GShard-style
drops, Megablocks-style sort), the JAX package's ``models/moe.py``.

Tokens are processed in groups (default: one group per batch row).
Within a group: route -> stable-sort by expert -> take the first
``capacity`` tokens per expert -> batched expert FFN -> combine by gate
weight.  Dropped tokens pass through the residual only (standard
capacity drop).  The reference's ``vmap`` over groups is a leading G
axis here: every gather, sort and search is batched over it, with no
Python loop over groups.  The expert products are ``torch.einsum``, as
the reference computes them outside any Pallas kernel.

Where torch could order ties differently from JAX, the order is made
explicit: the top k experts come from a stable descending sort of the
router probabilities (``jax.lax.top_k`` takes the lowest index on a
tie; ``torch.topk`` promises no order on CUDA), every ``argsort`` is
stable, and ``searchsorted`` takes the reference's ``side``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, init_mlp, mlp
from repro_torch.sharding.hints import axis_size, hint


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             activation: str, dense_residual: bool = False,
             dense_ff: int = 0, dtype=torch.float32):
    """The reference's keys and shapes (the router in f32), drawn from
    ``gen`` on its device in the order router, w_gate, w_up, w_down,
    dense_mlp."""
    p = {"router": dense_init(gen, (d_model, n_experts),
                              dtype=torch.float32)}
    if activation == "swiglu":
        p["w_gate"] = dense_init(gen, (n_experts, d_model, d_ff),
                                 dtype=dtype)
    p["w_up"] = dense_init(gen, (n_experts, d_model, d_ff), dtype=dtype)
    p["w_down"] = dense_init(gen, (n_experts, d_ff, d_model), dtype=dtype)
    if dense_residual:
        p["dense_mlp"] = init_mlp(gen, d_model, dense_ff or d_ff,
                                  activation, dtype=dtype)
    return p


def capacity_for(group_size: int, top_k: int, n_experts: int,
                 factor: float) -> int:
    c = int(math.ceil(group_size * top_k / n_experts * factor))
    c = max(c, 1)
    return min(c, group_size * top_k)


def _route_group(x, router_w, top_k: int, capacity: int):
    """x (G,S,d) -> dispatch indices for each of G token groups.

    Returns:
      src_token  (G,E,C)  token index feeding each expert slot
      slot_valid (G,E,C)  slot occupancy
      tok_slot   (G,S,k)  flat slot id for each token's k-th choice
      tok_keep   (G,S,k)  survived capacity
      gates      (G,S,k)  renormalized gate weights
      probs      (G,S,E)  full router probabilities (for aux loss)
    """
    n_g, s, _ = x.shape
    e = router_w.shape[1]
    dev = x.device
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                      # (G,S,E)
    ranked, ranked_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_vals, expert_idx = ranked[..., :top_k], ranked_idx[..., :top_k]
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                    min=1e-9)

    flat_e = expert_idx.reshape(n_g, s * top_k)                # (G,S*k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order).contiguous()
    first_of = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(s * top_k, device=dev) - first_of
    inv = torch.argsort(order, dim=-1, stable=True)
    pos = torch.gather(pos_sorted, 1, inv).reshape(n_g, s, top_k)
    tok_keep = pos < capacity
    tok_slot = expert_idx * capacity + torch.clamp(pos, max=capacity - 1)

    experts = torch.arange(e, device=dev).expand(n_g, e).contiguous()
    offsets = torch.searchsorted(sorted_e, experts, side="left")
    counts = torch.searchsorted(sorted_e, experts, side="right") - offsets
    slot_rank = torch.arange(capacity, device=dev)[None, None, :]
    slot_valid = slot_rank < torch.clamp(counts, max=capacity)[..., None]
    src_sorted = torch.clamp(offsets[..., None] + slot_rank, 0,
                             s * top_k - 1)                    # (G,E,C)
    src_token = torch.gather(order, 1, src_sorted.reshape(n_g, -1)) \
        .reshape(n_g, e, capacity) // top_k
    return src_token, slot_valid, tok_slot, tok_keep, gates, probs


def moe_ffn(p, x, *, top_k: int, activation: str, capacity_factor: float,
            group_size: int = 0, dense_residual: bool = False):
    """x (B,S,d) -> (B,S,d), aux_loss (scalar f32)."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    g = group_size or s
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    if n_tok % g:
        g = n_tok                       # single group fallback (decode etc.)
    groups = tokens.reshape(-1, g, d)   # (G, S_g, d)
    n_g = groups.shape[0]
    cap = capacity_for(g, top_k, e, capacity_factor)

    src_token, slot_valid, tok_slot, tok_keep, gates, probs = \
        _route_group(groups, p["router"], top_k, cap)
    rows = torch.arange(n_g, device=x.device)[:, None, None]

    # dispatch: (G,E,C,d)
    x_slots = groups[rows, src_token]
    x_slots = x_slots * slot_valid[..., None].to(x_slots.dtype)
    x_slots = hint(x_slots, "batch", "model", None, None)

    # expert FFN
    if activation == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", x_slots, p["w_gate"]))
        h = h * torch.einsum("gecd,edf->gecf", x_slots, p["w_up"])
    else:
        h = torch.einsum("gecd,edf->gecf", x_slots, p["w_up"])
        if activation == "squared_relu":
            r = F.relu(h)
            h = r * r
        else:
            # jax.nn.gelu's default is the tanh approximation
            h = F.gelu(h, approximate="tanh")
    expert_parallel = e % max(axis_size("model"), 1) == 0
    if expert_parallel:
        h = hint(h, "batch", "model", None, None)
    else:
        h = hint(h, "batch", None, None, "model")
    y_slots = torch.einsum("gecf,efd->gecd", h, p["w_down"])  # (G,E,C,d)
    y_slots = hint(y_slots, "batch", "model", None, None)

    # combine: gather each token's k slots
    y_flat = y_slots.reshape(n_g, e * cap, d)
    y_tok = y_flat[rows, tok_slot]                             # (G,S,k,d)
    w = (gates * tok_keep).to(y_tok.dtype)                     # (G,S,k)
    y = torch.einsum("gskd,gsk->gsd", y_tok, w)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e (argmax takes
    # the first maximum, as jnp.argmax)
    me = probs.mean(dim=(0, 1))                                # (E,)
    top1 = F.one_hot(torch.argmax(probs, -1), e).float().mean(dim=(0, 1))
    aux = e * torch.sum(top1 * me)

    y = y.reshape(b, s, d).to(x.dtype)
    if dense_residual:
        y = y + mlp(p["dense_mlp"], x, activation)
    return y, aux.float()
