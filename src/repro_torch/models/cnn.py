"""The paper's FL workloads: small CNNs (MNIST / Fashion-MNIST) and
ResNet8 (CIFAR-10), plain functions on trees of tensors.

CNN (paper §5.1): conv3x3(32) -> pool2 -> conv3x3(64) -> pool2 -> flatten
-> FC(512|128) -> FC(10).  ResNet8: 3 stages of 1 basic block each
(16/32/64 channels), as in arXiv:2204.13399.

Layout is the reference's: activations NHWC, conv weights HWIO, the
first FC sees features flattened in (h, w, c) order.

With ``im2col=True`` every function here also takes a leading client
axis: parameters stacked ``(C, ...)`` and images ``(C, B, H, W, ch)``
give logits ``(C, B, n_classes)`` and one loss per client.  That is the
reference's ``vmap`` over clients, written out: the per-client conv
weights meet their patches in one batched GEMM.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.tree import tree_map


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32):
    """Truncated-normal fan-in init (LeCun-ish)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (w * scale).to(dtype)


def _conv_init(gen, k, c_in, c_out, dtype):
    w = dense_init(gen, (k * k * c_in, c_out), dtype=dtype)
    return w.reshape(k, k, c_in, c_out)


def _same_pads(n: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial axis: output ceil(n/stride),
    the odd pad element on the high side."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2, out


def _conv(x, w, stride=1):
    """x (B,H,W,cin) NHWC, w (k,k,cin,cout) HWIO, "SAME" -> NHWC."""
    k = w.shape[0]
    top, bottom, _ = _same_pads(x.shape[1], k, stride)
    left, right, _ = _same_pads(x.shape[2], k, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _conv_im2col(x, w, stride=1):
    """Convolution as patch-extraction + GEMM.

    x (..., B, H, W, cin), w (..., k, k, cin, cout), the leading axes
    (none, or the client axis) equal in both.  Patch extraction has no
    weights, so the client axis folds into it and the weighted
    contraction is one batched GEMM over clients.  For stride 1 / odd k
    the patches are shifted slices of the padded input, whose gradient
    is pure pad-and-add (no scatter).
    """
    lead = w.shape[:-4]
    k, cin, cout = w.shape[-4], w.shape[-2], w.shape[-1]
    b, h, wd = x.shape[-4], x.shape[-3], x.shape[-2]
    if stride != 1 or k % 2 == 0:
        # general case (strided resnet stages); feature axis ordered
        # (cin, kh, kw)
        top, bottom, oh = _same_pads(h, k, stride)
        left, right, ow = _same_pads(wd, k, stride)
        xp = F.pad(x, (0, 0, left, right, top, bottom))
        sl = [xp[..., i:i + (oh - 1) * stride + 1:stride,
                 j:j + (ow - 1) * stride + 1:stride, :]
              for i in range(k) for j in range(k)]
        p = torch.stack(sl, dim=-1).reshape(*lead, b * oh * ow,
                                            cin * k * k)
        wr = torch.movedim(w, -2, -4).reshape(*lead, cin * k * k, cout)
        return (p @ wr).reshape(*lead, b, oh, ow, cout)
    r = (k - 1) // 2
    xp = F.pad(x, (0, 0, r, r, r, r))
    sl = [xp[..., i:i + h, j:j + wd, :] for i in range(k) for j in range(k)]
    p = torch.cat(sl, dim=-1)            # features ordered (kh, kw, cin)
    p = p.reshape(*lead, b * h * wd, k * k * cin)
    y = p @ w.reshape(*lead, k * k * cin, cout)
    return y.reshape(*lead, b, h, wd, cout)


def _pool(x):
    """2x2/2 max-pool over (H, W) of (..., H, W, C).

    Even sizes: reshape + max, whose gradient splits a tied maximum
    evenly, as the reference's reshape + max does.  Odd sizes ("VALID":
    the last row/column is dropped): ``max_pool2d``, whose gradient goes
    all to the first maximum of a window in row-major order, as the
    reference's ``reduce_window`` (select-and-scatter) does."""
    h, w, c = x.shape[-3:]
    lead = x.shape[:-3]
    if h % 2 or w % 2:
        y = F.max_pool2d(x.reshape(-1, h, w, c).permute(0, 3, 1, 2), 2, 2)
        return y.permute(0, 2, 3, 1).reshape(*lead, h // 2, w // 2, c)
    return x.reshape(*lead, h // 2, 2, w // 2, 2, c).amax(dim=(-4, -2))


def _per_channel(v):
    """(..., c) -> (..., 1, 1, 1, c): broadcast over (B, H, W)."""
    return v.reshape(*v.shape[:-1], 1, 1, 1, v.shape[-1])


def init_cnn(cfg: ModelConfig, gen: torch.Generator,
             dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Parameters drawn on the host from ``gen`` (a CPU generator, so a
    seed gives the same model on every device), then moved to
    ``device`` (``resolve_device``: ``cuda`` unless ``"cpu"`` is
    passed)."""
    device = resolve_device(device)
    h, w, c_in = cfg.input_hw
    params: Dict[str, Any] = {}
    if cfg.resnet:
        params["stem"] = _conv_init(gen, 3, c_in, cfg.cnn_channels[0], dtype)
        c_prev = cfg.cnn_channels[0]
        blocks = []
        for c in cfg.cnn_channels:
            blk = {
                "conv1": _conv_init(gen, 3, c_prev, c, dtype),
                "conv2": _conv_init(gen, 3, c, c, dtype),
                "scale1": torch.ones((c,), dtype=torch.float32),
                "scale2": torch.ones((c,), dtype=torch.float32),
            }
            if c_prev != c:
                blk["proj"] = _conv_init(gen, 1, c_prev, c, dtype)
            blocks.append(blk)
            c_prev = c
        params["blocks"] = blocks
        params["fc"] = {"w": dense_init(gen, (c_prev, cfg.n_classes),
                                        dtype=dtype),
                        "b": torch.zeros((cfg.n_classes,), dtype=dtype)}
    else:
        c_prev = c_in
        convs = []
        for c in cfg.cnn_channels:
            convs.append({"w": _conv_init(gen, 3, c_prev, c, dtype),
                          "b": torch.zeros((c,), dtype=dtype)})
            c_prev = c
        params["convs"] = convs
        n_pool = 2 ** len(cfg.cnn_channels)
        dims = ((h // n_pool) * (w // n_pool) * c_prev,) + cfg.cnn_fc
        params["fcs"] = [{"w": dense_init(gen, (a, b), dtype=dtype),
                          "b": torch.zeros((b,), dtype=dtype)}
                         for a, b in zip(dims[:-1], dims[1:])]
    return tree_map(lambda t: t.to(device), params)


def _norm_act(x, scale):
    # group-norm-ish (batch-independent, FL-friendly: no running stats);
    # biased variance, as jnp's ``var``
    mu = x.mean(dim=(-3, -2), keepdim=True)
    var = x.var(dim=(-3, -2), keepdim=True, unbiased=False)
    return F.relu((x - mu) * torch.rsqrt(var + 1e-5) * _per_channel(scale))


def cnn_forward(cfg: ModelConfig, params, images, *, im2col: bool = False):
    """images (B,H,W,C) -> logits (B,n_classes).

    ``im2col=True`` computes every convolution as patches + GEMM — same
    math (to float tolerance) — and admits the leading client axis (see
    the module docstring); the batched FL engine sets it.
    """
    conv = _conv_im2col if im2col else _conv
    x = images
    if cfg.resnet:
        x = conv(x, params["stem"])
        for i, blk in enumerate(params["blocks"]):
            stride = 1 if i == 0 else 2
            h = conv(x, blk["conv1"], stride)
            h = _norm_act(h, blk["scale1"])
            h = conv(h, blk["conv2"])
            sc = x if "proj" not in blk else conv(x, blk["proj"], stride)
            x = _norm_act(h + sc, blk["scale2"])
        x = x.mean(dim=(-3, -2))
        return x @ params["fc"]["w"] + params["fc"]["b"].unsqueeze(-2)
    for cv in params["convs"]:
        x = F.relu(conv(x, cv["w"]) + _per_channel(cv["b"]))
        x = _pool(x)
    x = x.reshape(*x.shape[:-3], -1)         # (h, w, c) feature order
    for i, fc in enumerate(params["fcs"]):
        x = x @ fc["w"] + fc["b"].unsqueeze(-2)
        if i < len(params["fcs"]) - 1:
            x = F.relu(x)
    return x


def cnn_loss(cfg: ModelConfig, params, batch, *, im2col: bool = False):
    """Mean softmax cross-entropy over the batch axis: a scalar, or one
    loss per client under a leading client axis."""
    logits = cnn_forward(cfg, params, batch["x"], im2col=im2col).float()
    labels = batch["y"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    return (lse - gold).mean(dim=-1)


def cnn_accuracy(cfg: ModelConfig, params, xs, ys, batch: int = 512):
    correct = 0
    with torch.no_grad():
        for i in range(0, xs.shape[0], batch):
            logits = cnn_forward(cfg, params, xs[i:i + batch])
            correct += int((logits.argmax(-1) == ys[i:i + batch]).sum())
    return correct / xs.shape[0]
