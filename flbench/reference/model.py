"""The paper's CNN (MNIST) and ResNet8 (CIFAR-10) over a cohort, plainly.

A cohort of C clients is held as parameters with a leading client axis
and images ``(C, B, H, W, c)``; each convolution is one ``F.conv2d``
with the clients as groups, so every client meets only its own weights.
Layouts follow the configuration's conventions: images NHWC, kernels
HWIO, "SAME" padding with the odd element on the high side, the first
dense layer reading features in (h, w, c) order.  Parameters are a dict
from dotted names (``convs.0.w``) to tensors.

Products run in float32 with TF32 off (``full_f32``).  ``tf32=True``
emulates TF32 products instead, for the control: every operand of a
convolution or matrix product, and every gradient that flows back into
one, is rounded to TF32's 10 explicit mantissa bits.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def full_f32():
    """f32 products on the card: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def init_params(cfg: Dict, seed: int) -> Params:
    """The configuration's initialisation: truncated normals on [-2, 2]
    scaled by 1/sqrt(fan-in) from one CPU generator seeded with the run's
    seed, drawn layer by layer in the network's order; biases zero,
    ResNet scales one.  Returns one model (no client axis) on the CPU."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))

    def dense(fan_in, fan_out):
        w = torch.empty((fan_in, fan_out), dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=gen)
        return w * (1.0 / math.sqrt(fan_in))

    def conv(k, c_in, c_out):
        return dense(k * k * c_in, c_out).reshape(k, k, c_in, c_out)

    h, w, c_in = cfg["input_hw"]
    p: Params = {}
    chans = list(cfg["cnn_channels"])
    if cfg["resnet"]:
        p["stem"] = conv(3, c_in, chans[0])
        c_prev = chans[0]
        for i, c in enumerate(chans):
            p[f"blocks.{i}.conv1"] = conv(3, c_prev, c)
            p[f"blocks.{i}.conv2"] = conv(3, c, c)
            p[f"blocks.{i}.scale1"] = torch.ones(c)
            p[f"blocks.{i}.scale2"] = torch.ones(c)
            if c_prev != c:
                p[f"blocks.{i}.proj"] = conv(1, c_prev, c)
            c_prev = c
        p["fc.w"] = dense(c_prev, cfg["n_classes"])
        p["fc.b"] = torch.zeros(cfg["n_classes"])
        return p
    c_prev = c_in
    for i, c in enumerate(chans):
        p[f"convs.{i}.w"] = conv(3, c_prev, c)
        p[f"convs.{i}.b"] = torch.zeros(c)
        c_prev = c
    n_pool = 2 ** len(chans)
    dims = [(h // n_pool) * (w // n_pool) * c_prev] + list(cfg["cnn_fc"])
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"fcs.{i}.w"] = dense(a, b)
        p[f"fcs.{i}.b"] = torch.zeros(b)
    return p


def _same(x, k: int, stride: int):
    def pads(n):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        return total // 2, total - total // 2
    top, bottom = pads(x.shape[-2])
    left, right = pads(x.shape[-1])
    return F.pad(x, (left, right, top, bottom))


class _Net:
    """Forward of a cohort; ``q`` is the identity or the TF32 rounding."""

    def __init__(self, cfg: Dict, tf32: bool):
        self.cfg = cfg
        self.q = _Tf32.apply if tf32 else (lambda t: t)

    def conv(self, x, w, stride=1):
        """x (B, C*cin, H, W); w (C, k, k, cin, cout)."""
        c, k, _, cin, cout = w.shape
        wg = w.permute(0, 4, 3, 1, 2).reshape(c * cout, cin, k, k)
        y = F.conv2d(self.q(_same(x, k, stride)), self.q(wg), stride=stride,
                     groups=c)
        return self.q(y)

    def dense(self, x, w, b):
        """x (C, B, d); w (C, d, o); b (C, o)."""
        return self.q(torch.bmm(self.q(x), self.q(w))) + b[:, None, :]

    @staticmethod
    def per_channel(v):
        return v.reshape(1, -1, 1, 1)

    def norm_act(self, x, scale):
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return F.relu((x - mu) * torch.rsqrt(var + 1e-5)
                      * self.per_channel(scale))

    def logits(self, p: Params, images):
        """images (C, B, H, W, c) -> logits (C, B, n_classes)."""
        cfg = self.cfg
        c_n, b_n, h, w, c_in = images.shape
        x = images.permute(1, 0, 4, 2, 3).reshape(b_n, c_n * c_in, h, w)
        if cfg["resnet"]:
            x = self.conv(x, p["stem"])
            for i in range(len(cfg["cnn_channels"])):
                stride = 1 if i == 0 else 2
                hh = self.conv(x, p[f"blocks.{i}.conv1"], stride)
                hh = self.norm_act(hh, p[f"blocks.{i}.scale1"])
                hh = self.conv(hh, p[f"blocks.{i}.conv2"])
                proj = p.get(f"blocks.{i}.proj")
                sc = x if proj is None else self.conv(x, proj, stride)
                x = self.norm_act(hh + sc, p[f"blocks.{i}.scale2"])
            feat = x.mean(dim=(2, 3)).reshape(b_n, c_n, -1).transpose(0, 1)
            return self.dense(feat, p["fc.w"], p["fc.b"])
        for i in range(len(cfg["cnn_channels"])):
            x = F.relu(self.conv(x, p[f"convs.{i}.w"])
                       + self.per_channel(p[f"convs.{i}.b"]))
            x = F.max_pool2d(x, 2)
        _, cc, hh, ww = x.shape
        x = (x.reshape(b_n, c_n, cc // c_n, hh, ww).permute(1, 0, 3, 4, 2)
             .reshape(c_n, b_n, -1))
        n_fc = len(cfg["cnn_fc"])
        for i in range(n_fc):
            x = self.dense(x, p[f"fcs.{i}.w"], p[f"fcs.{i}.b"])
            if i < n_fc - 1:
                x = F.relu(x)
        return x

    def losses(self, p: Params, images, labels):
        """Mean softmax cross-entropy over each client's batch: (C,)."""
        logits = self.logits(p, images)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
        return (lse - gold).mean(dim=-1)


def gradients(cfg: Dict, params: Params, images, labels, *,
              tf32: bool = False) -> Params:
    """Each client's gradient of its mean loss on one batch: ``params``
    (C, ...), ``images`` (C, B, H, W, c), ``labels`` (C, B)."""
    net = _Net(cfg, tf32)
    names = list(params)
    leaves = [params[n].detach().requires_grad_(True) for n in names]
    ctx = contextlib.nullcontext() if tf32 else full_f32()
    with ctx:
        loss = net.losses(dict(zip(names, leaves)), images, labels)
        grads = torch.autograd.grad(loss.sum(), leaves)
    return dict(zip(names, grads))


class Adam:
    """Adam (Kingma and Ba) over a cohort's stacked parameters: moments
    from zero, the update ``-lr * m_hat / (sqrt(v_hat) + eps)`` with the
    bias corrections of step t."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def step(self, params: Params, grads: Params, m: Params, v: Params,
             t: int):
        """Step ``t`` (from 1): -> (params, m, v)."""
        b1, b2 = self.b1, self.b2
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        out_p, out_m, out_v = {}, {}, {}
        with torch.no_grad():
            for k, g in grads.items():
                out_m[k] = b1 * m[k] + (1.0 - b1) * g
                out_v[k] = b2 * v[k] + (1.0 - b2) * g * g
                step = (out_m[k] / bc1) / (torch.sqrt(out_v[k] / bc2)
                                           + self.eps)
                out_p[k] = params[k].detach() - self.lr * step
        return out_p, out_m, out_v


def train_cohort(cfg: Dict, starts: Params, xs, ys, lr: float, *,
                 tf32: bool = False):
    """Adam from each client's own start over its own batches.

    ``starts`` (C, ...) per name; ``xs`` (C, T, B, H, W, c), ``ys``
    (C, T, B): step t of client i takes batch ``xs[i, t]``.  Returns the
    trained models and the gradients of the first step."""
    opt = Adam(lr)
    params = {k: t.detach().clone() for k, t in starts.items()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    first = None
    for t in range(xs.shape[1]):
        grads = gradients(cfg, params, xs[:, t], ys[:, t], tf32=tf32)
        if first is None:
            first = grads
        params, m, v = opt.step(params, grads, m, v, t + 1)
    return params, first


def correct_count(cfg: Dict, p: Params, images, labels, *,
                  tf32: bool = False, chunk: int = 512) -> int:
    """Test images (N, H, W, c) rightly classified by one model (no
    client axis)."""
    net = _Net(cfg, tf32)
    one = {k: t.unsqueeze(0) for k, t in p.items()}
    hits = 0
    ctx = contextlib.nullcontext() if tf32 else full_f32()
    with torch.no_grad(), ctx:
        for i in range(0, images.shape[0], chunk):
            logits = net.logits(one, images[None, i:i + chunk])[0]
            hits += int((logits.argmax(-1) == labels[i:i + chunk]).sum())
    return hits


def stack(models: List[Params]) -> Params:
    return {k: torch.stack([m[k] for m in models]) for k in models[0]}
