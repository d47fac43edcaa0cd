"""Deterministic synthetic datasets.

This container is offline, so MNIST / Fashion-MNIST / CIFAR-10 are
replaced by synthetic datasets of *identical shape and cardinality*.
Each class is a smooth random prototype (mixture of 2-D Gabor-like
gratings) plus per-sample warp + noise — linearly non-separable but
CNN-learnable, so accuracy curves behave qualitatively like the real
datasets.  All FL methods see identical data, so the paper's *relative*
claims (FedDCT vs baselines) are preserved (DESIGN.md §2).
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np


def _name_salt(name: str) -> int:
    """Stable per-dataset seed offset.  Python's builtin ``hash(str)``
    is salted per process (PYTHONHASHSEED), which made every new
    process generate DIFFERENT "mnist" pixels for the same seed — the
    source of the cross-process run-to-run nondeterminism in
    ``fl_train.py``.  crc32 is a pure function of the bytes, so two
    processes (and two machines) now agree."""
    return zlib.crc32(name.encode("utf-8")) % (2 ** 16)


_SPECS = {
    "mnist": dict(hw=(28, 28, 1), n_classes=10, n_train=60_000, n_test=10_000),
    "fmnist": dict(hw=(28, 28, 1), n_classes=10, n_train=60_000, n_test=10_000),
    "cifar10": dict(hw=(32, 32, 3), n_classes=10, n_train=50_000, n_test=10_000),
}


def _prototypes(rng, hw, n_classes, n_gratings=6):
    h, w, c = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    protos = np.zeros((n_classes, h, w, c), np.float32)
    for k in range(n_classes):
        for _ in range(n_gratings):
            fx, fy = rng.uniform(0.05, 0.5, 2)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.4, 1.0)
            cx, cy = rng.uniform(0.2, 0.8, 2) * np.array([w, h])
            env = np.exp(-(((xx - cx) / (0.4 * w)) ** 2
                           + ((yy - cy) / (0.4 * h)) ** 2))
            g = amp * env * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
            for ch in range(c):
                protos[k, :, :, ch] += g * rng.uniform(0.5, 1.0)
    protos /= np.abs(protos).max(axis=(1, 2, 3), keepdims=True) + 1e-6
    return protos


def make_image_dataset(name: str, seed: int = 0, scale: float = 1.0
                       ) -> Dict[str, np.ndarray]:
    """Returns {x_train, y_train, x_test, y_test}.  ``scale`` shrinks the
    dataset cardinality for fast CI runs (1.0 = paper-sized)."""
    spec = _SPECS[name]
    rng = np.random.default_rng(seed + _name_salt(name))
    hw, ncls = spec["hw"], spec["n_classes"]
    n_train = int(spec["n_train"] * scale)
    n_test = int(spec["n_test"] * scale)
    protos = _prototypes(rng, hw, ncls)

    def gen(n):
        y = rng.integers(0, ncls, n).astype(np.int32)
        x = protos[y]
        # per-sample global shift (cheap warp) + noise
        sx = rng.integers(-2, 3, n)
        sy = rng.integers(-2, 3, n)
        x = np.stack([np.roll(np.roll(img, a, 0), b, 1)
                      for img, a, b in zip(x, sx, sy)])
        x = x * rng.uniform(0.7, 1.3, (n, 1, 1, 1)).astype(np.float32)
        x = x + rng.normal(0, 0.35, x.shape).astype(np.float32)
        return x.astype(np.float32), y

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    return {"x_train": x_tr, "y_train": y_tr, "x_test": x_te, "y_test": y_te,
            "n_classes": ncls, "hw": hw}


def make_token_dataset(vocab_size: int, n_tokens: int, seed: int = 0,
                       order: int = 2) -> np.ndarray:
    """Synthetic LM corpus: sparse high-order Markov chain over a Zipf
    vocabulary — has real sequential structure so LM losses decrease."""
    rng = np.random.default_rng(seed)
    v = int(vocab_size)
    zipf = 1.0 / np.arange(1, v + 1) ** 1.1
    zipf /= zipf.sum()
    # each context hash maps to a small candidate set
    n_ctx = 4096
    cand = rng.integers(0, v, (n_ctx, 8))
    toks = np.empty(n_tokens, np.int64)
    toks[:order] = rng.integers(0, v, order)
    state = 0
    for i in range(order, n_tokens):
        state = (state * 31 + int(toks[i - 1])) % n_ctx
        if rng.random() < 0.75:
            toks[i] = cand[state, rng.integers(0, 8)]
        else:
            toks[i] = rng.choice(v, p=zipf)
    return toks.astype(np.int32)
