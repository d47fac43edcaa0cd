"""Synthetic image datasets, the benchmark's frozen copy of the image half
of ``repro_torch/data/synthetic.py``.

Each class is a smooth random prototype (a mixture of 2-D Gabor-like
gratings) plus a per-sample shift, scale and noise, at the shape of
MNIST or CIFAR-10.  The draws are the program's, in its order, so a seed
and a size give the program's pixels bit for bit; the per-sample shift
is a gather from the few rolled (class, shift) images in place of a
Python loop of ``np.roll``, which gives the same values.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

import numpy as np

SPECS = {
    "mnist": dict(hw=(28, 28, 1), n_classes=10),
    "fmnist": dict(hw=(28, 28, 1), n_classes=10),
    "cifar10": dict(hw=(32, 32, 3), n_classes=10),
}


def _name_salt(name: str) -> int:
    return zlib.crc32(name.encode("utf-8")) % (2 ** 16)


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


def _shifted(protos, y, sx, sy):
    """``np.roll(np.roll(protos[y[i]], sx[i], 0), sy[i], 1)`` for every i:
    each of the few (class, shift) images is rolled once, then gathered."""
    k = protos.shape[0]
    table = np.stack([np.roll(np.roll(protos[c], a, 0), b, 1)
                      for c in range(k) for a in range(-2, 3)
                      for b in range(-2, 3)])
    return table[(y * 5 + (sx + 2)) * 5 + (sy + 2)]


def make_image_dataset(name: str, seed: int, n_train: int, n_test: int,
                       classes_seed: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """{x_train, y_train, x_test, y_test}: images (n, h, w, c) f32 NHWC,
    labels int32.  The program's ``make_image_dataset(name, seed, scale)``
    is this at ``n_train = int(n_train_full * scale)``, ``n_test =
    int(10_000 * scale)``.  ``classes_seed`` draws the class prototypes
    from a seed of their own, as a fixed dataset holds one set of
    classes whatever the run's seed; the samples' labels, shifts, scales
    and noise are still ``seed``'s draws, in the program's order."""
    spec = SPECS[name]
    rng = np.random.default_rng(seed + _name_salt(name))
    ncls = spec["n_classes"]
    protos = _prototypes(rng, spec["hw"], ncls)
    if classes_seed is not None:
        protos = _prototypes(
            np.random.default_rng(classes_seed + _name_salt(name)),
            spec["hw"], ncls)

    def gen(n):
        y = rng.integers(0, ncls, n).astype(np.int32)
        sx = rng.integers(-2, 3, n)
        sy = rng.integers(-2, 3, n)
        x = _shifted(protos, y, sx, sy)
        x *= rng.uniform(0.7, 1.3, (n, 1, 1, 1)).astype(np.float32)
        x += rng.normal(0, 0.35, x.shape).astype(np.float32)
        return x, y

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    return {"x_train": x_tr, "y_train": y_tr, "x_test": x_te, "y_test": y_te}
