"""Operations and bytes: the yardstick of the per-layer shares.

* Peaks of one H100 SXM (NVIDIA's data sheet), as
  ``repro_torch/roofline/cost.py`` states them.
* ``k1_bytes`` / ``k2_bytes`` and their bounds: the least traffic of one
  call of K1 ``fedagg`` (weighted average of N rows) and K2
  ``fedagg_fold`` (the folded staleness merge of K rows into the global
  row), each input byte read once and the output written once: copies
  of ``roofline/cost.py: fedagg_bound_ms`` and ``fold_bound_ms``.
* ``cnn_forward_macs`` / ``cnn_param_count``: the paper's CNN and
  ResNet8 counted from a configuration's shapes ("SAME" convolutions,
  2x2 pools, dense layers); a trained sample costs three forwards.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_TENSOR_FLOPS_PER_S = 494.7e12
# an f32-accurate product on the tensor cores in split TF32 takes three
# TF32 products: the rate the port's f32 kernels are held to
SPLIT_TF32_FLOPS_PER_S = TF32_TENSOR_FLOPS_PER_S / 3


def k1_bytes(rows: int, live: int, p: int) -> int:
    """K1 over ``rows`` rows of ``p`` floats, ``live`` of them weighted:
    the live rows and the output row, and the weights and alphas."""
    return (live * p + p) * 4 + 2 * rows * 4


def k1_bound_s(rows: int, live: int, p: int) -> float:
    return max(k1_bytes(rows, live, p) / HBM_BYTES_PER_S,
               2 * live * p / F32_FLOPS_PER_S)


def k2_bytes(rows: int, live: int, p: int, global_live: bool = True) -> int:
    """K2 over ``rows`` client rows (``live`` with a positive
    coefficient) and the global row: the live rows, the global row when
    its coefficient is positive, the output row and ``rows + 1``
    coefficients."""
    read = live + (1 if global_live else 0)
    return (read * p + p) * 4 + 4 * (rows + 1)


def k2_bound_s(rows: int, live: int, p: int,
               global_live: bool = True) -> float:
    read = live + (1 if global_live else 0)
    return max(k2_bytes(rows, live, p, global_live) / HBM_BYTES_PER_S,
               2 * read * p / F32_FLOPS_PER_S)


def _same_out(n: int, stride: int) -> int:
    return -(-n // stride)


def _layers(cfg: Dict) -> Tuple[int, int]:
    """-> (forward multiply-adds of one sample, parameter count)."""
    h, w, c_in = cfg["input_hw"]
    macs = params = 0
    if cfg["resnet"]:
        chans = cfg["cnn_channels"]
        macs += h * w * chans[0] * 9 * c_in
        params += 9 * c_in * chans[0]
        c_prev = chans[0]
        for i, c in enumerate(chans):
            stride = 1 if i == 0 else 2
            oh, ow = _same_out(h, stride), _same_out(w, stride)
            macs += oh * ow * c * 9 * c_prev + oh * ow * c * 9 * c
            params += 9 * c_prev * c + 9 * c * c + 2 * c
            if c_prev != c:
                macs += oh * ow * c * c_prev
                params += c_prev * c
            h, w, c_prev = oh, ow, c
        macs += c_prev * cfg["n_classes"]
        params += c_prev * cfg["n_classes"] + cfg["n_classes"]
        return macs, params
    c_prev = c_in
    for c in cfg["cnn_channels"]:
        macs += h * w * c * 9 * c_prev
        params += 9 * c_prev * c + c
        h, w, c_prev = h // 2, w // 2, c
    dims = (h * w * c_prev,) + tuple(cfg["cnn_fc"])
    for a, b in zip(dims[:-1], dims[1:]):
        macs += a * b
        params += a * b + b
    return macs, params


def cnn_forward_macs(cfg: Dict) -> int:
    return _layers(cfg)[0]


def cnn_param_count(cfg: Dict) -> int:
    return _layers(cfg)[1]


def cnn_train_flops(cfg: Dict) -> int:
    """Model FLOPs of one trained sample: forward, and the backward's
    two products a layer (2 FLOPs a multiply-add, three passes)."""
    return 6 * cnn_forward_macs(cfg)


def cnn_eval_flops(cfg: Dict) -> int:
    return 2 * cnn_forward_macs(cfg)
