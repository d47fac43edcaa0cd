"""Pure-numpy oracles of the client-state store's int8 row views.

Copies of the reference's ``quantize_rows_ref`` and
``dequantize_rows_ref`` (the JAX package's ``kernels/ref.py``), pinned
to them by an exact-equality test: the port's ``kernels/ops.py``
quantizer and the store are held against these, bit for bit.
"""

from __future__ import annotations


def quantize_rows_ref(frows, segs):
    """Pure-numpy oracle for ``ops.quantize_rows`` (shifted-scale int8
    row views; meta carries scale + grid-snap index per segment).
    numpy's ``round`` is round-half-to-even like XLA's, every
    intermediate stays f32 (the reciprocal multiply mirrors XLA's
    strength-reduced constant division), and the math avoids FMA-
    contractible shapes — so the parity gate asserts exact equality."""
    import numpy as np
    frows = np.asarray(frows, np.float32)
    qs, scales, snaps = [], [], []
    for off, size in segs:
        x = frows[..., off:off + size]
        lo, hi = x.min(axis=-1), x.max(axis=-1)
        rng = hi - lo
        flat0 = rng <= 0.0
        scale = np.where(flat0, np.float32(1.0),
                         rng * np.float32(1.0 / 253.0)).astype(np.float32)
        snap = np.where(
            flat0, lo,
            np.round((lo + hi) / (np.float32(2.0) * scale))
        ).astype(np.float32)
        zp = (scale * snap).astype(np.float32)
        q = np.clip(np.round((x - zp[..., None]) / scale[..., None]),
                    -127.0, 127.0).astype(np.int8)
        qs.append(q)
        scales.append(scale)
        snaps.append(snap)
    return (np.concatenate(qs, axis=-1),
            np.stack(scales + snaps, axis=-1).astype(np.float32))


def dequantize_rows_ref(qrows, meta, segs):
    """Pure-numpy oracle for ``ops.dequantize_rows``:
    ``(q + snap) * scale`` per segment, all f32."""
    import numpy as np
    qrows = np.asarray(qrows)
    meta = np.asarray(meta, np.float32)
    n = len(segs)
    outs = []
    for j, (off, size) in enumerate(segs):
        q = qrows[..., off:off + size].astype(np.float32)
        outs.append((q + meta[..., n + j, None]) * meta[..., j, None])
    return np.concatenate(outs, axis=-1)
