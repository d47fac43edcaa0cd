"""Device-resident flat client-state store — where client models LIVE.

``ClientStateStore`` holds every client's model snapshot as one row of
a single device-resident ``(N, Pf)`` f32 buffer — plus, for models that
carry non-float state (step counters, masks), a sidecar ``(N, Pi)``
int32 buffer — with the per-leaf segment/offset/shape/dtype layout
derived once at construction.  It lives on the device of its template.

* ``gather(ids)`` returns the stacked start-params tree for a cohort:
  one row gather (a copy, never a view of the buffer) and per-leaf
  slice/reshape/cast — no per-leaf host stacking, no dict lookups.
* ``scatter(ids, flat_global)`` writes one global row into the merged
  clients' rows IN PLACE (the reference donates its buffers to a jitted
  ``.at[ids].set``; here the store owns its buffers and writes into
  them), so a window costs no ``N*P`` copy.
* ``merge_scatter(ids, stacked_updates, coef, params)`` is the tail of
  the async window step: the staleness merge (global model as the
  implicit row 0, zero-coefficient rows exact no-ops — which also makes
  padded rows free), then flatten + scatter of the new global row.  The
  merge is the very function the dict-of-trees path calls
  (``_merge_folded``, or ``fedagg_fold_pytree`` with ``use_kernel``),
  so the two snapshot paths give bit-identical histories.

Buffer contract: the store owns its buffers and writes into them.
Callers must NOT hold views of ``store.buffer``/``store.int_buffer``
across ``scatter``/``merge_scatter`` — they would change under them.
``gather``/``gather_one`` return fresh tensors and are always safe.

Dtype note (segment layout): f32/bf16/f16 leaves live in the f32 row
segment (every bf16/f16 value is exactly representable in f32 — exact
round-trip).  bool and integer leaves of <= 32 bits live in the int32
sidecar: bool/int8/int16/int32/uint8/uint16 values embed exactly in
int32 (plain ``to`` both ways); uint32 round-trips by a bit-preserving
``view``.  Leaves the store cannot carry exactly — 64-bit ints, f64,
complex — are rejected at construction with ``TypeError``.

Client mesh (``mesh=`` of several shards): the buffer's rows are
padded to the plan's ``padded_n`` (a multiple of the mesh size), as the
reference pads them; the padded rows are never addressed.  The buffer
stays whole on the template's device.  The reference also places row
blocks on distinct devices — placement only, no value changes — which
waits for the multi-GPU work (ROADMAP queue 1, item 15); the window
merge stays ``merge_scatter``'s (kernel ``fedagg_fold``), as in the
reference, while the cohort's training is sharded by the engine.

Quantized rows (``quant_bits=8``): the float segment is stored as a
shifted-scale int8 ``(rows, Pf)`` buffer plus a per-leaf f32
scale/snap meta ``(rows, 2L)`` for L float leaves, beside the int32
sidecar.  Writes quantize inside ``scatter``/``scatter_params``/
``merge_scatter`` and reads dequantize inside ``gather``/``gather_one``
(``kernels/ops.py: quantize_rows``, ``dequantize_segment``: plain
PyTorch, op for op the reference's, each op its own eager kernel, so
no ``a*b + c`` is contracted and the bits equal the numpy oracle
``kernels/ref.py``).  Only cohort-sized ``(K, Pf)`` blocks ever exist
in f32.  **Error feedback** (on by default) keeps each written
client's quantization residual ``x - dq(q(x))`` — a sparse dict of
``(Pf,)`` f32 tensors on the store's device, so no write reads a
tensor back — and adds it to the client's next row before that row is
quantized, which makes the stored snapshot unbiased over successive
writes.  It models state a deployment keeps at the client, so
``bytes_by_tier()`` reports it apart (``"ef"``).  ``quant_bits=32``
(the default) is the f32 path above, unchanged; quantized runs are
seeded-deterministic but differ from f32 runs by a gated amount.

Tiered residency (``core/residency.py: TieredClientStateStore``) keeps
only some rows here and builds on four hooks: ``_buffer_rows`` (the
buffer's height), ``_read_rows`` / ``_write_rows`` (raw stored segments
of buffer rows, copied out and written in place — never re-quantized)
and ``_cold_nbytes`` (0 here).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import _merge_folded
from repro_torch.kernels.ops import (dequantize_rows, dequantize_segment,
                                     fedagg_fold_pytree, quantize_rows,
                                     tree_spec)
from repro_torch.obs import telemetry as obs
from repro_torch.tree import tree_leaves, tree_unflatten

_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_INT_DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32,
               torch.uint8, torch.uint16)


def _leaf_kind(dtype) -> str:
    """Segment + conversion rule of one leaf dtype: "f" (f32 segment),
    "i" (int32 sidecar, value-exact cast), "u32" (int32 sidecar,
    bit view).  Raises TypeError for dtypes with no exact carrier."""
    if dtype in _FLOAT_DTYPES:
        return "f"
    if dtype == torch.uint32:
        return "u32"
    if dtype in _INT_DTYPES:
        return "i"
    raise TypeError(
        f"ClientStateStore rows are f32 + int32 segments: leaf dtype "
        f"{dtype} does not round-trip exactly (float leaves up to f32 "
        "and bool/int leaves up to 32 bits only)")


def _segment_entries(spec):
    """tree_spec entries -> per-leaf (kind, segment offset, size, shape,
    dtype) with float and sidecar offsets accumulated independently.
    Returns (entries, float width Pf, sidecar width Pi)."""
    entries, f_off, i_off = [], 0, 0
    for _, size, shape, dtype in spec:
        kind = _leaf_kind(dtype)
        if kind == "f":
            entries.append((kind, f_off, size, shape, dtype))
            f_off += size
        else:
            entries.append((kind, i_off, size, shape, dtype))
            i_off += size
    return tuple(entries), f_off, i_off


def _to_rows(tree, entries, device):
    """Model tree -> ((Pf,) f32 row, (Pi,) int32 row); either row may
    be zero-width."""
    f_parts, i_parts = [], []
    for l, (kind, _, _, _, _) in zip(tree_leaves(tree), entries):
        if kind == "f":
            f_parts.append(l.reshape(-1).float())
        elif kind == "i":
            i_parts.append(l.reshape(-1).to(torch.int32))
        else:
            i_parts.append(l.reshape(-1).view(torch.int32))
    frow = (torch.cat(f_parts) if f_parts
            else torch.zeros((0,), dtype=torch.float32, device=device))
    irow = (torch.cat(i_parts) if i_parts
            else torch.zeros((0,), dtype=torch.int32, device=device))
    return frow, irow


def _leaf_from(seg, off, size, lead, kind, shape, dtype):
    x = seg[..., off:off + size].reshape(lead + tuple(shape))
    if kind == "u32":
        return x.view(torch.uint32)
    return x.to(dtype)


def _from_rows(frow, irow, treedef, entries):
    """((Pf,), (Pi,)) rows -> model tree (exact per-leaf dtypes)."""
    outs = [_leaf_from(frow if kind == "f" else irow, off, size, (),
                       kind, shape, dtype)
            for kind, off, size, shape, dtype in entries]
    return tree_unflatten(treedef, outs)


def _from_stacked_rows(frows, irows, treedef, entries):
    """((K, Pf), (K, Pi)) row blocks -> stacked tree, leaves (K, ...)."""
    k = frows.shape[0]
    outs = [_leaf_from(frows if kind == "f" else irows, off, size, (k,),
                       kind, shape, dtype)
            for kind, off, size, shape, dtype in entries]
    return tree_unflatten(treedef, outs)


def _float_segs(entries):
    """Tuple of (offset, size) float-segment views in row order — the
    per-leaf layout ``quantize_rows``/``dequantize_segment`` slice."""
    return tuple((off, size) for kind, off, size, _, _ in entries
                 if kind == "f")


def _from_quant_rows(qrows, mrows, irows, lead, treedef, entries, fsegs):
    """Quantized row blocks -> tree.  Float leaves dequantize straight
    into their leaf shapes (``dequantize_segment`` per leaf — no full
    f32 row is ever concatenated); sidecar leaves as in the f32 path."""
    outs, j = [], 0
    for kind, off, size, shape, dtype in entries:
        if kind == "f":
            x = dequantize_segment(qrows, mrows, fsegs, j)
            outs.append(x.reshape(lead + tuple(shape)).to(dtype))
            j += 1
        else:
            outs.append(_leaf_from(irows, off, size, lead, kind, shape,
                                   dtype))
    return tree_unflatten(treedef, outs)


class ClientStateStore:
    """All N client model snapshots as one device-resident (N, Pf) f32
    buffer plus an (N, Pi) int32 sidecar for non-float leaves.  One
    instance per run; it owns the buffers (see the buffer contract in
    the module docstring)."""

    def __init__(self, template_params, n_clients: int, *, mesh=None,
                 quant_bits: int = 32, error_feedback: bool = True):
        if n_clients < 1:
            raise ValueError(f"need at least one client, got {n_clients}")
        if int(quant_bits) not in (8, 32):
            raise ValueError(
                f"quant_bits must be 8 or 32, got {quant_bits}")
        treedef, spec, _ = tree_spec(template_params)
        self.treedef, self.spec = treedef, spec
        self.entries, self.p, self.pi = _segment_entries(spec)
        self.n = int(n_clients)
        self.mesh = mesh if (mesh is not None and int(mesh.size) > 1) \
            else None
        self.quant_bits = int(quant_bits)
        if self.quant_bits == 8:
            if self.mesh is not None:
                raise ValueError("quant_bits=8 does not compose with a "
                                 "sharded client mesh yet")
            if self.p == 0:
                raise ValueError("quant_bits=8 needs at least one float "
                                 "leaf to quantize")
        self._fsegs = _float_segs(self.entries) \
            if self.quant_bits == 8 else None
        # error feedback only means anything when quantizing; the
        # residual of an exact f32 write is identically zero
        self.error_feedback = bool(error_feedback) and self.quant_bits == 8
        # client id -> (Pf,) f32 quantization residual on the store's
        # device, sparse (only clients that have been written)
        self._ef = {}
        self.rows = self._buffer_rows()
        self.residency = "dense"
        self.device = tree_leaves(template_params)[0].device
        frow, irow = self._flatten(template_params)
        if self.quant_bits == 8:
            qrow, mrow = quantize_rows(frow.unsqueeze(0), self._fsegs)
            self.bufs = (qrow.repeat(self.rows, 1),
                         mrow.repeat(self.rows, 1),
                         irow.unsqueeze(0).repeat(self.rows, 1))
        else:
            self.bufs = (frow.unsqueeze(0).repeat(self.rows, 1),
                         irow.unsqueeze(0).repeat(self.rows, 1))

    def _buffer_rows(self) -> int:
        """Height of the row buffer: ``n``, or the client-mesh plan's
        padded height (called before the buffers are built; a tiered
        store allocates only its hot capacity)."""
        if self.mesh is not None:
            from repro_torch.distributed.plan import ClientShardingPlan
            return ClientShardingPlan.for_cohort(self.n, self.mesh).padded_n
        return self.n

    def _ids(self, ids) -> torch.Tensor:
        """Row ids -> an index tensor on the store's device; on a CUDA
        device staged in pinned memory and copied without blocking (a
        copy from pageable memory waits for the stream to drain)."""
        idx = torch.from_numpy(np.asarray(ids, np.int64))
        if self.device.type != "cuda":
            return idx
        return idx.pin_memory().to(self.device, non_blocking=True)

    def _rows_of(self, flat):
        """Public row value -> (frow, irow) pair.  Stores WITH a
        sidecar exchange ``(frow, irow)`` tuples; all-float stores use
        a plain (P,) row."""
        if self.pi:
            frow, irow = flat
            return frow, irow
        return flat, torch.zeros((0,), dtype=torch.int32,
                                 device=self.device)

    def _row_value(self, frow, irow):
        return (frow, irow) if self.pi else frow

    def _flatten(self, params):
        return _to_rows(params, self.entries, self.device)

    # -- error-feedback residuals ---------------------------------------
    def _ef_block(self, ids):
        """(K, Pf) residual block for ``ids`` row-aligned with the
        scatter: each written client's last residual, zeros for clients
        never written (and everywhere when EF is off).  A residual kept
        in host memory (a tiered store's cold client) is copied over
        without blocking the host."""
        zero = torch.zeros((self.p,), dtype=torch.float32,
                           device=self.device)
        kept = ([self.ef_residual(c) for c in ids]
                if self.error_feedback else [])
        if not any(r is not None for r in kept):
            return zero.expand(len(ids), self.p)
        return torch.stack([
            zero if r is None else r.to(self.device, non_blocking=True)
            for r in kept])

    def _ef_update(self, ids, new_ef):
        """Keep the (K, Pf) residuals the quantizing scatter produced,
        one copied row a client (no view keeps the block alive)."""
        if not self.error_feedback:
            return
        for j, c in enumerate(ids):
            self._ef[int(c)] = new_ef[j].clone()

    def ef_residual(self, client_id: int):
        """One client's current (Pf,) quantization residual, or None if
        that client has never been written (or EF is off)."""
        return self._ef.get(int(client_id))

    # -- byte accounting ------------------------------------------------
    @property
    def wire_bytes_per_update(self) -> int:
        """Modeled uplink bytes of ONE client update in this store's
        row format: int8 segment + f32 scale/snap meta + int32 sidecar
        when quantized, full-width f32 + sidecar otherwise."""
        if self.quant_bits == 8:
            return self.p + 8 * len(self._fsegs) + 4 * self.pi
        return 4 * self.p + 4 * self.pi

    def bytes_by_tier(self):
        """{"hot": device row bytes, "cold": spilled row bytes, "ef":
        error-feedback residual bytes} — ``ef`` is reported apart
        because it models client-side state, not store rows.  Also
        refreshes the ``store.bytes_hot``/``store.bytes_cold`` gauges."""
        hot = int(sum(b.numel() * b.element_size() for b in self.bufs))
        cold = self._cold_nbytes()
        obs.TEL.gauge("store.bytes_hot", hot)
        obs.TEL.gauge("store.bytes_cold", cold)
        return {"hot": hot, "cold": cold, "ef": 4 * self.p * len(self._ef)}

    def _cold_nbytes(self) -> int:
        """Bytes of rows held off the device: none in a dense store."""
        return 0

    # -- raw buffer rows (the residency hooks) --------------------------
    def _read_rows(self, rows):
        """-> the stored segments of buffer ``rows`` as fresh (k, ·)
        blocks (``index_select`` copies): f32 + int32, or int8 + meta +
        int32 under q8.  Duplicate rows are fine."""
        idx = self._ids(rows)
        return tuple(b.index_select(0, idx) for b in self.bufs)

    def _write_rows(self, rows, blocks) -> None:
        """Write raw segment blocks (``_read_rows``' layout) into
        buffer ``rows`` in place; ``rows`` must be unique."""
        idx = self._ids(rows)
        for buf, blk in zip(self.bufs, blocks):
            buf[idx] = blk

    def _rows_to_tree(self, blocks, k: int):
        """(k, ·) segment blocks -> stacked tree, leaves (k, ...); a
        quantized store dequantizes on the blocks' device."""
        if self.quant_bits == 8:
            return _from_quant_rows(*blocks, (k,), self.treedef,
                                    self.entries, self._fsegs)
        return _from_stacked_rows(*blocks, self.treedef, self.entries)

    def _tree_at(self, row: int):
        """Buffer row ``row`` -> one model tree (a copy)."""
        if self.quant_bits == 8:
            qbuf, mbuf, ibuf = self.bufs
            return _from_quant_rows(qbuf[row], mbuf[row], ibuf[row].clone(),
                                    (), self.treedef, self.entries,
                                    self._fsegs)
        fbuf, ibuf = self.bufs
        return _from_rows(fbuf[row].clone(), ibuf[row].clone(),
                          self.treedef, self.entries)

    def _put_row(self, rows, ids, frow, irow) -> None:
        """Write one global row into buffer ``rows`` (unique), which
        hold clients ``ids`` in the same order; a quantized store
        quantizes it for each client."""
        idx = self._ids(rows)
        if self.quant_bits == 8:
            qbuf, mbuf, ibuf = self.bufs
            qrows, mrows = self._quantize_for(ids, frow)
            qbuf[idx] = qrows
            mbuf[idx] = mrows
        else:
            fbuf, ibuf = self.bufs
            fbuf[idx] = frow
        if self.pi:
            ibuf[idx] = irow

    # -- flat <-> tree views --------------------------------------------
    @property
    def buffer(self):
        """The primary (rows, Pf) row buffer — f32, or int8 when
        ``quant_bits=8``.  Read-only by convention — do not hold a view
        across scatter/merge_scatter."""
        return self.bufs[0]

    @property
    def int_buffer(self):
        """The (rows, Pi) int32 sidecar (zero-width when the template
        has float leaves only).  Same contract as ``buffer``."""
        return self.bufs[-1]

    def flatten(self, params):
        """Model tree -> flat row: a (Pf,) f32 tensor, or a
        ``(f32 row, int32 row)`` pair when the template has non-float
        leaves."""
        return self._row_value(*self._flatten(params))

    def unflatten(self, flat):
        """Flat row (``flatten``'s convention) -> model tree with
        per-leaf shapes/dtypes."""
        frow, irow = self._rows_of(flat)
        return _from_rows(frow, irow, self.treedef, self.entries)

    # -- gather / scatter -----------------------------------------------
    def gather(self, ids: Sequence[int]):
        """-> stacked start-params tree, leaves (len(ids), ...), a copy
        of the rows (the same window scatters into them later).
        Duplicate ids are fine (padded slots repeat the last client).
        A quantized store dequantizes the gathered rows."""
        return self._rows_to_tree(self._read_rows(ids), len(ids))

    def gather_one(self, client_id: int):
        """-> one client's snapshot as a model tree (a copy)."""
        return self._tree_at(int(client_id))

    def _quantize_for(self, ids: Sequence[int], frow):
        """Quantize one global row per target client, its
        error-feedback residual added back first, and keep the fresh
        residual ``x - dq(q(x))``; returns the (K,) int8/meta row
        blocks to write.  The residual is an eager subtract of an eager
        product: nothing is FMA-contracted."""
        x = frow.unsqueeze(0) + self._ef_block(ids)
        qrows, mrows = quantize_rows(x, self._fsegs)
        if self.error_feedback:
            self._ef_update(ids, x - dequantize_rows(qrows, mrows,
                                                     self._fsegs))
        return qrows, mrows

    def scatter(self, ids: Sequence[int], flat_global):
        """Write one flat global row into every ``ids`` slot in place.
        Duplicate ids write the same row once (the ids are made
        unique first, so no write order is left to the device); a
        quantized store quantizes the row for each client."""
        self._scatter_row(ids, *self._rows_of(flat_global))

    def _scatter_row(self, ids, frow, irow) -> None:
        uniq = sorted({int(c) for c in ids})
        self._put_row(uniq, uniq, frow, irow)

    def scatter_params(self, ids: Sequence[int], params):
        """Flatten ``params`` and scatter it into ``ids``; returns the
        flat row for callers tracking the current global row (always
        the exact f32 row — quantization is internal to the buffers)."""
        frow, irow = self._flatten(params)
        self.scatter(ids, self._row_value(frow, irow))
        return self._row_value(frow, irow)

    # -- merge + scatter (the async window-step tail) -------------------
    def merge_scatter(self, ids: Sequence[int], stacked_updates, coef,
                      params, *, use_kernel: bool = False):
        """Fold one drained window into the global model and re-snapshot
        the merged clients.

        ``stacked_updates``: trained cohort tree, leaves (len(ids), ...).
        ``coef``: (len(ids)+1,) telescoped merge coefficients
        (``staleness_merge_coefficients`` order: global row 0 first) —
        zero entries (masked stragglers / padded rows) contribute
        exactly nothing.  ``params``: the current global model tree.
        ``use_kernel=True`` merges through the folded fedagg kernel
        (``fedagg_fold_pytree``), the same function the dict path's
        ``staleness_weighted_merge(use_kernel=True)`` calls; otherwise
        the dict path's ``_merge_folded``.  Returns ``(new_params,
        new_global_flat)``.
        """
        tel = obs.TEL
        with tel.span("store.merge", rows=len(ids), kernel=use_kernel):
            if use_kernel:
                new_params = fedagg_fold_pytree(params, stacked_updates,
                                                coef)
            else:
                new_params = _merge_folded(params, stacked_updates, coef)
        with tel.span("store.scatter", rows=len(ids)):
            row = self.scatter_params(ids, new_params)
        return new_params, row


def wire_bytes(params, quant_bits: int = 32) -> int:
    """Modeled uplink bytes of ONE client update for ``params`` under
    the given row format — the store-free companion of
    ``ClientStateStore.wire_bytes_per_update`` (the dict-of-trees
    runners use it so ``meta["bytes_up"]`` is comparable across
    snapshot paths)."""
    _, spec, _ = tree_spec(params)
    entries, pf, pi = _segment_entries(spec)
    if int(quant_bits) == 8:
        n_float = sum(1 for kind, *_ in entries if kind == "f")
        return pf + 8 * n_float + 4 * pi
    return 4 * pf + 4 * pi
