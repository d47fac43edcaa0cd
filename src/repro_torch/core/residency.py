"""Tiered client-state residency: hot device rows, cold host rows.

The dense ``ClientStateStore`` is the right shape for thousands of
clients but caps the population at device memory — its ``(N, P)``
buffer must hold every client at once (full-width ``cnn-mnist`` rows
are 6,520,360 B each).  ``TieredClientStateStore`` keeps the SAME
public API (``gather``/``scatter``/``merge_scatter``/``flatten``/
``unflatten``), so ``engine.train_window`` and the async runtime are
unchanged consumers, but splits residency:

* **hot tier** — a ``(capacity, Pf)`` f32 device buffer (plus the
  ``(capacity, Pi)`` int32 sidecar), holding the rows of active and
  imminent cohorts.  Every read, write and (de)quantization is the
  dense store's own code, addressed by hot SLOT instead of client id.
* **cold tier** — every other client's row, in pinned host memory
  (``HostColdTier``, sparse: untouched clients cost nothing) or
  spilled to disk in ``checkpoint/ckpt.py`` chunks (``DiskColdTier``,
  the reference's npz format, so either package reads the other's).

Both tiers store whatever segment tuple the dense store's row format
defines — ``(f32, int32)`` rows, or ``(int8, f32 scale/snap, int32)``
rows under ``quant_bits=8``.  Residency moves raw stored segments
(bit-exact copies, never a re-quantization), and every quantize and
dequantize runs on the store's device through the dense store's code,
so histories are BIT-IDENTICAL to the dense store for any capacity
down to 1, q32 and q8 alike.  A quantized store's error-feedback
residuals move with their rows: the card holds the residuals of hot
clients only (at most ``capacity``), cold clients' residuals sit in
host memory beside their rows.

Mechanics:

* promotion (cold -> hot) happens on demand in ``gather``/
  ``merge_scatter``, or ahead of time via ``prefetch`` — the async
  runtime drives it from the ``EventQueue`` lookahead, so the NEXT
  window's rows stage while the current cohort trains;
* eviction is LRU over resident clients; ``prefetch(keep=...)`` pins
  the in-flight cohort so staging can never evict what is training;
* demotion is write-behind: only rows dirtied while hot (merged or
  scattered into) are copied back to the cold tier; clean rows are
  dropped for free;
* a cohort wider than the hot tier still works — ``gather`` joins hot
  rows and cold rows into one block, and ``merge_scatter`` (inherited)
  lands the new global row in whichever tier each merged client lives
  in (cold rows are written around, not promoted).  The merge never
  reads the buffers, so its bits cannot depend on the layout.

Stream order on a CUDA store (nothing here blocks the host but the disk
tier's file work):

* every demotion, write-around and demand promotion runs on the current
  stream: a row's device->host copy into pinned memory is enqueued
  before any later read of that host row, and a victim's write-behind
  read before the promotion that overwrites its slot;
* ``prefetch`` copies on a side stream that first waits for the current
  stream (so it sees every write-behind and every pending read of the
  slots it overwrites) and records an event per promotion; the first
  later use of such a slot makes the current stream wait for that
  event (``_slots_of``) — a device-side wait;
* the caching host allocator keeps a pinned source alive until the copy
  that reads it has run, and the hot buffers are recorded on the side
  stream, so nothing is freed under a pending copy.

Buffer contract (extends the dense store's): the store owns BOTH tiers.
Callers must not hold views of ``store.buffer``/``store.int_buffer``
across ``scatter``/``merge_scatter``/``gather``/``prefetch`` — any of
them may demote rows and rewrite hot slots — nor hold cold-tier rows.
``gather``/``gather_one`` return fresh tensors and are always safe.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.core.state import ClientStateStore
from repro_torch.obs import telemetry as obs


def _host_copy(x, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """A fresh host copy of ``x`` (a tensor or numpy array) as
    ``dtype``.  ``pin``: into page-locked memory, by a copy that does not
    block the host (from the card it runs on the current stream);
    pinning that fails raises — there is no pageable fallback."""
    x = torch.as_tensor(x)
    out = torch.empty(tuple(x.shape), dtype=dtype, pin_memory=pin)
    out.copy_(x, non_blocking=pin)
    return out


class HostColdTier:
    """Sparse host cold tier: client id -> tuple of segment rows.

    The segment layout is whatever ``*templates`` describes — ``(f32
    row, int32 row)`` for the f32 store, ``(int8 row, f32 scale/snap
    row, int32 row)`` for the quantized store, whose cold rows are
    therefore ~4x smaller (dtypes are PRESERVED, never widened).  Rows
    never written read as the template row (the dense store initializes
    every row to the template, so the default is exact), which makes a
    1M-client store cost O(touched clients), not O(N).  ``pin=True``
    (a CUDA store) keeps every row in pinned memory.
    """

    def __init__(self, *templates, pin: bool = False):
        self.pin = bool(pin)
        self._t = tuple(_host_copy(t, torch.as_tensor(t).dtype, self.pin)
                        for t in templates)
        self.row_nbytes = int(sum(t.numel() * t.element_size()
                                  for t in self._t))
        self._rows: Dict[int, Tuple[torch.Tensor, ...]] = {}

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def nbytes(self) -> int:
        """Bytes of materialized cold rows (sparse — untouched clients
        cost nothing)."""
        return len(self._rows) * self.row_nbytes

    def read(self, ids: Sequence[int], device="cpu"):
        """-> tuple of fresh (k, P_seg) row blocks on ``device``, one per
        segment, template dtypes.  To the card, each row is its own
        copy from pinned memory on the current stream."""
        idl = [int(c) for c in ids]
        out = []
        for j, t in enumerate(self._t):
            blk = torch.empty((len(idl), t.shape[0]), dtype=t.dtype,
                              device=device)
            if t.numel():
                for k, c in enumerate(idl):
                    row = self._rows.get(c)
                    blk[k].copy_(t if row is None else row[j],
                                 non_blocking=True)
            out.append(blk)
        return tuple(out)

    def write(self, ids: Sequence[int], *blocks) -> None:
        """Write rows for ``ids``.  Broadcast is PER SEGMENT: a 1-D
        block shares one row copy across every id (the scatter-one-
        global-row shape), a 2-D block is per-client — the quantized
        write-around mixes both (per-client int8/meta, one shared
        sidecar row)."""
        shared = [_host_copy(b, t.dtype, self.pin) if b.ndim == 1 else None
                  for b, t in zip(blocks, self._t)]
        for k, c in enumerate(ids):
            self._rows[int(c)] = tuple(
                s if s is not None else _host_copy(b[k], t.dtype, self.pin)
                for s, b, t in zip(shared, blocks, self._t))


class DiskColdTier:
    """Disk-spilled cold tier: rows grouped into fixed-size chunks,
    each persisted as one ``checkpoint/ckpt.py`` npz checkpoint (chunk
    index = step, segment ``j`` under key ``s{j}``), with a small
    write-behind LRU of loaded chunks.

    npz round-trips are bit-exact, so spilling through disk preserves
    the tiered store's bit-identity guarantee.  Rows reach the host by
    a blocking copy (the values must be final before they are saved);
    the file format is the reference's, so a directory spilled by
    either package reloads in the other.
    """

    def __init__(self, ckpt_dir: str, n_rows: int, *templates,
                 chunk: int = 512, cache_chunks: int = 4):
        if chunk < 1 or cache_chunks < 1:
            raise ValueError("chunk and cache_chunks must be >= 1")
        self.dir = ckpt_dir
        os.makedirs(self.dir, exist_ok=True)
        self.n = int(n_rows)
        self.chunk = int(chunk)
        self.cache_chunks = int(cache_chunks)
        # segment templates, dtypes preserved — quantized stores spill
        # int8 chunks, so their disk footprint shrinks with the rows
        self._t = tuple(self._numpy(t) for t in templates)
        self.row_nbytes = int(sum(t.nbytes for t in self._t))
        self._cache: "OrderedDict[int, Dict[str, np.ndarray]]" = OrderedDict()
        self._dirty: set = set()

    @staticmethod
    def _numpy(x) -> np.ndarray:
        """A host numpy copy of a tensor (a blocking copy: its values
        are final) or an array."""
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy().copy()
        return np.array(x)

    def _rows_in(self, cid: int) -> int:
        return min(self.chunk, self.n - cid * self.chunk)

    @property
    def nbytes(self) -> int:
        """Logical bytes of materialized chunks (on disk or cached)."""
        cids = {int(fn[5:13]) for fn in os.listdir(self.dir)
                if fn.startswith("ckpt_") and fn.endswith(".npz")}
        cids |= set(self._cache)
        return sum(self._rows_in(c) for c in cids) * self.row_nbytes

    def _load(self, cid: int) -> Dict[str, np.ndarray]:
        blk = self._cache.get(cid)
        if blk is not None:
            self._cache.move_to_end(cid)
            return blk
        rows = self._rows_in(cid)
        path = os.path.join(self.dir, f"ckpt_{cid:08d}.npz")
        if os.path.exists(path):
            like = {f"s{j}": np.zeros((rows, t.shape[0]), t.dtype)
                    for j, t in enumerate(self._t)}
            loaded = load_checkpoint(self.dir, cid, like)
            blk = {f"s{j}": np.array(loaded[f"s{j}"], t.dtype)
                   for j, t in enumerate(self._t)}
        else:
            blk = {f"s{j}": np.tile(t, (rows, 1))
                   for j, t in enumerate(self._t)}
        self._cache[cid] = blk
        while len(self._cache) > self.cache_chunks:
            old_cid, old_blk = self._cache.popitem(last=False)
            if old_cid in self._dirty:
                save_checkpoint(self.dir, old_cid, old_blk)
                self._dirty.discard(old_cid)
        return blk

    def read(self, ids: Sequence[int], device="cpu"):
        """-> tuple of fresh (k, P_seg) row blocks on ``device``."""
        outs = [np.empty((len(ids), t.shape[0]), t.dtype) for t in self._t]
        for k, c in enumerate(ids):
            c = int(c)
            blk = self._load(c // self.chunk)
            off = c % self.chunk
            for j, o in enumerate(outs):
                o[k] = blk[f"s{j}"][off]
        return tuple(torch.from_numpy(o).to(device) for o in outs)

    def write(self, ids: Sequence[int], *blocks) -> None:
        # per-segment broadcast, as in HostColdTier.write
        blocks = [self._numpy(b).astype(t.dtype, copy=False)
                  for b, t in zip(blocks, self._t)]
        for k, c in enumerate(ids):
            c = int(c)
            cid = c // self.chunk
            blk = self._load(cid)
            off = c % self.chunk
            for j, b in enumerate(blocks):
                blk[f"s{j}"][off] = b if b.ndim == 1 else b[k]
            self._dirty.add(cid)

    def flush(self) -> None:
        """Persist every dirty cached chunk (the cache is write-behind
        too; call this before handing the directory to another store)."""
        for cid in sorted(self._dirty):
            save_checkpoint(self.dir, cid, self._cache[cid])
        self._dirty.clear()


class TieredClientStateStore(ClientStateStore):
    """``ClientStateStore`` with hot-device / cold-host row residency.

    ``capacity`` hot rows live on the device; the other ``n - capacity``
    rows live in the cold tier (``cold="host"`` host memory, pinned on a
    CUDA store, or ``cold="disk"`` npz-chunk spill under ``cold_dir``).
    Same public API and bit-identical histories as the dense store — see
    the module docstring for the residency mechanics.
    """

    def __init__(self, template_params, n_clients: int, *, capacity: int,
                 cold: str = "host", cold_dir: Optional[str] = None,
                 chunk: int = 512, mesh=None, quant_bits: int = 32,
                 error_feedback: bool = True):
        if mesh is not None and int(getattr(mesh, "size", 1)) > 1:
            raise ValueError(
                "tiered residency manages one device's memory; shard the "
                "dense store over a client mesh instead (mesh= on "
                "ClientStateStore)")
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"hot tier needs >= 1 row, got {capacity}")
        # set before super().__init__ — _buffer_rows() reads it
        self.capacity = min(capacity, int(n_clients))
        super().__init__(template_params, n_clients, mesh=None,
                         quant_bits=quant_bits,
                         error_feedback=error_feedback)
        pin = self.device.type == "cuda"
        # cold templates are row 0 of the freshly-initialized hot
        # buffers — bit-consistent with every hot row for BOTH row
        # formats (the f32 init tiles the flattened template; the
        # quantized init tiles its quantized image)
        templates = tuple(b[0] for b in self.bufs)
        if cold == "host":
            self.cold = HostColdTier(*templates, pin=pin)
        elif cold == "disk":
            if not cold_dir:
                raise ValueError("cold='disk' needs cold_dir")
            self.cold = DiskColdTier(cold_dir, self.n, *templates,
                                     chunk=chunk)
        else:
            raise ValueError(f"unknown cold tier {cold!r} "
                             "(expected 'host' or 'disk')")
        self.residency = f"tiered-{cold}"
        # client -> hot slot, insertion order == LRU order (oldest first)
        self._slots: "OrderedDict[int, int]" = OrderedDict()
        self._free: List[int] = list(range(self.capacity))[::-1]
        self._dirty: set = set()
        # error-feedback residuals of cold clients, in host memory
        # (``self._ef`` keeps the hot clients' on the device)
        self._ef_cold: Dict[int, torch.Tensor] = {}
        self._pin = pin
        # prefetch copies: a side stream, and per hot slot the event of
        # a copy into it that the current stream has not waited for
        self._stream = torch.cuda.Stream(self.device) if pin else None
        self._pending: Dict[int, torch.cuda.Event] = {}
        if pin:
            for b in self.bufs:
                b.record_stream(self._stream)
        self.n_promoted = 0
        self.n_demoted = 0

    def _buffer_rows(self) -> int:
        return self.capacity

    def _cold_nbytes(self) -> int:
        return int(self.cold.nbytes)

    # -- error-feedback residuals move with their rows ------------------
    def ef_residual(self, client_id: int):
        c = int(client_id)
        r = self._ef.get(c)
        return r if r is not None else self._ef_cold.get(c)

    def _ef_update(self, ids, new_ef):
        super()._ef_update(ids, new_ef)
        self._ef_demote([int(c) for c in ids if int(c) not in self._slots])

    def _ef_demote(self, clients) -> None:
        for c in clients:
            r = self._ef.pop(c, None)
            if r is not None:
                self._ef_cold[c] = _host_copy(r, r.dtype, self._pin)

    def _ef_promote(self, clients) -> None:
        cur = torch.cuda.current_stream(self.device) if self._pin else None
        for c in clients:
            r = self._ef_cold.pop(c, None)
            if r is not None:
                r = r.to(self.device, non_blocking=True)
                if cur is not None:
                    # allocated on the copying stream, used on this one
                    r.record_stream(cur)
                self._ef[c] = r

    def bytes_by_tier(self):
        out = super().bytes_by_tier()
        out["ef"] += 4 * self.p * len(self._ef_cold)
        return out

    # -- residency core -------------------------------------------------
    @property
    def hot_clients(self) -> tuple:
        """Resident client ids, LRU order (oldest first)."""
        return tuple(self._slots)

    def _slots_of(self, clients: Sequence[int]) -> List[int]:
        """Hot slots of resident ``clients``, with the current stream
        ordered after any prefetch copy into them (a device-side wait;
        the host goes on)."""
        slots = [self._slots[c] for c in clients]
        if self._pending:
            events = {}
            for s in slots:
                ev = self._pending.pop(s, None)
                if ev is not None:
                    events[id(ev)] = ev
            cur = torch.cuda.current_stream(self.device)
            for ev in events.values():
                cur.wait_event(ev)
        return slots

    def _ensure_hot(self, want: Sequence[int], protect=frozenset(),
                    partial: bool = False,
                    kind: str = "demand") -> List[int]:
        """Make ``want`` (unique client ids) resident in the hot tier.

        Eviction is LRU over residents outside ``protect`` and
        ``want``; dirty victims are written behind to the cold tier
        (one batched device->host read) before their slots are reused,
        and promotions land as one batched host->device write.
        ``partial=True`` (prefetch) stops quietly when every remaining
        slot is pinned instead of raising.  Returns the clients
        actually promoted.

        ``kind`` tags the telemetry counters ("demand" = a gather /
        ensure_window that needed the rows NOW, "prefetch" = lookahead
        staging, whose copies run on the side stream): the prefetch hit
        rate is ``demand_hit / (demand_hit + demand_promote)`` — the
        fraction of needed rows already resident when asked for.
        """
        want = [int(c) for c in want]
        pinned = {int(c) for c in protect} | set(want)
        staged: List[Tuple[int, int]] = []
        victims: List[Tuple[int, int]] = []
        n_hit = 0
        for c in want:
            if c in self._slots:
                self._slots.move_to_end(c)
                n_hit += 1
                continue
            if self._free:
                slot = self._free.pop()
            else:
                victim = next((v for v in self._slots if v not in pinned),
                              None)
                if victim is None:
                    if partial:
                        break
                    raise RuntimeError(
                        f"hot tier exhausted: capacity {self.capacity} "
                        f"cannot stage {len(set(want))} rows with "
                        f"{len(set(protect))} pinned")
                # the victim is still resident: its pending copy is
                # awaited before its slot is read or overwritten
                self._slots_of([victim])
                slot = self._slots.pop(victim)
                victims.append((victim, slot))
            self._slots[c] = slot
            staged.append((c, slot))
        tel = obs.TEL
        # the kind-tagged counter names are f-formatted: build them only
        # while tracing (zero-overhead contract — FED004)
        if tel.enabled and n_hit:
            tel.inc(f"residency.{kind}_hit", n_hit)
        dirty = [(c, s) for c, s in victims if c in self._dirty]
        if len(victims) > len(dirty):
            tel.inc("residency.evict_clean", len(victims) - len(dirty))
        if dirty:
            # write-behind: the victims' rows are read on the current
            # stream BEFORE any promotion overwrites their slots
            with tel.span("residency.write_behind", rows=len(dirty)):
                self.cold.write([c for c, _ in dirty],
                                *self._read_rows([s for _, s in dirty]))
            tel.inc("residency.write_behind", len(dirty))
            self._dirty.difference_update(c for c, _ in dirty)
            self.n_demoted += len(dirty)
        self._ef_demote([c for c, _ in victims])
        if staged:
            ids = [c for c, _ in staged]
            slots = [s for _, s in staged]
            with tel.span("residency.promote", rows=len(staged),
                          kind=kind):
                if kind == "prefetch" and self._stream is not None:
                    side = self._stream
                    side.wait_stream(torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(side):
                        self._write_rows(slots,
                                         self.cold.read(ids, self.device))
                        self._ef_promote(ids)
                        ev = side.record_event()
                    for s in slots:
                        self._pending[s] = ev
                else:
                    self._write_rows(slots, self.cold.read(ids, self.device))
                    self._ef_promote(ids)
            if tel.enabled:
                tel.inc(f"residency.{kind}_promote", len(staged))
            self.n_promoted += len(staged)
        return [c for c, _ in staged]

    def prefetch(self, client_ids: Sequence[int], keep=()) -> List[int]:
        """EventQueue-driven staging: promote the NEXT window's rows
        while the current cohort trains (the copies run on a side
        stream; nothing blocks the host on them).  ``keep`` pins the
        in-flight cohort so staging can never evict what is training.
        Purely a hint — ``gather``/``merge_scatter`` re-stage anything
        missing, so a stale lookahead costs extra swaps, never
        correctness.  Returns the clients actually promoted."""
        uniq = list(dict.fromkeys(int(x) for x in client_ids))
        return self._ensure_hot(uniq[:self.capacity], protect=keep,
                                partial=True, kind="prefetch")

    def ensure_window(self, client_ids: Sequence[int]) -> None:
        """Stage a whole window's rows in one batched promotion (the
        engine calls this before gathering, so the looped per-client
        fallback doesn't promote one row at a time)."""
        uniq = list(dict.fromkeys(int(x) for x in client_ids))
        if len(uniq) <= self.capacity:
            self._ensure_hot(uniq)

    # -- gather / scatter (dense API, residency-aware) ------------------
    def _mixed_rows(self, idl: List[int]):
        """(k, P_seg) row blocks for ``idl`` from BOTH tiers, without
        staging — the cohort-wider-than-capacity gather path.  The
        reference assembles them on the host; here the cold rows are
        copied to the device and joined with the hot ones there (raw
        stored segments, never a re-quantization)."""
        uniq = list(dict.fromkeys(idl))
        hot = [c for c in uniq if c in self._slots]
        cold = [c for c in uniq if c not in self._slots]
        parts = []
        if hot:
            parts.append(self._read_rows(self._slots_of(hot)))
        if cold:
            parts.append(self.cold.read(cold, self.device))
        pos = {c: i for i, c in enumerate(hot + cold)}
        idx = self._ids([pos[c] for c in idl])
        return tuple(torch.cat(segs).index_select(0, idx)
                     for segs in zip(*parts))

    def gather(self, ids: Sequence[int]):
        idl = [int(c) for c in ids]
        uniq = list(dict.fromkeys(idl))
        if len(uniq) <= self.capacity:
            self._ensure_hot(uniq)
            return self._rows_to_tree(self._read_rows(self._slots_of(idl)),
                                      len(idl))
        # cohort wider than the hot tier: joined rows, no staging
        obs.TEL.inc("residency.oversubscribed_gather", len(uniq))
        with obs.TEL.span("residency.host_gather", rows=len(idl)):
            return self._rows_to_tree(self._mixed_rows(idl), len(idl))

    def gather_one(self, client_id: int):
        c = int(client_id)
        self._ensure_hot([c])
        return self._tree_at(self._slots_of([c])[0])

    def _scatter_row(self, ids, frow, irow) -> None:
        """Write one flat global row into every ``ids`` row, whichever
        tier each lives in: hot rows in place (and dirty), cold rows
        written around straight to the cold tier — no promotion.
        Quantized stores quantize per TARGET CLIENT (each has its own
        error-feedback residual) through the dense store's
        ``_quantize_for``, so the stored bits cannot depend on where
        the row lives."""
        uniq = list(dict.fromkeys(int(c) for c in ids))
        hot = [c for c in uniq if c in self._slots]
        missing = [c for c in uniq if c not in self._slots]
        if hot:
            self._put_row(self._slots_of(hot), hot, frow, irow)
            for c in hot:
                self._slots.move_to_end(c)
                self._dirty.add(c)
        if missing:
            obs.TEL.inc("residency.write_around", len(missing))
            if self.quant_bits == 8:
                qrows, mrows = self._quantize_for(missing, frow)
                self.cold.write(missing, qrows, mrows, irow)
            else:
                self.cold.write(missing, frow, irow)

    # ``scatter``, ``scatter_params`` and ``merge_scatter`` are
    # inherited unchanged: they land rows through ``_scatter_row``, and
    # the merge dispatches the standalone merge (dict-path-identical by
    # construction, independent of buffer height).
