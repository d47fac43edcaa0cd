"""Roofline analysis from compiled HLO, a copy of the JAX package's
``roofline/analysis.py`` (framework-free: ``re``, ``dataclasses`` and
``typing``), plus the H100's peaks (``H100_SXM``), the port's default.

``xla_hlo_cost_analysis`` (exposed via ``compiled.cost_analysis()``)
counts while-loop bodies ONCE, which under-reports layer-scanned models
by ~num_layers x.  So we parse the optimized HLO text ourselves:

  * per-computation: dot FLOPs (2 * output_elems * contraction) and
    collective bytes (max of operand/result bytes) by opcode;
  * call graph: fusion/call add cost once, while multiplies its body by
    the trip count recovered from the loop condition's bound constant;
  * ENTRY-rooted traversal avoids double counting.

Roofline terms (seconds, per chip):
  compute    = FLOPs / (chips * peak)
  memory     = bytes_accessed / (chips * hbm_bw)   [cost_analysis value,
               scaled by scan trip ratio when the HLO is layer-scanned]
  collective = collective_bytes / (chips * ici_bw)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# Ring-algorithm wire-cost weights (bytes actually moved per link, in
# units of the tensor size): all-reduce = reduce-scatter + all-gather.
# Without this, sequence-parallelism (which converts all-reduces into
# all-gather + reduce-scatter pairs at half the wire cost) measures as a
# regression — see EXPERIMENTS.md §Perf llama iteration v1 vs v6.
_COLL_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_elems(type_str: str) -> int:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return 0
    n = 1
    for d in m.group(2).split(","):
        if d:
            n *= int(d)
    return n


def _shape_dims(type_str: str) -> List[int]:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return []
    return [int(d) for d in m.group(2).split(",") if d]


@dataclass
class CompCost:
    dot_flops: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    calls: List[Tuple[str, float]] = field(default_factory=list)  # (comp, mult)


def _split_computations(hlo: str) -> Dict[str, List[str]]:
    comps: Dict[str, List[str]] = {}
    name = None
    for line in hlo.splitlines():
        if line and not line[0].isspace():
            m = re.match(r"(?:ENTRY\s+)?%?([\w.\-]+)\s*\(", line)
            if m and line.rstrip().endswith("{"):
                name = m.group(1)
                comps[name] = []
                if line.startswith("ENTRY"):
                    comps["__entry__"] = comps[name]
                continue
            name = None
        elif name is not None:
            comps[name].append(line.strip())
    return comps


def _instr_defs(lines: List[str]) -> Dict[str, str]:
    """name -> full type string of each instruction definition."""
    defs = {}
    for ln in lines:
        m = re.match(r"(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^)]*\)|\S+)\s", ln)
        if m:
            defs[m.group(1)] = m.group(2)
    return defs


def _operand_names(operand_str: str) -> List[str]:
    """Operand instruction names, robust to typed operands — newer HLO
    prints ``dot(f32[8,32]{1,0} %lhs, ...)`` (commas inside the type
    make naive splitting wrong)."""
    return re.findall(r"%([\w.\-]+)", operand_str)


def _operand_dims(operand_str: str, idx: int, defs: Dict[str, str]
                  ) -> List[int]:
    names = _operand_names(operand_str)
    if idx < len(names) and names[idx] in defs:
        return _shape_dims(defs[names[idx]])
    # fall back to the inline type annotation of the idx-th operand
    typed = re.findall(r"(\w+\[[\d,]*\])", operand_str)
    if idx < len(typed):
        return _shape_dims(typed[idx])
    return []


def _dot_flops(ln: str, defs: Dict[str, str]) -> float:
    out_m = re.match(r"(?:ROOT\s+)?%[\w.\-]+\s*=\s*(\S+)\s+dot\(", ln)
    if not out_m:
        return 0.0
    out_elems = _shape_elems(out_m.group(1))
    ops = re.search(r"dot\((.*)\)", ln)
    lhs_dims = _operand_dims(ops.group(1), 0, defs)
    cd = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ln)
    contraction = 1
    if cd and lhs_dims:
        for d in cd.group(1).split(","):
            if d and int(d) < len(lhs_dims):
                contraction *= lhs_dims[int(d)]
    return 2.0 * out_elems * contraction


def _conv_flops(ln: str, defs: Dict[str, str]) -> float:
    out_m = re.match(r"(?:ROOT\s+)?%[\w.\-]+\s*=\s*(\S+)\s+convolution\(", ln)
    if not out_m:
        return 0.0
    out_elems = _shape_elems(out_m.group(1))
    ops = re.search(r"convolution\((.*)\)", ln)
    k_dims = _operand_dims(ops.group(1), 1, defs)
    if not k_dims:
        return 0.0
    k = 1
    for d in k_dims[:-1]:       # all but output-feature dim
        k *= d
    return 2.0 * out_elems * k


def _trip_count(cond_lines: List[str]) -> int:
    """Loop bound: the s32 constant compared against in the condition."""
    consts = []
    for ln in cond_lines:
        for m in re.finditer(r"s32\[\]\s+constant\((\d+)\)", ln):
            consts.append(int(m.group(1)))
    return max(consts) if consts else 1


def analyze_hlo(hlo: str) -> Dict[str, float]:
    comps = _split_computations(hlo)
    costs: Dict[str, CompCost] = {}
    cond_of_body: Dict[str, str] = {}

    for name, lines in comps.items():
        if name == "__entry__" and lines is not comps.get(name):
            continue
        cc = CompCost()
        defs = _instr_defs(lines)
        for ln in lines:
            if " dot(" in ln:
                cc.dot_flops += _dot_flops(ln, defs)
            elif " convolution(" in ln:
                cc.dot_flops += _conv_flops(ln, defs)
            mcoll = re.match(
                r"(?:ROOT\s+)?%[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+"
                r"(all-reduce|all-gather|reduce-scatter|all-to-all|"
                r"collective-permute)(?:-start)?\(([^)]*)\)", ln)
            if mcoll:
                out_b = _shape_bytes(mcoll.group(1))
                in_b = 0
                for op in _operand_names(mcoll.group(3)):
                    in_b += _shape_bytes(defs.get(op, ""))
                kind = mcoll.group(2)
                cc.coll_bytes[kind] = cc.coll_bytes.get(kind, 0.0) + float(
                    max(out_b, in_b))
            # while operand may carry an inline tuple-type annotation
            mwhile = re.search(
                r"while\((?:\([^)]*\)\s*)?%[\w.\-]+\), condition=%([\w.\-]+),"
                r" body=%([\w.\-]+)", ln)
            if mwhile:
                cond, body = mwhile.group(1), mwhile.group(2)
                mknown = re.search(
                    r"known_trip_count\D*\"n\":\"(\d+)\"", ln)
                trips = int(mknown.group(1)) if mknown else _trip_count(
                    comps.get(cond, []))
                cc.calls.append((body, float(trips)))
            for mcall in re.finditer(r"calls=%([\w.\-]+)", ln):
                cc.calls.append((mcall.group(1), 1.0))
            mto = re.search(r"to_apply=%([\w.\-]+)", ln)
            if mto:
                cc.calls.append((mto.group(1), 1.0))
        costs[name] = cc

    memo: Dict[str, Tuple[float, Dict[str, float]]] = {}

    def total(name: str, depth=0) -> Tuple[float, Dict[str, float]]:
        if name in memo:
            return memo[name]
        if name not in costs or depth > 50:
            return 0.0, {}
        cc = costs[name]
        fl = cc.dot_flops
        cb = dict(cc.coll_bytes)
        for child, mult in cc.calls:
            cfl, ccb = total(child, depth + 1)
            fl += mult * cfl
            for k, v in ccb.items():
                cb[k] = cb.get(k, 0.0) + mult * v
        memo[name] = (fl, cb)
        return memo[name]

    # find the ENTRY computation: the one not called by anyone
    called = {c for cc in costs.values() for c, _ in cc.calls}
    roots = [n for n in costs if n not in called and n != "__entry__"]
    fl_total, cb_total = 0.0, {}
    for r in roots:
        fl, cb = total(r)
        fl_total += fl
        for k, v in cb.items():
            cb_total[k] = cb_total.get(k, 0.0) + v
    return {
        "dot_flops": fl_total,
        "collective_bytes": sum(cb_total.values()),
        "collective_wire_bytes": sum(_COLL_WEIGHT[k] * v
                                     for k, v in cb_total.items()),
        "collective_breakdown": cb_total,
        "n_computations": len(costs),
    }


# ---------------------------------------------------------------------------
# Hardware + roofline terms
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HWSpec:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link


TPU_V5E = HWSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)

# One NVIDIA H100 SXM5 80GB, from NVIDIA's data sheet: the dense bf16
# tensor-core rate and the HBM3 bandwidth.  ``ici_bw`` is NVLink 4's
# 900 GB/s per GPU counted in one direction (450 GB/s).
H100_SXM = HWSpec("h100-sxm5-80gb", peak_flops=989e12, hbm_bw=3.35e12,
                  ici_bw=450e9)


def roofline_terms(*, hlo_flops: float, hbm_bytes: float,
                   collective_bytes: float, chips: int,
                   hw: HWSpec = H100_SXM) -> Dict[str, float]:
    compute = hlo_flops / (chips * hw.peak_flops)
    memory = hbm_bytes / (chips * hw.hbm_bw)
    collective = collective_bytes / (chips * hw.ici_bw)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms
