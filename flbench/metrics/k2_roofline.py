"""K2 ``fedagg_fold``'s share of its roofline over the profiled rounds:
the least time its calls could take (``frozen/cost.py``: the live rows,
the global row and the output at the HBM rate) over the device time of
its kernels (the single launch, or the tiled route's preamble and
stream, by name).  An async window of two or more updates merges in one
call over its padded rows."""

import re

from flbench.frozen.cost import cnn_param_count, k2_bound_s

_TILED = re.compile(r"fedagg_(?:ws|preamble)_kernel<(?:[^<>]*, )?1>")


def is_k2(name):
    return "fedagg_fold_kernel<" in name or bool(_TILED.search(name))


def read(trace):
    t0, t1 = trace.profile_span
    busy = sum(b - a for a, b, n in trace.ops
               if is_k2(n) and t0 <= a and b <= t1)
    if busy <= 0:
        return None
    p = cnn_param_count(trace.config)
    bound = sum(k2_bound_s(c["rows"], c["live"], p)
                for i in trace.profiled for c in trace.rounds[i]["calls"]
                if c["kind"] == "cohort")
    return 100.0 * bound / busy
