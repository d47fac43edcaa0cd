"""K1 ``fedagg``'s share of its roofline over the profiled rounds: the
least time its calls could take (``frozen/cost.py``: each live row and
the output read or written once at the HBM rate) over the device time of
its kernels (the single launch, or the tiled route's preamble and
stream, by name).  A sync round with survivors aggregates them in one
call."""

import re

from flbench.frozen.cost import cnn_param_count, k1_bound_s

_TILED = re.compile(r"fedagg_(?:ws|preamble)_kernel<(?:[^<>]*, )?0>")


def is_k1(name):
    return "fedagg_kernel<" in name or bool(_TILED.search(name))


def read(trace):
    t0, t1 = trace.profile_span
    busy = sum(b - a for a, b, n in trace.ops
               if is_k1(n) and t0 <= a and b <= t1)
    if busy <= 0:
        return None
    p = cnn_param_count(trace.config)
    bound = sum(k1_bound_s(c["live"], c["live"], p)
                for i in trace.profiled for c in trace.rounds[i]["calls"])
    return 100.0 * bound / busy
