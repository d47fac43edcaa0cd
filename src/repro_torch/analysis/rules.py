"""The FED rule set for the port: the JAX package's FED001..FED007
(``repro/analysis/rules.py``), with their codes, titles and waiver
syntax, rewritten for the PyTorch idiom (``ROADMAP.md``, "Rules of the
port").

| code   | contract                                                    |
|--------|-------------------------------------------------------------|
| FED001 | no held view of a store buffer used after a row write       |
| FED002 | no host syncs in hot paths (engine/state/residency/runtime) |
| FED003 | no FMA-contractible a*b + c in bit-exactness-critical code  |
| FED004 | telemetry call sites stay zero-overhead + catalogued names  |
| FED005 | no per-call / in-loop kernel build or torch.compile         |
| FED006 | no nondeterminism sources in seeded code paths              |
| FED007 | no bare/broad exception handlers                            |

Rules are syntactic: they flag the *shape* that bit the reference,
and the waiver syntax (``fedlint: disable=FED00x -- reason`` in a
trailing comment) is the escape hatch for shapes that are benign in
context.  Deliberate blocking points and caches are allow-listed in
the rules, as the reference allow-lists its own.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from repro_torch.analysis.core import (FileContext, Finding, dotted,
                                       iter_scopes, walk_scope)

RULES: List = []


def register(cls):
    RULES.append(cls())
    return cls


def _in(rel: str, *fragments: str) -> bool:
    return any(frag in rel for frag in fragments)


def _finding(ctx: FileContext, node: ast.AST, code: str,
             message: str) -> Finding:
    return Finding(ctx.rel, node.lineno, node.col_offset, code, message,
                   end_line=getattr(node, "end_lineno", None))


def _mentions(node: ast.AST, names) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(node))


# ---------------------------------------------------------------------------
# FED001 — views of the store's buffers held across a row write
# ---------------------------------------------------------------------------

@register
class DonationContract:
    """The store owns its buffers and writes rows into them in place
    (``scatter``/``merge_scatter``/``scatter_params``/``write_rows``):
    a name bound to ``store.buffer``/``store.int_buffer``, or to a slice
    or view of one, reads rows that the write has overwritten (the
    donation contract of the reference, in place of freed memory).
    ``gather`` returns a copy (``index_select``) and is always safe, as
    are copies (``clone``, ``index_select``, ``cpu``, ...) of a buffer."""

    code = "FED001"
    title = "store-buffer reference held across a donating scatter"

    _BUF_ATTRS = ("buffer", "int_buffer")
    _SCATTERS = ("scatter", "merge_scatter", "scatter_params",
                 "write_rows")
    # methods that return a view of (or the very) tensor they are called
    # on: ``float``/``to``/``contiguous`` return the tensor itself when
    # nothing changes
    _VIEWS = ("view", "view_as", "reshape", "narrow", "select", "flatten",
              "unflatten", "squeeze", "unsqueeze", "transpose", "t",
              "permute", "movedim", "expand", "expand_as", "detach",
              "as_strided", "split", "chunk", "unbind", "float", "to",
              "contiguous", "T", "mT")

    def applies(self, rel: str) -> bool:
        return True

    def _aliases_buffer(self, node: ast.AST) -> bool:
        """``store.buffer``, or a chain of slices and view methods on it."""
        while True:
            if isinstance(node, ast.Attribute):
                if node.attr in self._BUF_ATTRS:
                    return True
                if node.attr in ("T", "mT"):
                    node = node.value
                    continue
                return False
            if isinstance(node, ast.Subscript):
                node = node.value
                continue
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._VIEWS):
                node = node.func.value
                continue
            return False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for scope in iter_scopes(ctx.tree):
            yield from self._check_scope(ctx, scope)

    def _check_scope(self, ctx, scope):
        events = []
        for node in walk_scope(scope):
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                tgt = node.targets[0].id
                kind = ("bind" if self._aliases_buffer(node.value)
                        else "rebind")
                events.append((node.lineno, node.col_offset, 2, kind, tgt,
                               node))
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._SCATTERS):
                events.append((node.lineno, node.col_offset, 1,
                               "scatter", None, node))
            elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                           ast.Load):
                events.append((node.lineno, node.col_offset, 0,
                               "use", node.id, node))
        held = {}                       # name -> "fresh" | "stale"
        for lineno, col, _prio, kind, name, node in sorted(
                events, key=lambda e: (e[0], e[1], e[2])):
            if kind == "bind":
                held[name] = "fresh"
            elif kind == "rebind":
                held.pop(name, None)
            elif kind == "scatter":
                for k in held:
                    held[k] = "stale"
            elif kind == "use" and held.get(name) == "stale":
                yield _finding(
                    ctx, node, self.code,
                    f"`{name}` was bound to a store buffer (or a view of "
                    "one) before an in-place scatter/merge_scatter/"
                    "write_rows and is used after it -- it reads the "
                    "overwritten rows; re-read the property or take a "
                    "copy (donation contract)")
                held.pop(name, None)    # one report per held ref


# ---------------------------------------------------------------------------
# FED002 — host sync in hot paths
# ---------------------------------------------------------------------------

@register
class HostSyncInHotPath:
    """The round's hot path must never block on the card: ``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize``,
    ``float()``/``int()``/``bool()`` of a torch expression and
    ``np.asarray`` on a device value all wait for the device.
    Deliberate blocking points (the residency tiers' host rows, the
    store's id and error-feedback bookkeeping, the async runner's
    history) are allow-listed per module below; anything else needs a
    waiver stating why the sync is safe."""

    code = "FED002"
    title = "host synchronization in a hot-path module"

    _HOT = ("core/engine.py", "core/state.py", "core/residency.py",
            "/runtime/")
    # module-scoped allowlist: enclosing function or class names that
    # ARE deliberate host blocking points
    _ALLOW = {
        "core/residency.py": {"HostColdTier", "DiskColdTier",
                              "_ensure_hot", "_host_rows",
                              "_scatter_row", "__init__"},
        "core/state.py": {"_ids", "_ef_update", "_ef_block", "__init__"},
    }
    _NP_SYNCS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
    _HOST_ARGS = (ast.List, ast.Tuple, ast.ListComp, ast.GeneratorExp,
                  ast.Constant, ast.Dict)
    _SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
    # tensor reductions whose python value is a device readback
    _REDUCTIONS = {"sum", "max", "min", "mean", "amax", "amin", "norm",
                   "any", "all", "prod", "argmax", "argmin", "item"}
    _HOST_MODULES = {"np", "numpy", "math", "builtins", "statistics"}

    def applies(self, rel: str) -> bool:
        return _in(rel, *self._HOT)

    def _allowed(self, ctx: FileContext, node: ast.AST) -> bool:
        allow: Set[str] = set()
        for frag, names in self._ALLOW.items():
            if frag in ctx.rel:
                allow |= names
        if not allow:
            return False
        for fn in ctx.enclosing_functions(node):
            if fn.name in allow:
                return True
        cls = ctx.enclosing_class(node)
        return cls is not None and cls.name in allow

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            msg = self._classify(node)
            if msg and not self._allowed(ctx, node):
                yield _finding(ctx, node, self.code, msg)

    def _torch_expr(self, node: ast.AST) -> bool:
        """An expression that reads a tensor's value: it names ``torch``
        or calls a reduction method on a non-host receiver."""
        if _mentions(node, ("torch",)):
            return True
        for n in ast.walk(node):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and n.func.attr in self._REDUCTIONS):
                recv = dotted(n.func.value)
                if recv is None or recv.split(".")[0] not in \
                        self._HOST_MODULES:
                    return True
        return False

    def _classify(self, node: ast.Call) -> Optional[str]:
        name = dotted(node.func)
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in self._SYNC_METHODS and not node.args \
                    and not node.keywords:
                recv = dotted(node.func.value)
                if recv is not None and recv.split(".")[0] in \
                        self._HOST_MODULES:
                    return None
                return (f".{node.func.attr}() copies the device value to "
                        "the host and waits for it -- keep it on the "
                        "device (torch.where) or waive with the reason "
                        "the sync is deliberate")
        if name in ("torch.cuda.synchronize",):
            return ("torch.cuda.synchronize() stalls the dispatch pipeline "
                    "-- hot paths must stay asynchronous")
        if name in self._NP_SYNCS:
            if node.args and isinstance(node.args[0], self._HOST_ARGS):
                return None             # packing host data, not a sync
            return (f"{name} on a possibly-device value forces a "
                    "device->host transfer in a hot-path module -- if "
                    "the argument is host data or the block is a "
                    "deliberate blocking point, waive with that reason")
        if isinstance(node.func, ast.Name) and node.func.id in (
                "float", "int", "bool"):
            if any(self._torch_expr(a) for a in node.args):
                return (f"{node.func.id}() on a torch expression "
                        "synchronizes the host in a hot-path module")
        return None


# ---------------------------------------------------------------------------
# FED003 — FMA-contraction hazard
# ---------------------------------------------------------------------------

@register
class FmaContractionHazard:
    """``nvcc`` contracts ``a*b + c`` into an FMA by default, and a
    fused expression rounds differently from the eager two-kernel
    version; the reference proved the same drift under XLA.  Code whose
    bits are gated (the row merges, the int8 rows and their residuals,
    the store's arithmetic) must not write the shape at all: restructure
    as an add feeding a mul (``(q + snap) * scale``), materialize the
    product first, or waive with the reason the expression is not
    bit-identity-gated.  The ``.cu`` sources are out of this rule's
    scope."""

    code = "FED003"
    title = "FMA-contractible a*b + c in bit-exactness-critical code"

    def applies(self, rel: str) -> bool:
        return _in(rel, "/kernels/", "core/state.py")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        state_mode = "core/state.py" in ctx.rel
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, (ast.Add, ast.Sub))):
                continue
            if not self._has_mult_operand(node):
                continue
            if state_mode and not self._tensor_context(ctx, node):
                continue                # host int bookkeeping, not math
            yield _finding(
                ctx, node, self.code,
                "a*b + c is FMA-contractible: a fused kernel rounds it "
                "differently from the eager ops, drifting bits across "
                "store/dict/tiered paths -- restructure (add feeding a "
                "mul, or materialize the product) or waive with the "
                "reason this expression is not bit-identity-gated")

    @staticmethod
    def _has_mult_operand(node: ast.BinOp) -> bool:
        for side in (node.left, node.right):
            if (isinstance(side, ast.BinOp)
                    and isinstance(side.op, ast.Mult)
                    # sequence repetition `(1,) * n` is tuple algebra
                    and not any(isinstance(s, (ast.Tuple, ast.List))
                                for s in (side.left, side.right))):
                return True
        return False

    @staticmethod
    def _tensor_context(ctx: FileContext, node: ast.AST) -> bool:
        """In core/state.py only functions that touch ``torch`` are tensor
        numerics; byte-count arithmetic over python ints cannot drift."""
        fns = ctx.enclosing_functions(node)
        scope = fns[0] if fns else ctx.tree
        return _mentions(scope, ("torch",))


# ---------------------------------------------------------------------------
# FED004 — telemetry overhead + catalogue drift
# ---------------------------------------------------------------------------

@register
class TelemetryOverhead:
    """``obs.TEL`` is a no-op singleton when tracing is off, but python
    evaluates arguments EAGERLY: an f-string, ``.format``/``%`` call,
    or any non-trivial call in the argument list runs on every
    invocation and breaks the zero-overhead contract.  Heavy arguments
    are fine behind an ``enabled`` guard (ancestor ``if tel.enabled:``
    or an early ``if not tel.enabled: return``).  Literal span/metric
    names must come from the port's catalogue
    (``repro_torch.obs.catalogue``) so traces, the validator and
    ``obs.report`` never see an unknown stream."""

    code = "FED004"
    title = "eager work or uncatalogued name at a telemetry call site"

    _METHODS = ("span", "inc", "gauge", "observe")
    _CHEAP_CALLS = {"len", "int", "float", "bool"}

    def applies(self, rel: str) -> bool:
        return True

    # -- handle discovery ----------------------------------------------
    def _handles(self, scope) -> Set[str]:
        """Names that hold the active telemetry in this scope: assigned
        from ``*.TEL``, plus the ``tel``/``TEL`` convention."""
        names = {"tel", "TEL"}
        for node in walk_scope(scope):
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                src = dotted(node.value)
                if src is not None and (src == "TEL"
                                        or src.endswith(".TEL")):
                    names.add(node.targets[0].id)
        return names

    def _is_tel_call(self, node: ast.Call, handles: Set[str]) -> bool:
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in self._METHODS):
            return False
        recv = dotted(node.func.value)
        if recv is None:
            return False
        return (recv in handles or recv == "TEL"
                or recv.endswith(".TEL"))

    # -- enabled-guard detection ---------------------------------------
    @staticmethod
    def _mentions_enabled(node: ast.AST) -> bool:
        return any(isinstance(n, ast.Attribute) and n.attr == "enabled"
                   for n in ast.walk(node))

    def _guarded(self, ctx: FileContext, node: ast.AST) -> bool:
        for a in ctx.ancestors(node):
            if isinstance(a, ast.If) and self._mentions_enabled(a.test):
                return True
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # early `if not tel.enabled: return` above the call
                for stmt in a.body:
                    if (isinstance(stmt, ast.If)
                            and stmt.lineno < node.lineno
                            and self._mentions_enabled(stmt.test)
                            and any(isinstance(s, ast.Return)
                                    for s in stmt.body)):
                        return True
                return False
        return False

    # -- checks ---------------------------------------------------------
    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for scope in iter_scopes(ctx.tree):
            handles = self._handles(scope)
            for node in walk_scope(scope):
                if (isinstance(node, ast.Call)
                        and self._is_tel_call(node, handles)):
                    yield from self._check_call(ctx, node)

    def _check_call(self, ctx, node: ast.Call):
        if not self._guarded(ctx, node):
            for arg in list(node.args) + [kw.value for kw in
                                          node.keywords]:
                msg = self._eager(arg)
                if msg:
                    yield _finding(
                        ctx, node, self.code,
                        f"{msg} at an unguarded obs.TEL.{node.func.attr} "
                        "call site -- arguments evaluate eagerly even "
                        "when tracing is off; guard with `if "
                        "tel.enabled:` or precompute (zero-overhead "
                        "contract)")
        # catalogue membership is a production contract: tests and
        # tools may record synthetic names, library code may not
        if ("repro_torch/" in ctx.rel
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            yield from self._check_name(ctx, node, node.args[0].value)

    def _eager(self, arg: ast.AST) -> Optional[str]:
        for n in ast.walk(arg):
            if isinstance(n, ast.JoinedStr) and any(
                    isinstance(v, ast.FormattedValue) for v in n.values):
                return "eager f-string formatting"
            if (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod)
                    and isinstance(n.left, ast.Constant)
                    and isinstance(n.left.value, str)):
                return "eager %-formatting"
            if isinstance(n, ast.Call):
                if (isinstance(n.func, ast.Attribute)
                        and n.func.attr == "format"):
                    return "eager .format() call"
                if not (isinstance(n.func, ast.Name)
                        and n.func.id in self._CHEAP_CALLS):
                    callee = dotted(n.func) or "<call>"
                    return f"call-bearing argument ({callee}(...))"
        return None

    def _check_name(self, ctx, node: ast.Call, name: str):
        from repro_torch.obs import catalogue
        kind = node.func.attr
        known = {"span": catalogue.SPANS, "inc": catalogue.COUNTERS,
                 "gauge": catalogue.GAUGES,
                 "observe": catalogue.HISTS}[kind]
        base = name.split("{", 1)[0]
        if base in known:
            return
        if kind == "inc" and base.startswith(catalogue.COUNTER_PREFIXES):
            return
        yield _finding(
            ctx, node, self.code,
            f"{kind} name {name!r} is not in the documented telemetry "
            "catalogue (repro_torch.obs.catalogue) -- add it there (and "
            "to the ROADMAP span/counter lists) or fix the typo")


# ---------------------------------------------------------------------------
# FED005 — kernel build / compile hazard
# ---------------------------------------------------------------------------

@register
class RecompileHazard:
    """``torch.compile(fn)`` called per invocation wraps a fresh function
    every time, and ``torch.utils.cpp_extension.load``/``load_inline``
    re-hash and may rebuild their sources: in a loop or an uncached
    function body they recompile on every call.  Cache evidence
    accepted: an enclosing ``lru_cache``/``cache`` decorator,
    ``__init__`` (once per object), a dict-cache store (``CACHE[key] =
    ...``), or assignment onto ``self``.  ``_build.load`` is the port's
    own cache (one ``nvcc`` build a source a process, kept in ``_LIBS``):
    a per-call body of it is a dict lookup, but a loop of it is
    flagged (build several sources at once with ``_build.build``)."""

    code = "FED005"
    title = "kernel build or torch.compile without a compile cache"

    _BUILDERS = ("torch.compile", "torch.utils.cpp_extension.load",
                 "torch.utils.cpp_extension.load_inline",
                 "cpp_extension.load", "cpp_extension.load_inline",
                 "_build.load")
    # builders that are a cache themselves: flagged only in a loop
    _SELF_CACHED = ("_build.load",)

    def applies(self, rel: str) -> bool:
        return "repro_torch/" in rel and "/launch/" not in rel

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name not in self._BUILDERS:
                continue
            fns = ctx.enclosing_functions(node)
            in_loop = ctx.in_loop(node) or (
                not fns and any(isinstance(a, (ast.For, ast.While))
                                for a in ctx.ancestors(node)))
            if not fns and not in_loop:
                continue                # module scope builds once
            if not in_loop and name in self._SELF_CACHED:
                continue
            if not in_loop and fns and self._cached(ctx, node, fns):
                continue
            where = ("inside a loop" if in_loop
                     else f"in the per-call body of `{fns[0].name}`")
            yield _finding(
                ctx, node, self.code,
                f"{name}(...) {where} builds a fresh program every "
                "call -- hoist to module scope, lru_cache the builder, "
                "or store the result in a dict/attribute cache "
                "(recompile hazard)")

    @staticmethod
    def _cached(ctx: FileContext, node: ast.AST, fns) -> bool:
        for fn in fns:
            if fn.name in ("__init__", "__post_init__"):
                return True
            for dec in fn.decorator_list:
                if any(isinstance(n, (ast.Name, ast.Attribute))
                       and getattr(n, "id", getattr(n, "attr", None))
                       in ("lru_cache", "cache")
                       for n in ast.walk(dec)):
                    return True
        outer = fns[-1]
        for n in ast.walk(outer):
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Subscript)
                    or (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self")
                    for t in n.targets):
                return True
        return False


# ---------------------------------------------------------------------------
# FED006 — nondeterminism sources
# ---------------------------------------------------------------------------

@register
class NondeterminismSource:
    """Seeded runs must repeat bit for bit (two seeded runs are gated
    equal on the card).  Seeded code paths must not consult process-
    dependent or wall-clock entropy or a process-global RNG: builtin
    ``hash()`` (PYTHONHASHSEED), ``time.time``, numpy's and the
    stdlib's global RNGs, and torch's: ``torch.manual_seed`` and the
    sampling calls (``torch.rand``/``randn``/``randint``/``randperm``/
    ``normal``/``bernoulli``/``multinomial``, in-place ``normal_``/
    ``uniform_``) without ``generator=``.  Use ``zlib.crc32`` salts, an
    explicit ``np.random.default_rng(seed)`` and an explicit
    ``torch.Generator``."""

    code = "FED006"
    title = "nondeterminism source in a seeded code path"

    _NP_DEFAULT = {"seed", "rand", "randn", "randint", "random",
                   "choice", "shuffle", "permutation", "normal",
                   "uniform", "standard_normal", "random_sample",
                   "get_state", "set_state"}
    _PY_RANDOM = {"random", "randint", "randrange", "choice", "choices",
                  "shuffle", "sample", "uniform", "gauss", "seed",
                  "getrandbits"}
    _TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                       "bernoulli", "multinomial", "rand_like",
                       "randn_like", "randint_like", "poisson"}
    _TORCH_INPLACE = {"normal_", "uniform_", "bernoulli_", "random_",
                      "exponential_", "geometric_", "cauchy_",
                      "log_normal_"}

    def applies(self, rel: str) -> bool:
        return True

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        in_timing_ok = _in(ctx.rel, "/launch/", "tests/", "tools/",
                           "chip_smoke")
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            msg = self._classify(node, name, in_timing_ok)
            if msg:
                yield _finding(ctx, node, self.code, msg)

    def _classify(self, node: ast.Call, name, in_timing_ok):
        if isinstance(node.func, ast.Name) and node.func.id == "hash":
            return ("builtin hash() is PYTHONHASHSEED-salted per process "
                    "-- use zlib.crc32 or hashlib for a stable salt")
        if name == "time.time" and not in_timing_ok:
            return ("time.time() in a seeded code path -- simulated time "
                    "must come from the EventQueue virtual clock; host "
                    "timing belongs in launch/tools (perf_counter)")
        if name is not None and self._np_default(name):
            return (f"{name}() uses numpy's process-global default RNG "
                    "-- thread an explicit np.random.default_rng(seed) "
                    "stream instead")
        if (name is not None and name.startswith("random.")
                and name.split(".")[1] in self._PY_RANDOM):
            return (f"{name}() uses the stdlib global RNG -- thread an "
                    "explicit seeded generator instead")
        if name in ("torch.manual_seed", "torch.seed",
                    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"):
            return (f"{name}() seeds torch's process-global RNG -- draw "
                    "from an explicit torch.Generator(...).manual_seed(s)")
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        if (name is not None and name.startswith("torch.")
                and name.count(".") == 1
                and name.split(".")[1] in self._TORCH_SAMPLERS
                and not has_gen):
            return (f"{name}() without generator= draws from torch's "
                    "process-global RNG -- pass an explicit "
                    "torch.Generator")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in self._TORCH_INPLACE and not has_gen
                and not (name or "").startswith(("np.", "numpy.",
                                                 "random."))):
            return (f".{node.func.attr}() without generator= draws from "
                    "torch's process-global RNG -- pass an explicit "
                    "torch.Generator")
        if (name is not None and (name.endswith("datetime.now")
                                  or name.endswith("datetime.utcnow")
                                  or name.endswith("datetime.today")
                                  or name.endswith("date.today"))
                and not in_timing_ok):
            return (f"{name}() reads civil time in a seeded code path -- "
                    "timestamps belong in launch/tools or run metadata")
        return None

    def _np_default(self, name: str) -> bool:
        parts = name.split(".")
        return (len(parts) == 3 and parts[0] in ("np", "numpy")
                and parts[1] == "random"
                and parts[2] in self._NP_DEFAULT)


# ---------------------------------------------------------------------------
# FED007 — bare/broad exception handlers
# ---------------------------------------------------------------------------

@register
class BroadExcept:
    """A bare ``except:`` or ``except Exception:`` swallows
    KeyboardInterrupt-adjacent failures and -- worse here -- CUDA
    errors that signal a numerics contract break.  Narrow the type, or
    waive with the reason the broad catch is load-bearing (e.g. a
    sweep harness that records per-item failures and continues)."""

    code = "FED007"
    title = "bare or broad exception handler"

    _BROAD = ("Exception", "BaseException")

    def applies(self, rel: str) -> bool:
        return True

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield _finding(ctx, node, self.code,
                               "bare `except:` — name the exception "
                               "types this handler is meant to catch")
                continue
            broad = [dotted(t) for t in
                     (node.type.elts if isinstance(node.type, ast.Tuple)
                      else [node.type])]
            hit = [b for b in broad if b in self._BROAD]
            if hit:
                yield _finding(
                    ctx, node, self.code,
                    f"`except {hit[0]}` is too broad — narrow to the "
                    "failure types this site expects, or waive with "
                    "the reason the catch-all is deliberate")
