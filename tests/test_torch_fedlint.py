"""The port's fedlint (``repro_torch.analysis``): the reference's rule
codes, waiver syntax, driver and CLI, with the rules rewritten for
PyTorch.  Each rule has a fixture that fires and one that does not (the
shapes of ``tests/test_fedlint.py``, in torch); the waiver parser, the
CLI's exit codes and its ``--json`` schema equal the reference's; and
the self-check: the port, its tests, ``chip_smoke.py`` and ``tools/``
lint clean under the torch rules.

Fixture sources are written to tmp files and linted under a chosen
*display* path, because most rules scope by relative path.  Waiver
comments inside fixtures are built by string concatenation so this
file's own raw lines never match the waiver scanner.
"""

from __future__ import annotations

import json
import pathlib
import textwrap

import pytest

from repro.analysis import core as ref_core
from repro.analysis import fedlint as ref_fedlint
from repro.analysis import rules as ref_rules
from repro.analysis import waivers as ref_waivers
from repro_torch.analysis import core, waivers
from repro_torch.analysis.core import lint_file
from repro_torch.analysis.fedlint import main as fedlint_main
from repro_torch.analysis.rules import RULES
from repro_torch.analysis.waivers import META_RULE, parse_waivers

ALL_CODES = {r.code for r in RULES}
ROOT = pathlib.Path(__file__).resolve().parents[1]


def waive(codes: str, reason: str = "fixture-approved") -> str:
    # concatenated so this test file's source never contains a literal
    # waiver comment (the scanner reads raw lines, not the AST)
    return "# fed" + "lint: disable=" + codes + " -- " + reason


def lint(tmp_path, src: str, rel: str, select=None):
    p = tmp_path / "fx.py"
    p.write_text(textwrap.dedent(src))
    rules = RULES if select is None else [r for r in RULES
                                          if r.code in select]
    return lint_file(str(p), rel, rules)


def only(findings, code: str):
    return [f for f in findings if f.rule == code]


def unwaived(findings, code: str):
    return [f for f in findings if f.rule == code and not f.waived]


# ---------------------------------------------------------------------------
# the rule catalogue and the waiver parser: the reference's
# ---------------------------------------------------------------------------

def test_codes_and_titles_are_the_reference_catalogue():
    """The same codes in the same order and the same titles, but for
    FED005's, which names what the port builds in place of jax.jit."""
    got = {r.code: r.title for r in RULES}
    want = {r.code: r.title for r in ref_rules.RULES}
    assert [r.code for r in RULES] == [r.code for r in ref_rules.RULES]
    assert {c: t for c, t in got.items() if c != "FED005"} == \
        {c: t for c, t in want.items() if c != "FED005"}
    assert got["FED005"] == \
        "kernel build or torch.compile without a compile cache"


@pytest.mark.parametrize("line", [
    "x = 1  " + waive("FED001,FED002", "two codes"),
    "x = 1  # fed" + "lint: disable=FED001",
    "x = 1  " + waive("BOGUS", "oops"),
    "x = 1  # fed" + "lint: disable= -- why",
    "x = 1  # fed" + "lint:disable=FED007--tight",
    "x = 1",
])
def test_waiver_parser_is_the_reference_parser(line):
    got, want = parse_waivers([line]), ref_waivers.parse_waivers([line])
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k].codes, got[k].reason, got[k].problems,
                got[k].valid) == (want[k].codes, want[k].reason,
                                  want[k].problems, want[k].valid)
    assert waivers.META_RULE == ref_waivers.META_RULE


def test_unused_waiver_is_meta_finding(tmp_path):
    fs = lint(tmp_path, "x = 1  " + waive("FED006", "nothing here") + "\n",
              "src/repro_torch/core/fx.py")
    assert any("unused waiver" in f.message for f in only(fs, META_RULE))


def test_unused_waiver_silent_when_rule_not_active(tmp_path):
    fs = lint(tmp_path, "x = 1  " + waive("FED006", "nothing here") + "\n",
              "src/repro_torch/core/fx.py", select={"FED007"})
    assert not only(fs, META_RULE)


def test_syntax_error_is_meta_finding(tmp_path):
    fs = lint(tmp_path, "def broken(:\n", "src/repro_torch/core/fx.py")
    assert only(fs, META_RULE)
    assert "syntax error" in fs[0].message


def test_driver_helpers_are_the_reference_helpers(tmp_path):
    import ast
    src = "a.b.c(x)\nfor i in y:\n    def f():\n        g(i)\n"
    tree = ast.parse(src)
    call = tree.body[0].value
    assert core.dotted(call.func) == ref_core.dotted(call.func) == "a.b.c"
    assert len(list(core.iter_scopes(tree))) == \
        len(list(ref_core.iter_scopes(tree)))
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "x.py").write_text("x = 1\n")
    (tmp_path / "d" / "y.txt").write_text("no\n")
    assert core.discover([str(tmp_path / "d")]) == \
        ref_core.discover([str(tmp_path / "d")])


# ---------------------------------------------------------------------------
# FED001 — views of the store's buffers across an in-place row write
# ---------------------------------------------------------------------------

FED001_POS = """
    def flush(store, ids, rows):
        buf = store.buffer
        store.merge_scatter(ids, rows)
        return buf.sum()
"""


@pytest.mark.parametrize("bind", [
    "store.buffer", "store.int_buffer", "store.buffer[ids]",
    "store.buffer[:, 4:9]", "store.buffer.view(-1)",
    "store.buffer[0].reshape(3, -1)", "store.buffer.narrow(1, 0, 8)",
    "store.buffer.float()", "store.buffer.T"])
def test_fed001_view_used_after_scatter(tmp_path, bind):
    src = FED001_POS.replace("store.buffer", bind)
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    assert len(unwaived(fs, "FED001")) == 1
    assert "donation contract" in fs[0].message


@pytest.mark.parametrize("write", ["scatter", "write_rows",
                                   "scatter_params"])
def test_fed001_every_row_write_counts(tmp_path, write):
    src = FED001_POS.replace("merge_scatter", write)
    assert len(unwaived(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                        "FED001")) == 1


@pytest.mark.parametrize("copy", ["store.buffer.clone()",
                                  "store.buffer.index_select(0, ids)",
                                  "store.gather(ids)",
                                  "store.buffer.cpu()"])
def test_fed001_copies_are_safe(tmp_path, copy):
    src = FED001_POS.replace("store.buffer", copy)
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED001")


def test_fed001_use_before_scatter_ok(tmp_path):
    src = """
        def flush(store, ids, rows):
            buf = store.buffer[ids]
            total = buf.sum()
            store.merge_scatter(ids, rows)
            fresh = store.gather(ids)
            return total + fresh.sum()
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED001")


def test_fed001_rebind_clears_held_ref(tmp_path):
    src = """
        def flush(store, ids, rows):
            buf = store.buffer
            buf = rows
            store.merge_scatter(ids, rows)
            return buf.sum()
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED001")


def test_fed001_waived(tmp_path):
    src = FED001_POS.replace("return buf.sum()",
                             "return buf.sum()  "
                             + waive("FED001", "rows outside the write"))
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    assert not unwaived(fs, "FED001")
    assert only(fs, "FED001")[0].waived


# ---------------------------------------------------------------------------
# FED002 — host sync in hot paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync,word", [
    ("x.item()", ".item()"), ("x.cpu()", ".cpu()"),
    ("x.tolist()", ".tolist()"), ("x.numpy()", ".numpy()"),
    ("torch.cuda.synchronize()", "synchronize"),
    ("float(torch.sum(x))", "float()"), ("int(x.sum())", "int()"),
    ("bool((x > 0).any())", "bool()"), ("np.asarray(x)", "np.asarray")])
def test_fed002_sync_in_hot_module(tmp_path, sync, word):
    src = f"""
        import numpy as np
        import torch

        def poll(x):
            return {sync}
    """
    fs = lint(tmp_path, src, "src/repro_torch/core/engine.py")
    assert len(unwaived(fs, "FED002")) == 1
    assert word in fs[0].message


@pytest.mark.parametrize("rel", ["src/repro_torch/core/state.py",
                                 "src/repro_torch/core/residency.py",
                                 "src/repro_torch/runtime/async_loop.py"])
def test_fed002_applies_to_every_hot_module(tmp_path, rel):
    src = """
        def poll(x):
            return x.cpu()
    """
    assert len(unwaived(lint(tmp_path, src, rel), "FED002")) == 1


def test_fed002_not_applied_outside_hot_paths(tmp_path):
    src = """
        def poll(x):
            return x.item()
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/fl/network.py"),
                    "FED002")


@pytest.mark.parametrize("host", [
    "np.asarray([x for x in xs])", "int(len(xs))", "float(np.sum(xs))",
    "int(math.ceil(len(xs) / 2))", "np.random.default_rng(0).normal()",
    "xs.shape[0]"])
def test_fed002_host_values_exempt(tmp_path, host):
    src = f"""
        import math
        import numpy as np

        def pack(xs):
            return {host}
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/core/engine.py"),
                    "FED002")


@pytest.mark.parametrize("rel,scope", [
    ("src/repro_torch/core/residency.py", "class DiskColdTier"),
    ("src/repro_torch/core/residency.py", "class HostColdTier"),
    ("src/repro_torch/core/state.py", "class Store"),
])
def test_fed002_allowlisted_blocking_points(tmp_path, rel, scope):
    src = f"""
        {scope}:
            def _numpy(self, x):
                return x.detach().cpu().numpy()
    """
    fs = lint(tmp_path, src, rel)
    if "Store" in scope:          # not a blocking point: flagged
        assert len(unwaived(fs, "FED002")) == 2
    else:
        assert not only(fs, "FED002")


def test_fed002_allowlisted_functions(tmp_path):
    src = """
        def _ids(self, ids):
            return ids.tolist()

        def _ef_block(self, ids):
            return self.ef[ids].cpu()
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/core/state.py"),
                    "FED002")


# ---------------------------------------------------------------------------
# FED003 — FMA-contraction hazard
# ---------------------------------------------------------------------------

FED003_FUSED_MERGE = """
    def merge(acc, corr, upd, w):
        return acc * corr + upd * w
"""


@pytest.mark.parametrize("rel", ["src/repro_torch/kernels/fedagg.py",
                                 "src/repro_torch/kernels/ops.py"])
def test_fed003_fused_merge_regression(tmp_path, rel):
    fs = lint(tmp_path, FED003_FUSED_MERGE, rel)
    assert len(unwaived(fs, "FED003")) == 1
    assert "FMA" in fs[0].message


def test_fed003_int8_residual_shape_flagged(tmp_path):
    # the int8 path's residual: x - (q + snap) * scale contracts into an
    # FMA where the numpy oracle rounds the product first
    src = """
        def residual(x, q, snap, scale):
            return x - (q + snap) * scale
    """
    fs = lint(tmp_path, src, "src/repro_torch/kernels/ops.py")
    assert len(unwaived(fs, "FED003")) == 1


def test_fed003_add_feeding_mul_ok(tmp_path):
    src = """
        def dequant(q, snap, scale):
            return (q + snap) * scale
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/kernels/ops.py"),
                    "FED003")


def test_fed003_not_applied_outside_kernels_and_state(tmp_path):
    assert not only(lint(tmp_path, FED003_FUSED_MERGE,
                         "src/repro_torch/fl/network.py"), "FED003")


def test_fed003_state_host_int_arithmetic_exempt(tmp_path):
    src = """
        def nbytes(n, d):
            return n * d + 16
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/core/state.py"),
                    "FED003")


def test_fed003_state_tensor_context_flagged(tmp_path):
    src = """
        import torch

        def blend(a, b, t):
            y = a * t + b
            return torch.tanh(y)
    """
    fs = lint(tmp_path, src, "src/repro_torch/core/state.py")
    assert len(unwaived(fs, "FED003")) == 1


def test_fed003_tuple_repetition_exempt(tmp_path):
    src = """
        def shape(n):
            return (1,) * n + (2,)
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/kernels/fx.py"),
                    "FED003")


def test_fed003_waived(tmp_path):
    src = FED003_FUSED_MERGE.replace(
        "return acc * corr + upd * w",
        "return acc * corr + upd * w  "
        + waive("FED003", "tolerance-gated"))
    fs = lint(tmp_path, src, "src/repro_torch/kernels/fused.py")
    assert not unwaived(fs, "FED003")
    assert only(fs, "FED003")[0].reason == "tolerance-gated"


# ---------------------------------------------------------------------------
# FED004 — telemetry overhead + the port's catalogue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call,word", [
    ('tel.inc(f"count_{n}", 1)', "f-string"),
    ('tel.span("phase_%d" % n)', "%-formatting"),
    ('tel.span("phase_{}".format(n))', ".format()"),
    ('tel.gauge("queue.depth", depth_of(n))', "call-bearing")])
def test_fed004_eager_arguments(tmp_path, call, word):
    src = f"""
        def f(tel, n):
            {call}
    """
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    assert any(word in f.message for f in unwaived(fs, "FED004"))


def test_fed004_enabled_guard_allows_heavy_args(tmp_path):
    src = '''
        def f(tel, n):
            if tel.enabled:
                tel.inc(f"count_{n}", 1)
    '''
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED004")


def test_fed004_early_return_guard(tmp_path):
    src = '''
        def f(tel, n):
            if not tel.enabled:
                return
            tel.span(f"phase_{n}")
    '''
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED004")


def test_fed004_cheap_calls_allowed(tmp_path):
    src = '''
        def f(tel, q):
            tel.gauge("queue.depth", len(q))
    '''
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED004")


def test_fed004_names_come_from_the_port_catalogue(tmp_path):
    src = '''
        def f(tel):
            tel.inc("fl.bogus.counter", 1)
            tel.inc("residency.demand_hit", 1)
            tel.inc("telemetry.dropped_spans", 3)
            with tel.span("round.train"):
                pass
    '''
    fs = unwaived(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                  "FED004")
    assert len(fs) == 1
    assert "repro_torch.obs.catalogue" in fs[0].message


def test_fed004_catalogue_check_skipped_outside_the_port(tmp_path):
    src = '''
        def f(tel):
            tel.inc("synthetic", 1)
    '''
    assert not only(lint(tmp_path, src, "tests/test_torch_fx.py"), "FED004")


def test_fed004_handle_assigned_from_tel(tmp_path):
    src = '''
        from repro_torch.obs import telemetry as obs

        def f(n):
            t = obs.TEL
            t.inc(f"x_{n}", 1)
    '''
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    assert len(unwaived(fs, "FED004")) == 1


# ---------------------------------------------------------------------------
# FED005 — kernel builds and torch.compile without a cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", [
    "torch.compile(fn)", "torch.utils.cpp_extension.load('k', ['k.cu'])",
    "cpp_extension.load_inline('k', cpp_sources=src)"])
def test_fed005_build_in_per_call_body(tmp_path, build):
    src = f"""
        import torch
        from torch.utils import cpp_extension

        def step(fn, x, src=None):
            f = {build}
            return f(x)
    """
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    assert len(unwaived(fs, "FED005")) == 1
    assert "step" in fs[0].message


def test_fed005_build_load_is_its_own_cache_but_not_in_a_loop(tmp_path):
    src = """
        from repro_torch.kernels import _build

        def _lib():
            return _build.load("fedagg")

        def every():
            return [_build.load(n) for n in ("fedagg", "ssm_scan")]

        def each():
            for n in ("fedagg", "ssm_scan"):
                _build.load(n)
    """
    fs = unwaived(lint(tmp_path, src, "src/repro_torch/kernels/fx.py"),
                  "FED005")
    assert len(fs) == 1 and "loop" in fs[0].message


def test_fed005_lru_cache_is_cache_evidence(tmp_path):
    src = """
        import functools
        import torch

        @functools.lru_cache(maxsize=None)
        def build(n):
            return torch.compile(make(n))
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED005")


def test_fed005_init_dict_cache_and_module_scope_ok(tmp_path):
    src = """
        import torch

        STEP = torch.compile(make())

        class Store:
            def __init__(self):
                self._prog = torch.compile(make())

            def get(self, key):
                if key not in self._progs:
                    self._progs[key] = torch.compile(make(key))
                return self._progs[key]
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED005")


def test_fed005_module_level_loop_flagged(tmp_path):
    src = """
        import torch

        for n in (1, 2, 4):
            PROGS.append(torch.compile(make(n)))
    """
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    assert len(unwaived(fs, "FED005")) == 1
    assert "loop" in fs[0].message


def test_fed005_builtin_compile_and_launch_not_flagged(tmp_path):
    src = """
        import torch

        def step(fn, x):
            code = compile("x + 1", "<s>", "eval")
            return torch.compile(fn)(x)
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/launch/fx.py"),
                    "FED005")
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    assert [f.message.split("(")[0] for f in unwaived(fs, "FED005")] == \
        ["torch.compile"]


# ---------------------------------------------------------------------------
# FED006 — nondeterminism sources, torch's global RNG among them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    "hash(name) % 1000", "np.random.normal()", "random.random()",
    "torch.manual_seed(0)", "torch.randn(3)", "torch.rand(2, 2)",
    "torch.randint(0, 9, (4,))", "torch.randperm(8)",
    "torch.normal(0.0, 1.0, (3,))", "torch.bernoulli(p)",
    "torch.multinomial(p, 2)", "w.normal_(0.0, 1.0)", "w.uniform_(-1, 1)"])
def test_fed006_sources_flagged(tmp_path, call):
    src = f"""
        import random
        import numpy as np
        import torch

        def draw(name, p, w):
            return {call}
    """
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    assert len(unwaived(fs, "FED006")) == 1


@pytest.mark.parametrize("call", [
    "zlib.crc32(name.encode())", "np.random.default_rng(0).normal()",
    "torch.randn(3, generator=gen)", "torch.randperm(8, generator=gen)",
    "w.normal_(0.0, 1.0, generator=gen)",
    "torch.Generator().manual_seed(0)"])
def test_fed006_explicit_streams_ok(tmp_path, call):
    src = f"""
        import zlib
        import numpy as np
        import torch

        def draw(name, gen, w):
            return {call}
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED006")


@pytest.mark.parametrize("rel,flagged", [
    ("src/repro_torch/core/fx.py", True),
    ("src/repro_torch/launch/fx.py", False), ("tests/test_torch_x.py", False),
    ("tools/k4_variants.py", False), ("chip_smoke.py", False)])
def test_fed006_time_time_scoping(tmp_path, rel, flagged):
    src = """
        import time

        def stamp():
            return time.time()
    """
    assert bool(only(lint(tmp_path, src, rel), "FED006")) == flagged


def test_fed006_waived(tmp_path):
    src = """
        import torch

        def draw():
            return torch.randn(3)  """ + waive("FED006", "test-only noise")
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    assert not unwaived(fs, "FED006")
    assert only(fs, "FED006")[0].waived


# ---------------------------------------------------------------------------
# FED007 — bare/broad exception handlers (the reference's rule)
# ---------------------------------------------------------------------------

def test_fed007_broad_and_bare_as_the_reference(tmp_path):
    src = """
        def f():
            try:
                g()
            except Exception:
                pass
            try:
                g()
            except:
                pass
            try:
                g()
            except (ValueError, BaseException):
                pass
    """
    fs = lint(tmp_path, src, "src/repro_torch/core/fx.py")
    p = tmp_path / "fx.py"
    want = ref_core.lint_file(str(p), "src/repro/core/fx.py",
                              [r for r in ref_rules.RULES
                               if r.code == "FED007"])
    assert [(f.line, f.message) for f in only(fs, "FED007")] == \
        [(f.line, f.message) for f in want]
    assert len(want) == 3


def test_fed007_narrow_handler_ok(tmp_path):
    src = """
        def f():
            try:
                g()
            except (ValueError, KeyError):
                pass
    """
    assert not only(lint(tmp_path, src, "src/repro_torch/core/fx.py"),
                    "FED007")


# ---------------------------------------------------------------------------
# CLI: exit codes, --select, --json schema, as the reference's
# ---------------------------------------------------------------------------

def _both(argv, capsys):
    rc = fedlint_main(list(argv))
    out = capsys.readouterr()
    ref_rc = ref_fedlint.main(list(argv))
    ref_out = capsys.readouterr()
    return rc, out, ref_rc, ref_out


@pytest.mark.parametrize("case", ["clean", "dirty", "select", "unknown",
                                  "missing"])
def test_cli_exit_codes_are_the_reference_codes(tmp_path, capsys, case):
    p = tmp_path / "x.py"
    p.write_text("x = 1\n" if case == "clean"
                 else "def f(name):\n    return hash(name)\n")
    argv = {"clean": [str(p)], "dirty": [str(p)],
            "select": [str(p), "--select", "FED007"],
            "unknown": [str(p), "--select", "NOPE"],
            "missing": [str(tmp_path / "nope")]}[case]
    rc, out, ref_rc, ref_out = _both(argv, capsys)
    assert rc == ref_rc == {"clean": 0, "dirty": 1, "select": 0,
                            "unknown": 2, "missing": 2}[case]
    if case == "unknown":
        assert "unknown rule code" in out.err
    if case == "dirty":
        assert "FED006" in out.out


def test_cli_list_rules(capsys):
    assert fedlint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in sorted(ALL_CODES):
        assert code in out


def test_cli_json_report_schema_is_the_reference_schema(tmp_path, capsys):
    p = tmp_path / "dirty.py"
    p.write_text("import torch\n\ndef f(name):\n    torch.manual_seed(0)\n"
                 "    return hash(name)\n")
    out, ref_out = tmp_path / "report.json", tmp_path / "ref.json"
    rc = fedlint_main([str(p), "--json", str(out)])
    ref_rc = ref_fedlint.main([str(p), "--json", str(ref_out)])
    capsys.readouterr()
    assert rc == ref_rc == 1
    doc, ref = json.loads(out.read_text()), json.loads(ref_out.read_text())
    assert set(doc) == set(ref)
    assert doc["fedlint"] == ref["fedlint"] == 1
    assert doc["meta_rule"] == META_RULE
    assert set(doc["rules"]) == ALL_CODES == set(ref["rules"])
    assert doc["paths"] == [str(p)]
    s = doc["summary"]
    assert set(s) == set(ref["summary"]) == {"files", "total", "waived",
                                             "unwaived", "by_rule"}
    assert s["files"] == 1
    assert s["total"] == s["waived"] + s["unwaived"]
    assert s["by_rule"] == {"FED006": 2}      # the reference sees the hash
    assert ref["summary"]["by_rule"] == {"FED006": 1}
    for f in doc["findings"]:
        assert set(f) == set(ref["findings"][0])
    assert sum(s["by_rule"].values()) == s["total"]


# ---------------------------------------------------------------------------
# self-check: the port lints clean under its rules (the CI gate)
# ---------------------------------------------------------------------------

def test_fedlint_self_check(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    paths = (["src/repro_torch"]
             + sorted(str(p.relative_to(ROOT))
                      for p in ROOT.glob("tests/test_torch_*.py"))
             + ["chip_smoke.py", "tools"])
    rc = fedlint_main(paths)
    out = capsys.readouterr().out
    assert rc == 0, "fedlint found unwaived findings:\n" + out
    # every waiver gives its reason (a waiver without one is FED000)
    assert "FED000" not in out
    assert "0 unwaived" in out
