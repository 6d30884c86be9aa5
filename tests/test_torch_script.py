"""The port's scripting module (``elasticsearch_tpu_torch/script``) against
the JAX package's (``elasticsearch_tpu/script``).

- The language: every source of ``tests/test_painless.py``'s
  ``TestLanguage``, ``TestDispatch`` and ``TestUpdateScriptHelper`` runs
  through both interpreters; the results, or the raised type and
  message, are equal.
- The expression engine: ``execute_columns`` over seeded float64 columns
  (numpy for the JAX engine, torch tensors for the port's) gives the same
  values bit for bit, with the same dtype: the float32 trap of a
  comparison times a float, every function on scalars and columns, ``%``,
  ``round`` at halves, each division-by-zero form, absent fields, bool
  arithmetic (the invalid forms raise ``ParsingException`` in both), the
  fallback to painless for non-numeric params, and the rejection of
  ``__import__``. ``execute`` (one doc) likewise.
- The segment bindings: ``segment_columns``, ``doc_values_for`` and
  ``segment_doc_resolver`` over the same documents indexed in both
  packages; the port's columns are cached on the segment's device.
- The errors: ``ScriptException`` and ``DocumentMissingException`` render
  the JAX package's ``error.type`` and status.
"""

import copy

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import (
    DocumentMissingException as JDocumentMissing,
)
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.index_service import IndexService as JIndex
from elasticsearch_tpu.script import expression as jexpr
from elasticsearch_tpu.script import painless as jpl
from elasticsearch_tpu_torch.common.errors import (
    DocumentMissingException,
    ParsingException,
    ScriptException,
)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import IndexService
from elasticsearch_tpu_torch.script import expression as texpr
from elasticsearch_tpu_torch.script import painless as tpl


def outcome(fn):
    """("ok", value) or ("raise", type name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("raise", type(e).__name__, str(e))


# --- the language ----------------------------------------------------------

CONTROL_FLOW = """
int total = 0;
for (int i = 0; i < 10; i++) {
  if (i % 2 == 0) { continue }
  if (i > 7) { break }
  total += i;
}
return total;
"""
FOREACH = """
def m = ['a': 1, 'b': 2];
def keys = '';
for (def k : m) { keys += k }
def total = 0;
for (def v : m.values()) { total += v }
return keys + total;
"""
COLLECTIONS = """
List l = new ArrayList();
l.add(3); l.add(1); l.add(2);
l.sort();
Map m = new HashMap();
m.put('first', l.get(0));
m.put('n', l.size());
return m['first'] + m.getOrDefault('n', 0) + l.indexOf(2);
"""
STRINGS = """
String s = ' Hello,World ';
def t = s.trim();
def parts = t.split(',');
return parts[0].toLowerCase() + '|' + parts[1].substring(0, 3)
       + '|' + t.length();
"""

# (source, bindings) run through PainlessScript.run in both packages
RUN_CASES = [
    ("return 7 / 2", {}), ("return 7.0 / 2", {}), ("return -7 / 2", {}),
    ("return -7 % 3", {}), ("return 2 + 3 * 4", {}),
    ("return (int) 3.9", {}), ("return 'a' + 1 + 2", {}),
    (CONTROL_FLOW, {}),
    ("int n = 0; while (n < 5) { n++ } return n > 4 ? 'big' : 'small'", {}),
    (FOREACH, {}), (COLLECTIONS, {}), (STRINGS, {}),
    ("return Math.max(2, Math.abs(-5))", {}),
    ("return Math.floor(Math.PI)", {}),
    ("return Integer.parseInt('42') + 1", {}),
    ("return String.valueOf(1.5)", {}),
    ("def x = null; return x ?: 'd'", {}),
    ("def x = null; return x?.length()", {}),
    ("def x = null; return x.length()", {}),
    ("def x = 'a'; return x instanceof String", {}),
    ("def x = [1]; return x instanceof Map", {}),
    ("while (true) { }", {}),
    ("for (int i = 0; i >= 0; i) { def x = 1 }", {}),
    ("return ''.__class__", {"params": {}}),
    ("def x = [1]; return x.__len__()", {"params": {}}),
    ("return params.size.__globals__", {"params": {}}),
    ("return params.__globals__", {"params": {}}),
    ("ctx._source.n += params.by; ctx._source.tags = ['updated']",
     {"ctx": {"_source": {"n": 3}}, "params": {"by": 10}}),
]


@pytest.mark.parametrize("src,bindings", RUN_CASES,
                         ids=[f"run{i}" for i in range(len(RUN_CASES))])
def test_language_runs_like_jax(src, bindings):
    jb, tb = copy.deepcopy(bindings), copy.deepcopy(bindings)
    want = outcome(lambda: jpl.PainlessScript(src).run(jb))
    got = outcome(lambda: tpl.PainlessScript(src).run(tb))
    assert got == want
    assert tb == jb  # the bindings' mutations (ctx._source) too


@pytest.mark.parametrize("src", ["def x = ", "return 'unterminated", "x +++"])
def test_compile_errors_like_jax(src):
    want = outcome(lambda: jpl.PainlessScript(src))
    got = outcome(lambda: tpl.PainlessScript(src))
    assert want[0] == got[0] == "raise"
    assert got[1:] == want[1:] == ("ScriptException", want[2])


@pytest.mark.parametrize("values", [{"p": 4.0}, {}])
@pytest.mark.parametrize("src", [
    "if (doc['p'].size() == 0) { return -1 } return doc['p'].value",
    "return doc['p'].value",
])
def test_doc_values_semantics_like_jax(src, values):
    want = outcome(lambda: jpl.PainlessScript(src).execute(dict(values)))
    got = outcome(lambda: tpl.PainlessScript(src).execute(dict(values)))
    assert got == want


@pytest.mark.parametrize("spec", [
    "doc['a'].value * 2",
    {"source": "def x = 1; return x"},
    {"lang": "expression", "source": "def x = 1; return x"},
    {"lang": "expression", "source": "doc['a'].value + params.b"},
    {"lang": "mustache", "source": "1"},
    {"params": {}},
    {"source": 5},
    {"inline": "_score * 2"},
])
def test_dispatch_like_jax(spec):
    want = outcome(lambda: type(jexpr.compile_script(spec)).__name__)
    got = outcome(lambda: type(texpr.compile_script(spec)).__name__)
    assert got == want


def test_compiled_scripts_are_shared():
    a = texpr.compile_script("doc['a'].value * 3")
    assert texpr.compile_script({"source": "doc['a'].value * 3"}) is a
    assert texpr.CUSTOM_SCRIPT_ENGINES == {}


@pytest.mark.parametrize("src,op", [("ctx.op = 'explode'", None),
                                    ("ctx.op = 'noop'", "none"),
                                    ("ctx.op = 'delete'", "delete"),
                                    ("ctx._source.a += 1", "index")])
def test_update_script_helper_like_jax(src, op):
    want = outcome(lambda: jpl.execute_update_script(
        jpl.PainlessScript(src), {"a": 1}))
    got = outcome(lambda: tpl.execute_update_script(
        tpl.PainlessScript(src), {"a": 1}))
    assert got == want
    if op is not None:
        assert got == ("ok", ({"a": 2 if op == "index" else 1}, op))


def test_errors_render_like_jax():
    jd = JDocumentMissing("i", "7").to_dict()
    td = DocumentMissingException("i", "7").to_dict()
    assert td == jd and td["status"] == 404
    js = jpl.ScriptException("boom").to_dict()
    ts = ScriptException("boom").to_dict()
    assert ts == js == {"error": {"type": "script_exception",
                                  "reason": "boom"}, "status": 400}
    assert issubclass(ScriptException, ParsingException)


# --- the expression engine -------------------------------------------------

ND = 4096


def seeded_columns(seed=17):
    """x: reals with halves (round's ties) and exact zeros; y: small
    integers with zeros (the divisors); z: present on some docs only."""
    rng = np.random.RandomState(seed)
    x = rng.randn(ND) * 20.0
    x[::7] = np.round(x[::7]) + 0.5
    x[::11] = 0.0
    y = rng.randint(-3, 5, ND).astype(np.float64)
    zlen = (rng.rand(ND) < 0.6).astype(np.float64)
    z = np.where(zlen > 0, rng.rand(ND) * 100.0, 0.0)
    return {"x": x, "x#len": np.ones(ND), "y": y,
            "y#len": np.ones(ND), "z": z, "z#len": zlen}


COLUMN_CASES = [
    # the float32 trap: a comparison times a float, and divided
    "(doc['x'].value > 3) * 0.1 + doc['y'].value",
    "(doc['x'].value > 3) / 3 + doc['x'].value",
    "0.3 * (doc['z'].length > 0) - 0.1",
    # every function on columns
    "abs(doc['x'].value)", "sqrt(abs(doc['x'].value))",
    "log(abs(doc['x'].value) + 1)", "log10(doc['z'].value + 1)",
    "exp(doc['x'].value / 10)", "min(doc['x'].value, doc['y'].value)",
    "max(doc['x'].value, 3)", "pow(doc['x'].value, 2)",
    "pow(abs(doc['x'].value), 1.7)", "pow(2, doc['y'].value)",
    "pow(abs(doc['x'].value), doc['y'].value)", "floor(doc['x'].value)",
    "ceil(doc['x'].value)", "round(doc['x'].value)",
    "round(doc['x'].value * 0.5)", "sin(doc['x'].value)",
    "cos(doc['x'].value)", "sqrt(doc['x'].value)",
    # every function on scalars, beside a column and alone
    "sqrt(params.a) + doc['x'].value", "pow(params.a, 2) * doc['y'].value",
    "min(params.a, 3) + max(2, params.a)", "round(2.5) + round(3.5)",
    "abs(-params.a) + floor(2.7) + ceil(2.2) + log(8) + log10(100)",
    "exp(1) + sin(1) + cos(1)",
    # %
    "doc['x'].value % doc['y'].value", "doc['x'].value % -2.5",
    "-7.5 % doc['y'].value", "params.a % 3",
    # division by zero, over columns and between scalars
    "doc['x'].value / doc['y'].value", "1 / doc['absent'].value > 0",
    "doc['absent'].value / doc['absent'].value", "doc['x'].value / 0",
    "params.a / 0", "params.a % 0", "1 / (params.a - 2)",
    # absent fields and lengths
    "doc['absent'].value + doc['absent'].length",
    "doc['z'].length * doc['z'].value",
    # bool arithmetic
    "(doc['x'].value > 1) - (doc['y'].value > 1)",
    "-(doc['x'].value > 1)",
    "(doc['x'].value > 1) + (doc['y'].value > 1)",
    "(doc['x'].value > 1) * (doc['y'].value > 1)",
    "(doc['x'].value > 1) / (doc['y'].value > 1)",
    "(doc['x'].value > 1) == (doc['y'].value > 1)",
    "abs(doc['x'].value > 0)",
    "min(doc['x'].value > 0, doc['y'].value > 0)",
    # comparisons and constants
    "doc['x'].value >= params.a", "doc['y'].value != 0", "3 + 4", "2 > 1",
    "_score * 2 + doc['x'].value",
    # ambiguous truth of a column (a chained comparison)
    "0 < doc['x'].value < 5",
    # the grammar check before eval
    "__import__('os').system('id')", "doc['x'].value.__class__",
]


def _same_value(want, got):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        assert isinstance(want, np.ndarray) and isinstance(got, np.ndarray)
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        assert np.array_equal(got, want, equal_nan=True)
    else:
        assert type(got) is type(want) and (
            got == want or (got != got and want != want)), (got, want)


@pytest.mark.parametrize("src", COLUMN_CASES)
def test_execute_columns_like_jax(src):
    cols = seeded_columns()
    scores = np.random.RandomState(3).rand(ND).astype(np.float32)
    tcols = {k: torch.from_numpy(v.copy()) for k, v in cols.items()}
    params = {"a": 2.0}
    want = outcome(lambda: jexpr.CompiledScript(src).execute_columns(
        cols, params, scores))
    got = outcome(lambda: texpr.CompiledScript(src).execute_columns(
        tcols, params, torch.from_numpy(scores.copy())))
    assert got[0] == want[0], (got, want)
    if want[0] == "raise":
        assert got[1] == want[1] == "ParsingException"
        return
    _same_value(want[1], got[1])


@pytest.mark.parametrize("fn", ["exp", "sin", "cos", "sqrt", "log10"])
def test_a_function_of_a_comparison_stays_float64(fn):
    """numpy computes a function of a bool column in float16, so the JAX
    engine's ``exp(a > b)`` is 2.719 where it is 2.718281828459045 in
    float64; the port computes in float64 (C17)."""
    cols = seeded_columns()
    tcols = {k: torch.from_numpy(v.copy()) for k, v in cols.items()}
    src = f"{fn}(doc['x'].value > 0)"
    want = jexpr.CompiledScript(src).execute_columns(cols)
    got = texpr.CompiledScript(src).execute_columns(tcols).numpy()
    assert want.dtype == np.float16 and got.dtype == np.float64
    with np.errstate(divide="ignore"):
        f = getattr(np, fn)
        assert np.array_equal(got, f((cols["x"] > 0).astype(np.float64)))
    assert np.array_equal(got.astype(np.float16), want)


@pytest.mark.parametrize("src,params", [
    ("params.n + doc['y'].value", {"n": "a"}),
    ("doc['y'].length + params.k", {"k": [1]}),
    ("doc['x'].value > params.t", {"t": "5"}),
    ("doc['x'].value > params.t", {"t": 5, "unused": "text"}),
])
def test_non_numeric_params_fall_back_like_jax(src, params):
    cols = seeded_columns()
    tcols = {k: torch.from_numpy(v.copy()) for k, v in cols.items()}
    want = outcome(lambda: jexpr.CompiledScript(src).execute_columns(
        cols, params))
    got = outcome(lambda: texpr.CompiledScript(src).execute_columns(
        tcols, params))
    assert got[0] == want[0], (got, want)
    if want[0] == "ok":
        _same_value(want[1], got[1])
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("src", [
    "doc['x'].value * 2 + params.a", "doc['x'].value / doc['y'].value",
    "doc['missing'].value + 1", "sqrt(doc['x'].value) + _score",
    "params.a / 0", "pow(doc['x'].length, 3)", "params.label",
])
def test_execute_one_doc_like_jax(src):
    values = {"x": 6.25, "x#len": 1.0, "y": 0.0, "y#len": 1.0}
    params = {"a": 1.5, "label": "t"}
    want = outcome(lambda: jexpr.CompiledScript(src).execute(
        dict(values), params, 0.75))
    got = outcome(lambda: texpr.CompiledScript(src).execute(
        dict(values), params, 0.75))
    assert got == want


def test_painless_execute_columns_moves_tensors_once():
    src = ("if (doc['z'].size() == 0) { return -1 } "
           "return doc['z'].value > params.t ? 1 : 0")
    cols = seeded_columns()
    tcols = {k: torch.from_numpy(v.copy()) for k, v in cols.items()}
    want = jpl.PainlessScript(src).execute_columns(cols, {"t": 50})
    got = tpl.PainlessScript(src).execute_columns(tcols, {"t": 50})
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)


# --- the segment bindings --------------------------------------------------

MAPPING = {"properties": {"n": {"type": "long"}, "price": {"type": "double"},
                          "tag": {"type": "keyword"}, "title": {"type": "text"},
                          "multi": {"type": "long"}}}


@pytest.fixture(scope="module")
def segments():
    j = JIndex("sc", JSettings({"index.number_of_shards": 1,
                                "index.refresh_interval": -1}),
               mapping=MAPPING)
    t = IndexService("sc", Settings({"index.number_of_shards": 1,
                                     "index.refresh_interval": -1}),
                     mapping=MAPPING, device="cpu")
    rng = np.random.RandomState(5)
    for d in range(60):
        src = {"title": f"w{d % 5}", "tag": f"t{d % 4}"}
        if d % 3:
            src["n"] = int(rng.randint(0, 100))
        if d % 4:
            src["price"] = float(rng.rand() * 10)
        if d % 5 == 0:
            src["multi"] = [d, d + 1, d + 2]
        j.index_doc(str(d), src)
        t.index_doc(str(d), src)
    j.refresh()
    t.refresh()
    yield j.shards[0].engine.segments[0], t.shards[0].engine.segments[0]
    j.close()
    t.close()


FIELDS = ["n", "price", "tag", "multi", "absent", "title"]


def test_segment_columns_like_jax(segments):
    jseg, tseg = segments
    want = jexpr.segment_columns(jseg, FIELDS)
    got = texpr.segment_columns(tseg, FIELDS)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float64 and got[k].device == tseg.device
        assert np.array_equal(got[k].numpy(), v), k
    # staged once: a second binding is the cached tensor
    again = texpr.segment_columns(tseg, ["n"])
    assert again["n"] is got["n"] and "script:n#len" in tseg.dev_cache


def test_doc_values_and_resolver_like_jax(segments):
    jseg, tseg = segments
    for d in range(jseg.num_docs):
        assert (texpr.doc_values_for(tseg, d, FIELDS)
                == jexpr.doc_values_for(jseg, d, FIELDS))
        jr, tr = jpl.segment_doc_resolver(jseg, d), \
            tpl.segment_doc_resolver(tseg, d)
        for f in FIELDS:
            assert tr(f) == jr(f), (d, f)
