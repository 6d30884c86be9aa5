"""A safe numeric expression engine: the scripting surface's fast path.

Counterpart of ``elasticsearch_tpu/script/expression.py``. Role model:
``modules/lang-expression`` (numeric-only scripts) and the numeric subset
of Painless. Scripts reference doc values via ``doc['f'].value`` (and
``doc['f'].length``) and parameters via ``params.name``; the expression
compiles to Python arithmetic over resolved numbers (``execute``, one doc)
or to tensor arithmetic over whole-segment columns (``execute_columns``).

Deliberately not an eval of user Python: the grammar is digits,
``+ - * / %``, parentheses, comparison operators and the whitelisted
function names below; anything else is rejected before ``eval``, which
runs with empty ``__builtins__``.

``execute_columns`` binds each column to a float64 tensor on the
segment's device (``segment_columns``: staged once a segment through
``Segment.device_column`` and kept until the segment is evicted) and
evaluates there, with numpy's dtype rules rather than torch's, so every
value equals the JAX engine's:

- a column is wrapped in ``_Column``, whose operators cast a bool operand
  (a comparison's result) to float64 before it meets a number: torch
  would take float32, the default dtype, where numpy takes float64;
- bool with bool keeps numpy's answers: ``+`` and ``*`` stay bool, ``-``
  and unary ``-`` raise (and end in a ``ParsingException``, as in the
  JAX engine), ``/`` is float64;
- the functions take scalars and columns alike: on scalars they are
  numpy's, as in the JAX engine; on a column on the card they are
  torch's kernels, and on a column on the host numpy's ufunc on the
  tensor's own memory (torch's vectorized ``sqrt``, ``pow``, ``sin``
  and ``cos`` on the CPU are an ulp away from numpy's; the card's are
  within an ulp or two of numpy's as well). A function of a bool column
  computes in float64, where numpy gives float16 (``exp(a > b)``);
- ``%`` takes the divisor's sign and ``round`` rounds half to even in
  both libraries; a division by zero over a column gives inf or nan (a
  nan is no match), between scalars ``ZeroDivisionError`` and ``None``
  (no match).

A source that fits the grammar but whose referenced params are not
numbers runs on the painless interpreter instead (``_painless_fallback``).
"""

from __future__ import annotations

import functools
import math
import operator
import re
from typing import Dict, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import ParsingException

_DOC_VALUE_RE = re.compile(r"doc\[['\"]([^'\"]+)['\"]\]\.value")
_DOC_LEN_RE = re.compile(r"doc\[['\"]([^'\"]+)['\"]\]\.length")
_PARAM_RE = re.compile(r"params\.(\w+)")
_SCORE_RE = re.compile(r"\b_score\b")

_FUNCTIONS = {
    "abs": abs, "sqrt": math.sqrt, "log": math.log, "log10": math.log10,
    "exp": math.exp, "min": min, "max": max, "pow": pow, "floor": math.floor,
    "ceil": math.ceil, "round": round, "sin": math.sin, "cos": math.cos,
}

_ALLOWED = set("0123456789.+-*/()%,<>=! eE")


def _is_bool(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.bool
    return isinstance(x, (bool, np.bool_))


def _f64(x):
    """A bool tensor as float64 (numpy's promotion of bool against a
    number); anything else as it is."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bool:
        return x.to(torch.float64)
    return x


def _raw(x):
    return x.t if isinstance(x, _Column) else x


def _wrap(x):
    return _Column(x) if isinstance(x, torch.Tensor) else x


# the operators that keep two bools bool, as numpy's do
_BOOL_KEEPING = (operator.add, operator.mul, operator.lt, operator.le,
                 operator.gt, operator.ge, operator.eq, operator.ne)


def _binary(op, a, b):
    """``op`` on two operands, at least one a column, with numpy's dtype
    rules (see the module docstring)."""
    a, b = _raw(a), _raw(b)
    if _is_bool(a) and _is_bool(b):
        if op is operator.sub:
            raise TypeError("boolean subtract, the `-` operator, is not "
                            "supported")
        if op in _BOOL_KEEPING:
            return _wrap(op(a, b))
        a = _f64(a) if isinstance(a, torch.Tensor) else float(a)
        b = _f64(b) if isinstance(b, torch.Tensor) else float(b)
    return _wrap(op(_f64(a), _f64(b)))


class _Column:
    """A whole-segment column in an expression: torch's operators with
    numpy's dtype rules (see the module docstring)."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        if t.dtype not in (torch.bool, torch.float64):
            t = t.to(torch.float64)
        self.t = t

    def __add__(self, o):
        return _binary(operator.add, self, o)

    def __radd__(self, o):
        return _binary(operator.add, o, self)

    def __sub__(self, o):
        return _binary(operator.sub, self, o)

    def __rsub__(self, o):
        return _binary(operator.sub, o, self)

    def __mul__(self, o):
        return _binary(operator.mul, self, o)

    def __rmul__(self, o):
        return _binary(operator.mul, o, self)

    def __truediv__(self, o):
        return _binary(operator.truediv, self, o)

    def __rtruediv__(self, o):
        return _binary(operator.truediv, o, self)

    def __floordiv__(self, o):
        return _binary(operator.floordiv, self, o)

    def __rfloordiv__(self, o):
        return _binary(operator.floordiv, o, self)

    def __mod__(self, o):
        return _binary(operator.mod, self, o)

    def __rmod__(self, o):
        return _binary(operator.mod, o, self)

    def __pow__(self, o):
        return _binary(operator.pow, self, o)

    def __rpow__(self, o):
        return _binary(operator.pow, o, self)

    def __lt__(self, o):
        return _binary(operator.lt, self, o)

    def __le__(self, o):
        return _binary(operator.le, self, o)

    def __gt__(self, o):
        return _binary(operator.gt, self, o)

    def __ge__(self, o):
        return _binary(operator.ge, self, o)

    def __eq__(self, o):
        return _binary(operator.eq, self, o)

    def __ne__(self, o):
        return _binary(operator.ne, self, o)

    __hash__ = None

    def __neg__(self):
        if self.t.dtype == torch.bool:
            raise TypeError("boolean negative, the `-` operator, is not "
                            "supported")
        return _Column(-self.t)

    def __pos__(self):
        return self

    def __bool__(self):
        return bool(self.t)


def _column_function(np_fn, torch_fn, keeps_bool=False):
    """``np_fn`` on scalars and host columns, ``torch_fn`` on card
    columns; a bool column computes as float64 (unless ``keeps_bool`` and
    every argument is bool: ``abs``, ``min`` and ``max`` of masks)."""
    def call(*args):
        raw = [_raw(a) for a in args]
        if not any(isinstance(a, torch.Tensor) for a in raw):
            return np_fn(*raw)
        if not (keeps_bool and all(_is_bool(a) for a in raw)):
            raw = [_f64(a) for a in raw]
        t0 = next(a for a in raw if isinstance(a, torch.Tensor))
        if t0.device.type == "cpu":
            return _Column(torch.from_numpy(np.asarray(np_fn(*[
                a.numpy() if isinstance(a, torch.Tensor) else a
                for a in raw]))))
        return _Column(torch_fn(*[
            a if isinstance(a, torch.Tensor)
            else torch.as_tensor(a, dtype=t0.dtype, device=t0.device)
            for a in raw]))
    return call


_COLUMN_FUNCTIONS = {
    "abs": _column_function(np.abs, torch.abs, keeps_bool=True),
    "sqrt": _column_function(np.sqrt, torch.sqrt),
    "log": _column_function(np.log, torch.log),
    "log10": _column_function(np.log10, torch.log10),
    "exp": _column_function(np.exp, torch.exp),
    "min": _column_function(np.minimum, torch.minimum, keeps_bool=True),
    "max": _column_function(np.maximum, torch.maximum, keeps_bool=True),
    "pow": _column_function(np.power, torch.pow),
    "floor": _column_function(np.floor, torch.floor),
    "ceil": _column_function(np.ceil, torch.ceil),
    "round": _column_function(
        np.round, lambda a, n=None: torch.round(
            a, decimals=0 if n is None else int(n))),
    "sin": _column_function(np.sin, torch.sin),
    "cos": _column_function(np.cos, torch.cos),
}


def _check_grammar(source: str, stripped: str) -> None:
    for fn in _FUNCTIONS:
        stripped = stripped.replace(fn, "")
    if not all(c in _ALLOWED for c in stripped):
        raise ParsingException(
            f"unsupported script [{source}]: only numeric expressions "
            f"over doc values/params are allowed"
        )


class CompiledScript:
    def __init__(self, source: str):
        self.source = source
        self.doc_fields = _DOC_VALUE_RE.findall(source) + _DOC_LEN_RE.findall(source)
        self._painless = None  # the fallback for non-numeric params

    def _painless_fallback(self):
        # a source can fit the numeric grammar while its params are
        # strings or lists at run time (e.g. "params.label"): re-dispatch
        # to the full language instead of failing on float()
        if self._painless is None:
            from elasticsearch_tpu_torch.script.painless import PainlessScript

            self._painless = PainlessScript(self.source)
        return self._painless

    def _bind_params(self, expr: str, params: Optional[Dict]):
        """``expr`` with each referenced param's number substituted, or
        None when one of them is not a number."""
        for name, value in sorted((params or {}).items(),
                                  key=lambda kv: -len(kv[0])):
            if f"params.{name}" not in expr:
                continue  # an unreferenced param must not force the fallback
            try:
                sub = repr(float(value))
            except (TypeError, ValueError):
                return None
            expr = expr.replace(f"params.{name}", sub)
        return expr

    def execute(self, doc_values: Dict[str, float],
                params: Optional[Dict] = None, score: float = 0.0):
        """One doc: its values (``doc_values_for``) as scalars."""
        expr = self.source
        expr = _DOC_VALUE_RE.sub(
            lambda m: repr(float(doc_values.get(m.group(1), 0.0))), expr
        )
        expr = _DOC_LEN_RE.sub(
            lambda m: repr(float(doc_values.get(f"{m.group(1)}#len", 0.0))), expr
        )
        expr = _SCORE_RE.sub(repr(float(score)), expr)
        expr = self._bind_params(expr, params)
        if expr is None:
            return self._painless_fallback().execute(doc_values, params, score)
        _check_grammar(self.source, expr)
        try:
            return eval(  # noqa: S307 — grammar-sanitized above
                expr, {"__builtins__": {}}, dict(_FUNCTIONS)
            )
        except ZeroDivisionError:
            return None
        except Exception as e:
            raise ParsingException(
                f"failed to run script [{self.source}]: {e}"
            ) from e

    def execute_columns(self, columns: Dict[str, object],
                        params: Optional[Dict] = None, scores=None):
        """Whole-segment evaluation: doc values bind to columns (tensors,
        or numpy arrays, which are wrapped without a copy) in one pass on
        their device. Returns a tensor (float64, or bool for a
        comparison), a scalar for an expression over no column, or None
        for a division by zero between scalars."""
        bound: Dict[str, object] = {}

        def bind(value):
            if isinstance(value, np.ndarray):
                value = torch.from_numpy(value)
            name = f"_v{len(bound)}_"
            bound[name] = _wrap(value)
            return name

        expr = self.source
        expr = _DOC_VALUE_RE.sub(
            lambda m: bind(columns.get(m.group(1), 0.0)), expr)
        expr = _DOC_LEN_RE.sub(
            lambda m: bind(columns.get(f"{m.group(1)}#len", 0.0)), expr)
        expr = _SCORE_RE.sub(
            lambda m: bind(scores if scores is not None else 0.0), expr)
        expr = self._bind_params(expr, params)
        if expr is None:
            return self._painless_fallback().execute_columns(
                columns, params, scores)
        _check_grammar(self.source, re.sub(r"_v\d+_", "", expr))
        try:
            with np.errstate(divide="ignore", invalid="ignore"):
                out = eval(  # noqa: S307 — grammar-sanitized above
                    expr, {"__builtins__": {}}, {**_COLUMN_FUNCTIONS, **bound}
                )
        except ZeroDivisionError:
            # a division by zero between scalars: the same no-match
            # contract as execute()
            return None
        except Exception as e:
            raise ParsingException(
                f"failed to run script [{self.source}]: {e}"
            ) from e
        return _raw(out)


# the ScriptPlugin extension point: {lang: compile(source) -> CompiledScript-like}
# (filled when plugins/ is ported)
CUSTOM_SCRIPT_ENGINES: dict = {}


def expression_eligible(src: str) -> bool:
    """True when the source fits the numeric-expression grammar (the
    whole-segment tensor path). The painless interpreter serves
    everything else."""
    stripped = _DOC_VALUE_RE.sub("0", src)
    stripped = _DOC_LEN_RE.sub("0", stripped)
    stripped = _SCORE_RE.sub("0", stripped)
    stripped = _PARAM_RE.sub("0", stripped)
    for fn in _FUNCTIONS:
        stripped = stripped.replace(fn, "")
    return all(c in _ALLOWED for c in stripped)


def compile_script(script_spec):
    """A script spec as the reference takes it: a string, or
    {"source"|"inline": ..., "lang": ..., "params": {...}} (params bound
    at execution). A lang other than painless or expression dispatches to
    ``CUSTOM_SCRIPT_ENGINES``.

    The default lang is painless: a source that fits the numeric grammar
    compiles to the expression engine, anything else to the painless
    interpreter. lang=expression forces the numeric engine and rejects
    anything outside its grammar at compile time."""
    if isinstance(script_spec, str):
        script_spec = {"source": script_spec}
    src = script_spec.get("source") or script_spec.get("inline")
    if src is None:
        raise ParsingException("script requires [source]")
    if not isinstance(src, str):
        raise ParsingException("script [source] must be a string")
    lang = script_spec.get("lang")
    if lang is not None and lang not in ("painless", "expression"):
        engine = CUSTOM_SCRIPT_ENGINES.get(lang)
        if engine is None:
            raise ParsingException(f"script_lang not supported [{lang}]")
        return engine(src)
    return _compile_default_lang(src, lang)


@functools.lru_cache(maxsize=512)
def _compile_default_lang(src: str, lang):
    """Compiled scripts are stateless (a fresh interpreter each
    execution), so identical sources share one parse: bulk updates would
    otherwise lex and parse once a document."""
    if expression_eligible(src):
        return CompiledScript(src)
    if lang == "expression":
        raise ParsingException(
            f"unsupported script [{src}]: lang=expression allows only "
            f"numeric expressions over doc values/params")
    from elasticsearch_tpu_torch.script.painless import PainlessScript

    return PainlessScript(src)


def segment_columns(segment, doc_fields) -> Dict[str, torch.Tensor]:
    """Whole-segment float64 columns for ``execute_columns``, on the
    segment's device: for each doc field its first value per doc under
    ``f`` and its value count per doc under ``f#len`` (a keyword field
    binds its ordinals; an absent field zeros, so the expression stays in
    column arithmetic on every segment). Each is staged once a segment
    (``device_column`` keys ``script:<f>`` and ``script:<f>#len``, in the
    ledger as ``doc_values``): a segment's columns never change."""
    columns: Dict[str, torch.Tensor] = {}
    for f in doc_fields:
        columns[f] = segment.device_column(
            f"script:{f}", lambda f=f: _first_column(segment, f))
        columns[f + "#len"] = segment.device_column(
            f"script:{f}#len", lambda f=f: _length_column(segment, f))
    return columns


def _doc_value_column(segment, field):
    col = segment.numeric_columns.get(field)
    if col is not None:
        return col, col.first_value
    ocol = (segment.ordinal_columns.get(field)
            or segment.ordinal_columns.get(f"{field}.keyword"))
    if ocol is not None:
        return ocol, ocol.first_ord.astype(np.float64)
    return None, None


def _first_column(segment, field) -> np.ndarray:
    col, first = _doc_value_column(segment, field)
    if col is None:
        return np.zeros(segment.nd_pad, dtype=np.float64)
    return np.where(col.exists, first, 0.0)


def _length_column(segment, field) -> np.ndarray:
    col, _first = _doc_value_column(segment, field)
    nd = segment.nd_pad
    if col is None:
        return np.zeros(nd, dtype=np.float64)
    lens = np.bincount(col.flat_docs[: col.count], minlength=nd + 1)
    return lens[:nd].astype(np.float64)


def doc_values_for(segment, local_doc: int, fields) -> Dict[str, float]:
    """One doc's values for ``CompiledScript.execute`` (host columns)."""
    out: Dict[str, float] = {}
    for f in fields:
        col = segment.numeric_columns.get(f)
        if col is not None and col.exists[local_doc]:
            out[f] = float(col.first_value[local_doc])
            sel = col.flat_docs[: col.count] == local_doc
            out[f + "#len"] = float(sel.sum())
            continue
        ocol = segment.ordinal_columns.get(f) or segment.ordinal_columns.get(
            f"{f}.keyword"
        )
        if ocol is not None and ocol.exists[local_doc]:
            out[f] = float(ocol.first_ord[local_doc])
            out[f + "#len"] = 1.0
    return out
