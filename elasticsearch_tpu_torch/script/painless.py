"""Painless-class scripting: lexer, parser, interpreter.

Counterpart of ``elasticsearch_tpu/script/painless.py``, line for line but
for its imports and ``PainlessScript.execute_columns``. The language is
the reference's surface (``modules/lang-painless``): Java-ish statements
and expressions, ``doc['f'].value`` doc-value access, ``ctx._source``
update mutation, ``params``, Math/String/List/Map method whitelists and a
hard statement budget (``Interpreter._tick``) that bounds every
execution. It runs on a small tree-walking interpreter on the host; the
numeric subset compiles through the expression engine
(``script/expression.py``) into whole-segment tensor arithmetic on the
segment's device instead.

Whitelist-only as the reference: unknown methods raise at run time and
there is no attribute access into the interpreter's internals.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from elasticsearch_tpu_torch.common.errors import ScriptException


# ----------------------------------------------------------------------
# Lexer
# ----------------------------------------------------------------------

_PUNCT = (
    "===", "!==", "==", "!=", "<=", ">=", "&&", "||", "++", "--", "+=",
    "-=", "*=", "/=", "%=", "?:", "?.", "->", "{", "}", "(", ")", "[", "]",
    ";", ",", ".", "+", "-", "*", "/", "%", "<", ">", "=", "!", "?", ":",
)

_KEYWORDS = {
    "if", "else", "while", "for", "return", "break", "continue", "def",
    "in", "new", "true", "false", "null", "int", "long", "double", "float",
    "boolean", "String", "Map", "List", "HashMap", "ArrayList", "Object",
    "void", "instanceof",
}


class Tok:
    __slots__ = ("kind", "text", "pos")

    def __init__(self, kind: str, text: str, pos: int):
        self.kind = kind  # id | num | str | punct | kw | eof
        self.text = text
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.text!r}"


def _lex(src: str) -> List[Tok]:
    toks: List[Tok] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                raise ScriptException("unterminated block comment")
            i = j + 2
            continue
        if c in "'\"":
            j = i + 1
            buf = []
            while j < n and src[j] != c:
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", "\\": "\\",
                                "'": "'", '"': '"'}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise ScriptException("unterminated string literal")
            toks.append(Tok("str", "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = src[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    # `1.max(...)` must lex as 1 . max — a dot is part of
                    # the number only when a digit follows
                    if j + 1 < n and src[j + 1].isdigit():
                        seen_dot = True
                        j += 1
                    else:
                        break
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                        src[j + 1].isdigit() or src[j + 1] in "+-"):
                    seen_exp = True
                    j += 2
                else:
                    break
            text = src[i:j]
            if j < n and src[j] in "lLfFdD":  # java literal suffixes
                if src[j] in "fFdD":
                    seen_dot = True
                j += 1
            toks.append(Tok("num", text + ("f" if seen_dot else ""), i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            toks.append(Tok("kw" if word in _KEYWORDS else "id", word, i))
            i = j
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(Tok("punct", p, i))
                i += len(p)
                break
        else:
            raise ScriptException(f"unexpected character [{c}] at {i}")
    toks.append(Tok("eof", "", n))
    return toks


# ----------------------------------------------------------------------
# Parser -> tuple AST  (kind, ...)
# ----------------------------------------------------------------------

_TYPE_WORDS = {"def", "int", "long", "double", "float", "boolean", "String",
               "Map", "List", "Object", "HashMap", "ArrayList", "void"}


class _Parser:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, k=0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def op(self, *texts) -> Optional[str]:
        """Current token's text when it's one of the given PUNCT
        operators (a string literal '-' must never match minus)."""
        t = self.toks[self.i]
        if t.kind == "punct" and t.text in texts:
            return t.text
        return None

    def accept(self, text: str) -> bool:
        if self.peek().text == text and self.peek().kind in ("punct", "kw"):
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> None:
        if not self.accept(text):
            raise ScriptException(
                f"expected [{text}] but found [{self.peek().text}]")

    # --- statements ---

    def parse_program(self):
        stmts = []
        while self.peek().kind != "eof":
            stmts.append(self.statement())
        # the trailing expression statement is the script's value
        # (painless source "doc['n'].value * 2" has no explicit return)
        if stmts and stmts[-1][0] == "expr":
            stmts[-1] = ("return", stmts[-1][1])
        return ("block", stmts)

    def block_or_stmt(self):
        if self.accept("{"):
            stmts = []
            while not self.accept("}"):
                stmts.append(self.statement())
            return ("block", stmts)
        return self.statement()

    def statement(self):
        t = self.peek()
        if t.text == "{":
            return self.block_or_stmt()
        if t.text == "if":
            self.next()
            self.expect("(")
            cond = self.expression()
            self.expect(")")
            then = self.block_or_stmt()
            other = None
            if self.accept("else"):
                other = self.block_or_stmt()
            return ("if", cond, then, other)
        if t.text == "while":
            self.next()
            self.expect("(")
            cond = self.expression()
            self.expect(")")
            return ("while", cond, self.block_or_stmt())
        if t.text == "for":
            self.next()
            self.expect("(")
            # for-each: for (def x : expr)
            save = self.i
            if (self.peek().text in _TYPE_WORDS and self.peek(1).kind == "id"
                    and self.peek(2).text == ":"):
                self.next()
                var = self.next().text
                self.expect(":")
                it = self.expression()
                self.expect(")")
                return ("foreach", var, it, self.block_or_stmt())
            self.i = save
            init = None if self.peek().text == ";" else self.simple_statement()
            self.expect(";")
            cond = None if self.peek().text == ";" else self.expression()
            self.expect(";")
            step = None if self.peek().text == ")" else self.expression()
            self.expect(")")
            return ("for", init, cond, step, self.block_or_stmt())
        if t.text == "return":
            self.next()
            val = None
            if self.peek().text != ";" and self.peek().kind != "eof":
                val = self.expression()
            self.accept(";")
            return ("return", val)
        if t.text == "break":
            self.next()
            self.accept(";")
            return ("break",)
        if t.text == "continue":
            self.next()
            self.accept(";")
            return ("continue",)
        s = self.simple_statement()
        self.accept(";")
        return s

    def simple_statement(self):
        # declaration: TYPE name [= expr] (, name [= expr])*
        if (self.peek().text in _TYPE_WORDS and self.peek().text != "void"
                and self.peek(1).kind == "id"):
            self.next()
            decls = []
            while True:
                name = self.next().text
                val = self.expression() if self.accept("=") else None
                decls.append((name, val))
                if not self.accept(","):
                    break
            return ("decl", decls)
        return ("expr", self.expression())

    # --- expressions (precedence climbing) ---

    def expression(self):
        return self.assignment()

    def assignment(self):
        left = self.ternary()
        t = self.op("=", "+=", "-=", "*=", "/=", "%=")
        if t:
            self.next()
            right = self.assignment()
            if left[0] not in ("var", "index", "field"):
                raise ScriptException("invalid assignment target")
            return ("assign", t, left, right)
        return left

    def ternary(self):
        cond = self.elvis()
        if self.accept("?"):
            a = self.assignment()
            self.expect(":")
            b = self.assignment()
            return ("ternary", cond, a, b)
        return cond

    def elvis(self):
        left = self.logic_or()
        if self.accept("?:"):
            return ("elvis", left, self.elvis())
        return left

    def logic_or(self):
        left = self.logic_and()
        while self.accept("||"):
            left = ("or", left, self.logic_and())
        return left

    def logic_and(self):
        left = self.equality()
        while self.accept("&&"):
            left = ("and", left, self.equality())
        return left

    def equality(self):
        left = self.relational()
        while self.op("==", "!=", "===", "!=="):
            op = self.next().text
            left = ("cmp", op[:2], left, self.relational())
        return left

    def relational(self):
        left = self.additive()
        while self.op("<", ">", "<=", ">=") or \
                self.peek().text == "instanceof":
            if self.accept("instanceof"):
                tname = self.next().text
                left = ("instanceof", left, tname)
                continue
            op = self.next().text
            left = ("cmp", op, left, self.additive())
        return left

    def additive(self):
        left = self.multiplicative()
        while self.op("+", "-"):
            op = self.next().text
            left = ("bin", op, left, self.multiplicative())
        return left

    def multiplicative(self):
        left = self.unary()
        while self.op("*", "/", "%"):
            op = self.next().text
            left = ("bin", op, left, self.unary())
        return left

    def unary(self):
        t = self.op("!", "-", "+", "++", "--")
        if t == "!":
            self.next()
            return ("not", self.unary())
        if t == "-":
            self.next()
            return ("neg", self.unary())
        if t == "+":
            self.next()
            return self.unary()
        if t in ("++", "--"):
            self.next()
            target = self.unary()
            return ("assign", "+=" if t == "++" else "-=", target,
                    ("num", 1))
        return self.postfix()

    def postfix(self):
        node = self.primary()
        while True:
            if self.accept("."):
                name = self.next().text
                if self.accept("("):
                    args = self.call_args()
                    node = ("call", node, name, args)
                else:
                    node = ("field", node, name)
            elif self.accept("?."):
                name = self.next().text
                if self.accept("("):
                    args = self.call_args()
                    node = ("safecall", node, name, args)
                else:
                    node = ("safefield", node, name)
            elif self.accept("["):
                idx = self.expression()
                self.expect("]")
                node = ("index", node, idx)
            elif self.op("++", "--") and node[0] in (
                    "var", "index", "field"):
                op = self.next().text
                node = ("postincr", "+=" if op == "++" else "-=", node)
            else:
                return node

    def call_args(self):
        args = []
        if self.accept(")"):
            return args
        while True:
            args.append(self.expression())
            if self.accept(")"):
                return args
            self.expect(",")

    def primary(self):
        t = self.next()
        if t.kind == "num":
            if t.text.endswith("f"):
                return ("num", float(t.text[:-1]))
            return ("num", int(t.text) if "." not in t.text
                    and "e" not in t.text and "E" not in t.text
                    else float(t.text))
        if t.kind == "str":
            return ("str", t.text)
        if t.text == "true":
            return ("bool", True)
        if t.text == "false":
            return ("bool", False)
        if t.text == "null":
            return ("null",)
        if t.text == "new":
            tname = self.next().text
            self.expect("(")
            self.call_args()  # constructor args discarded (sized ctors)
            if tname in ("HashMap", "TreeMap", "LinkedHashMap", "Map"):
                return ("mapinit", [])
            if tname in ("ArrayList", "LinkedList", "List", "HashSet"):
                return ("listinit", [])
            if tname == "StringBuilder":
                return ("strbuilder",)
            raise ScriptException(f"unknown type [new {tname}]")
        if t.text == "(":
            # cast? (int) x — accept and ignore numeric casts
            if (self.peek().text in _TYPE_WORDS
                    and self.peek(1).text == ")"):
                tname = self.next().text
                self.expect(")")
                expr = self.unary()
                return ("cast", tname, expr)
            e = self.expression()
            self.expect(")")
            return e
        if t.text == "[":
            # list initializer [a, b] or map initializer [k: v] / [:]
            if self.accept(":"):
                self.expect("]")
                return ("mapinit", [])
            if self.accept("]"):
                return ("listinit", [])
            first = self.expression()
            if self.accept(":"):
                pairs = [(first, self.expression())]
                while self.accept(","):
                    k = self.expression()
                    self.expect(":")
                    pairs.append((k, self.expression()))
                self.expect("]")
                return ("mapinit", pairs)
            items = [first]
            while self.accept(","):
                items.append(self.expression())
            self.expect("]")
            return ("listinit", items)
        if t.kind in ("id", "kw"):
            return ("var", t.text)
        raise ScriptException(f"unexpected token [{t.text}]")


# ----------------------------------------------------------------------
# Runtime values
# ----------------------------------------------------------------------


class DocValues:
    """doc['field'] — ScriptDocValues semantics: .value is the first
    value (0/'' defaults never apply: missing access raises like the
    reference when the doc has no value), .values/.size()/.empty."""

    __slots__ = ("field", "_values")

    def __init__(self, field: str, values: List[Any]):
        self.field = field
        self._values = values

    @property
    def value(self):
        if not self._values:
            raise ScriptException(
                f"A document doesn't have a value for field [{self.field}]!"
                " Use doc[<field>].size()==0 to check if a document is"
                " missing a field!")
        return self._values[0]

    @property
    def values(self):
        return list(self._values)

    @property
    def empty(self):
        return not self._values

    @property
    def length(self):
        return len(self._values)

    def size(self):
        return len(self._values)


class DocMap:
    """The ``doc`` binding: field name -> DocValues, resolved lazily from
    a segment/local doc or from a prebound {field: [values]} dict."""

    def __init__(self, resolve: Callable[[str], List[Any]]):
        self._resolve = resolve
        self._cache: Dict[str, DocValues] = {}

    def __getitem__(self, field: str) -> DocValues:
        if field not in self._cache:
            self._cache[field] = DocValues(field, self._resolve(field))
        return self._cache[field]

    def containsKey(self, field: str) -> bool:
        return len(self._resolve(field)) > 0


class _StringBuilder:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: List[str] = []


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


# ----------------------------------------------------------------------
# Interpreter
# ----------------------------------------------------------------------

_MAX_OPS = 1_000_000  # LoopCounter analog: hard budget per execution

_MATH = {
    "abs": abs, "max": max, "min": min, "pow": math.pow, "sqrt": math.sqrt,
    "cbrt": lambda x: math.copysign(abs(x) ** (1 / 3), x),
    "log": math.log, "log10": math.log10, "exp": math.exp,
    "floor": math.floor, "ceil": math.ceil, "round": round,
    "sin": math.sin, "cos": math.cos, "tan": math.tan, "atan": math.atan,
    "atan2": math.atan2, "asin": math.asin, "acos": math.acos,
    "toRadians": math.radians, "toDegrees": math.degrees,
    "hypot": math.hypot, "signum": lambda x: float((x > 0) - (x < 0)),
    "random": None,  # rejected below: scripts must be deterministic
}

_MATH_CONSTS = {"PI": math.pi, "E": math.e}


def _num(v):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ScriptException(f"number expected, got [{type(v).__name__}]")
    return v


class Interpreter:
    def __init__(self, bindings: Dict[str, Any]):
        self.scopes: List[Dict[str, Any]] = [dict(bindings)]
        self.ops = 0

    # --- scope helpers ---

    def lookup(self, name: str):
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        raise ScriptException(f"variable [{name}] is not defined")

    def declare(self, name: str, value):
        self.scopes[-1][name] = value

    def set_var(self, name: str, value):
        for scope in reversed(self.scopes):
            if name in scope:
                scope[name] = value
                return
        # painless allows assignment to create in current scope only via
        # decl; mirror leniently by declaring
        self.scopes[-1][name] = value

    def _tick(self):
        self.ops += 1
        if self.ops > _MAX_OPS:
            raise ScriptException(
                "script exceeded the allowed execution budget "
                "(possible infinite loop)")

    # --- statements ---

    def run(self, node) -> Any:
        try:
            self.exec_stmt(node)
        except _Return as r:
            return r.value
        return None

    def exec_stmt(self, node):
        self._tick()
        kind = node[0]
        if kind == "block":
            self.scopes.append({})
            try:
                for s in node[1]:
                    self.exec_stmt(s)
            finally:
                self.scopes.pop()
        elif kind == "decl":
            for name, val in node[1]:
                self.declare(name,
                             None if val is None else self.eval(val))
        elif kind == "expr":
            self.eval(node[1])
        elif kind == "if":
            if self.truthy(self.eval(node[1])):
                self.exec_stmt(node[2])
            elif node[3] is not None:
                self.exec_stmt(node[3])
        elif kind == "while":
            while self.truthy(self.eval(node[1])):
                self._tick()
                try:
                    self.exec_stmt(node[2])
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "for":
            self.scopes.append({})
            try:
                if node[1] is not None:
                    self.exec_stmt(node[1])
                while node[2] is None or self.truthy(self.eval(node[2])):
                    self._tick()
                    try:
                        self.exec_stmt(node[4])
                    except _Break:
                        break
                    except _Continue:
                        pass
                    if node[3] is not None:
                        self.eval(node[3])
            finally:
                self.scopes.pop()
        elif kind == "foreach":
            it = self.eval(node[2])
            if isinstance(it, dict):
                it = list(it.keys())
            if not isinstance(it, (list, tuple, str)):
                raise ScriptException("for-each requires a list/map/string")
            self.scopes.append({})
            try:
                for v in it:
                    self._tick()
                    self.declare(node[1], v)
                    try:
                        self.exec_stmt(node[3])
                    except _Break:
                        break
                    except _Continue:
                        continue
            finally:
                self.scopes.pop()
        elif kind == "return":
            raise _Return(None if node[1] is None else self.eval(node[1]))
        elif kind == "break":
            raise _Break()
        elif kind == "continue":
            raise _Continue()
        else:
            raise ScriptException(f"unknown statement [{kind}]")

    @staticmethod
    def truthy(v) -> bool:
        if isinstance(v, bool):
            return v
        if v is None:
            return False
        raise ScriptException(
            f"condition must be boolean, got [{type(v).__name__}]")

    # --- expressions ---

    def eval(self, node) -> Any:
        self._tick()
        kind = node[0]
        if kind == "num" or kind == "str" or kind == "bool":
            return node[1]
        if kind == "null":
            return None
        if kind == "var":
            name = node[1]
            if name == "Math":
                return _MathClass
            if name in ("Integer", "Long", "Double", "Float", "String",
                        "Boolean", "Collections", "Arrays", "Objects"):
                return _StaticClass(name)
            return self.lookup(name)
        if kind == "listinit":
            return [self.eval(e) for e in node[1]]
        if kind == "mapinit":
            return {self.eval(k): self.eval(v) for k, v in node[1]}
        if kind == "strbuilder":
            return _StringBuilder()
        if kind == "cast":
            v = self.eval(node[2])
            t = node[1]
            if t in ("int", "long"):
                return int(_num(v))
            if t in ("double", "float"):
                return float(_num(v))
            if t == "String":
                return _to_string(v)
            return v
        if kind == "neg":
            return -_num(self.eval(node[1]))
        if kind == "not":
            v = self.eval(node[1])
            if not isinstance(v, bool):
                raise ScriptException("! requires a boolean")
            return not v
        if kind == "and":
            return (self.truthy(self.eval(node[1]))
                    and self.truthy(self.eval(node[2])))
        if kind == "or":
            return (self.truthy(self.eval(node[1]))
                    or self.truthy(self.eval(node[2])))
        if kind == "ternary":
            return (self.eval(node[2]) if self.truthy(self.eval(node[1]))
                    else self.eval(node[3]))
        if kind == "elvis":
            v = self.eval(node[1])
            return v if v is not None else self.eval(node[2])
        if kind == "cmp":
            return self._compare(node[1], self.eval(node[2]),
                                 self.eval(node[3]))
        if kind == "bin":
            return self._binop(node[1], self.eval(node[2]),
                               self.eval(node[3]))
        if kind == "instanceof":
            v = self.eval(node[1])
            t = node[2]
            return {
                "String": isinstance(v, str),
                "Map": isinstance(v, dict),
                "List": isinstance(v, list),
                "Integer": isinstance(v, int) and not isinstance(v, bool),
                "Long": isinstance(v, int) and not isinstance(v, bool),
                "Double": isinstance(v, float),
                "Float": isinstance(v, float),
                "Boolean": isinstance(v, bool),
            }.get(t, v is not None)
        if kind == "index":
            obj = self.eval(node[1])
            idx = self.eval(node[2])
            return self._index_get(obj, idx)
        if kind == "field" or kind == "safefield":
            obj = self.eval(node[1])
            if obj is None:
                if kind == "safefield":
                    return None
                raise ScriptException(
                    f"null pointer: cannot access [{node[2]}]")
            return self._get_field(obj, node[2])
        if kind == "call" or kind == "safecall":
            obj = self.eval(node[1])
            if obj is None:
                if kind == "safecall":
                    return None
                raise ScriptException(
                    f"null pointer: cannot call [{node[2]}]")
            args = [self.eval(a) for a in node[3]]
            return self._call_method(obj, node[2], args)
        if kind == "assign":
            return self._assign(node[1], node[2], node[3])
        if kind == "postincr":
            old = self.eval(node[2])
            self._assign(node[1], node[2], ("num", 1))
            return old
        raise ScriptException(f"unknown expression [{kind}]")

    # --- operators ---

    def _binop(self, op, a, b):
        if op == "+":
            if isinstance(a, str) or isinstance(b, str):
                return _to_string(a) + _to_string(b)
            if isinstance(a, list) and isinstance(b, list):
                return a + b
            return _num(a) + _num(b)
        if op == "-":
            return _num(a) - _num(b)
        if op == "*":
            return _num(a) * _num(b)
        if op == "/":
            a, b = _num(a), _num(b)
            if b == 0:
                if isinstance(a, int) and isinstance(b, int):
                    raise ScriptException("/ by zero")
                return math.inf if a > 0 else (-math.inf if a < 0
                                               else math.nan)
            if isinstance(a, int) and isinstance(b, int):
                q = abs(a) // abs(b)  # java truncates toward zero
                return q if (a >= 0) == (b >= 0) else -q
            return a / b
        if op == "%":
            a, b = _num(a), _num(b)
            if b == 0:
                raise ScriptException("% by zero")
            r = abs(a) % abs(b)  # java sign-of-dividend semantics
            return r if a >= 0 else -r
        raise ScriptException(f"unknown operator [{op}]")

    @staticmethod
    def _compare(op, a, b):
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        try:
            if op == "<":
                return a < b
            if op == ">":
                return a > b
            if op == "<=":
                return a <= b
            if op == ">=":
                return a >= b
        except TypeError:
            raise ScriptException(
                f"cannot compare [{type(a).__name__}] and "
                f"[{type(b).__name__}]") from None
        raise ScriptException(f"unknown comparison [{op}]")

    # --- member access / mutation ---

    @staticmethod
    def _index_get(obj, idx):
        if isinstance(obj, (DocMap, dict)):
            try:
                return obj[idx]
            except KeyError:
                return None
        if isinstance(obj, (list, str)):
            i = int(_num(idx))
            if not -len(obj) <= i < len(obj):
                raise ScriptException(f"index [{i}] out of bounds")
            return obj[i]
        raise ScriptException(
            f"cannot index [{type(obj).__name__}]")

    def _assign(self, op, target, value_node):
        value = self.eval(value_node)
        if op != "=":
            current = self.eval(target)
            value = self._binop(op[0], current, value)
        kind = target[0]
        if kind == "var":
            self.set_var(target[1], value)
        elif kind == "index":
            obj = self.eval(target[1])
            idx = self.eval(target[2])
            if isinstance(obj, dict):
                obj[idx] = value
            elif isinstance(obj, list):
                i = int(_num(idx))
                if not -len(obj) <= i < len(obj):
                    raise ScriptException(f"index [{i}] out of bounds")
                obj[i] = value
            else:
                raise ScriptException(
                    f"cannot index-assign [{type(obj).__name__}]")
        elif kind == "field":
            obj = self.eval(target[1])
            if isinstance(obj, dict):
                obj[target[2]] = value
            elif hasattr(obj, "_painless_setfield"):
                obj._painless_setfield(target[2], value)
            else:
                raise ScriptException(
                    f"cannot set field [{target[2]}] on "
                    f"[{type(obj).__name__}]")
        else:
            raise ScriptException("invalid assignment target")
        return value

    @staticmethod
    def _get_field(obj, name):
        if isinstance(obj, _MathClassType):
            if name in _MATH_CONSTS:
                return _MATH_CONSTS[name]
            raise ScriptException(f"unknown Math member [{name}]")
        if isinstance(obj, DocValues):
            if name in ("value", "values", "empty", "length"):
                return getattr(obj, name)
            raise ScriptException(f"unknown doc-values member [{name}]")
        if isinstance(obj, dict):
            return obj.get(name)
        if isinstance(obj, str) and name == "length":
            return len(obj)
        raise ScriptException(
            f"unknown field [{name}] on [{type(obj).__name__}]")

    def _call_method(self, obj, name, args):
        if isinstance(obj, _MathClassType):
            fn = _MATH.get(name)
            if fn is None:
                raise ScriptException(f"unknown Math method [{name}]")
            try:
                return fn(*[_num(a) for a in args])
            except ScriptException:
                raise
            except (ValueError, TypeError, OverflowError) as e:
                raise ScriptException(f"Math.{name}: {e}") from e
        if isinstance(obj, _StaticClass):
            return obj.call(name, args)
        table = _METHODS.get(type(obj))
        if table is not None:
            fn = table.get(name)
            if fn is not None:
                try:
                    return fn(obj, *args)
                except ScriptException:
                    raise
                except (IndexError, KeyError, ValueError, TypeError,
                        AttributeError) as e:
                    raise ScriptException(
                        f"{type(obj).__name__}.{name}: {e}") from e
        if isinstance(obj, DocValues):
            if name == "size":
                return obj.size()
            if name == "getValue":
                return obj.value
            if name == "isEmpty":
                return obj.empty
        if isinstance(obj, DocMap) and name == "containsKey":
            return obj.containsKey(args[0])
        raise ScriptException(
            f"unknown method [{name}] on [{type(obj).__name__}]")


class _MathClassType:
    pass


_MathClass = _MathClassType()


class _StaticClass:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def call(self, method, args):
        key = (self.name, method)
        fns = {
            ("Integer", "parseInt"): lambda s: int(s),
            ("Long", "parseLong"): lambda s: int(s),
            ("Double", "parseDouble"): lambda s: float(s),
            ("Float", "parseFloat"): lambda s: float(s),
            ("Integer", "toString"): _to_string,
            ("Double", "toString"): _to_string,
            ("String", "valueOf"): _to_string,
            ("Boolean", "parseBoolean"): lambda s: s == "true",
            ("Objects", "equals"): lambda a, b: a == b,
            ("Objects", "isNull"): lambda a: a is None,
            ("Collections", "sort"): lambda l: l.sort(),
            ("Collections", "reverse"): lambda l: l.reverse(),
            ("Collections", "max"): max,
            ("Collections", "min"): min,
            ("Arrays", "asList"): lambda *a: list(a),
        }
        fn = fns.get(key)
        if fn is None:
            raise ScriptException(
                f"unknown static method [{self.name}.{method}]")
        try:
            return fn(*args)
        except (ValueError, TypeError) as e:
            raise ScriptException(f"{self.name}.{method}: {e}") from e


def _to_string(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return f"{v:.1f}"
    return str(v)


def _substring(s, a, b=None):
    a = int(a)
    b = len(s) if b is None else int(b)
    if not (0 <= a <= b <= len(s)):
        raise ScriptException(f"substring [{a}:{b}] out of bounds")
    return s[a:b]


_METHODS: Dict[type, Dict[str, Callable]] = {
    str: {
        "length": lambda s: len(s),
        "substring": _substring,
        "contains": lambda s, x: x in s,
        "startsWith": lambda s, x: s.startswith(x),
        "endsWith": lambda s, x: s.endswith(x),
        "toLowerCase": lambda s: s.lower(),
        "toUpperCase": lambda s: s.upper(),
        "indexOf": lambda s, x, *f: s.find(x, *[int(v) for v in f]),
        "lastIndexOf": lambda s, x: s.rfind(x),
        "replace": lambda s, a, b: s.replace(a, b),
        "split": lambda s, sep: s.split(sep),
        "trim": lambda s: s.strip(),
        "charAt": lambda s, i: s[int(i)],
        "equals": lambda s, o: s == o,
        "equalsIgnoreCase": lambda s, o: isinstance(o, str)
        and s.lower() == o.lower(),
        "isEmpty": lambda s: len(s) == 0,
        "compareTo": lambda s, o: (s > o) - (s < o),
        "concat": lambda s, o: s + o,
        "toString": lambda s: s,
        "hashCode": lambda s: _java_string_hash(s),
    },
    list: {
        "add": lambda l, *a: (l.insert(int(a[0]), a[1])
                              if len(a) == 2 else l.append(a[0])) or True,
        "get": lambda l, i: l[int(i)],
        "set": lambda l, i, v: l.__setitem__(int(i), v) or v,
        "size": lambda l: len(l),
        "isEmpty": lambda l: len(l) == 0,
        "contains": lambda l, v: v in l,
        "indexOf": lambda l, v: l.index(v) if v in l else -1,
        "remove": lambda l, i: l.pop(int(i)),
        "clear": lambda l: l.clear(),
        "addAll": lambda l, o: l.extend(o) or True,
        "sort": lambda l: l.sort(),
        "toString": _to_string,
        "hashCode": lambda l: hash(tuple(map(str, l))),
    },
    dict: {
        "put": lambda m, k, v: m.update({k: v}),
        "get": lambda m, k: m.get(k),
        "getOrDefault": lambda m, k, d: m.get(k, d),
        "containsKey": lambda m, k: k in m,
        "containsValue": lambda m, v: v in m.values(),
        "remove": lambda m, k: m.pop(k, None),
        "keySet": lambda m: list(m.keys()),
        "values": lambda m: list(m.values()),
        "entrySet": lambda m: [{"key": k, "value": v}
                               for k, v in m.items()],
        "size": lambda m: len(m),
        "isEmpty": lambda m: len(m) == 0,
        "clear": lambda m: m.clear(),
        "putAll": lambda m, o: m.update(o),
    },
    _StringBuilder: {
        "append": lambda sb, v: sb.parts.append(_to_string(v)) or sb,
        "toString": lambda sb: "".join(sb.parts),
        "length": lambda sb: sum(len(p) for p in sb.parts),
    },
    int: {
        "toString": _to_string,
        "intValue": lambda v: v,
        "longValue": lambda v: v,
        "doubleValue": lambda v: float(v),
        "compareTo": lambda v, o: (v > o) - (v < o),
    },
    float: {
        "toString": _to_string,
        "intValue": lambda v: int(v),
        "longValue": lambda v: int(v),
        "doubleValue": lambda v: v,
        "isNaN": lambda v: math.isnan(v),
        "compareTo": lambda v, o: (v > o) - (v < o),
    },
}


def _java_string_hash(s: str) -> int:
    h = 0
    for c in s:
        h = (31 * h + ord(c)) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


# ----------------------------------------------------------------------
# Compiled script facade
# ----------------------------------------------------------------------


def _collect_doc_fields(node, out):
    """Fields accessed as doc['f'] — for column prefetch."""
    if not isinstance(node, tuple):
        return
    if (node[0] == "index" and node[1] == ("var", "doc")
            and node[2][0] == "str"):
        out.append(node[2][1])
    for child in node:
        if isinstance(child, tuple):
            _collect_doc_fields(child, out)
        elif isinstance(child, list):
            for c in child:
                if isinstance(c, tuple):
                    _collect_doc_fields(c, out)
                elif isinstance(c, (list, tuple)):
                    for cc in c:
                        _collect_doc_fields(cc, out)


class PainlessScript:
    """Compiled form: parsed once; each execution runs the interpreter
    over fresh bindings. API-compatible with expression.CompiledScript
    (execute / execute_columns / doc_fields) plus a generic run()."""

    def __init__(self, source: str):
        self.source = source
        try:
            self.ast = _Parser(_lex(source)).parse_program()
        except ScriptException as e:
            raise ScriptException(
                f"compile error in script [{source}]: {e}") from e
        self.doc_fields: List[str] = []
        _collect_doc_fields(self.ast, self.doc_fields)

    def run(self, bindings: Dict[str, Any]) -> Any:
        """Execute with explicit bindings (doc, ctx, params, _score...).
        The script's return value is the last `return`, or None."""
        base = {"params": {}, **bindings}
        return Interpreter(base).run(self.ast)

    # -- expression.CompiledScript compatibility --

    def execute(self, doc_values: Dict[str, float],
                params: Optional[Dict] = None, score: float = 0.0):
        def resolve(field):
            if field in doc_values:
                return [doc_values[field]]
            return []

        return self.run({
            "doc": DocMap(resolve),
            "params": dict(params or {}),
            "_score": float(score),
        })

    def execute_columns(self, columns: Dict[str, Any],
                        params: Optional[Dict] = None, scores=None):
        """Per-doc interpretation over whole-segment columns: the general
        language does not vectorize, so this loops (the numeric subset
        never reaches here: ``compile_script`` routes it to the
        expression engine's tensor path). Each column (a tensor on the
        segment's device, or a numpy array) moves to the host once,
        before the loop: indexing a CUDA tensor per doc would sync the
        card once a doc. Returns a float64 numpy array."""
        import numpy as np

        columns = {k: _host(v) for k, v in columns.items()}
        scores = None if scores is None else _host(scores)
        sizes = [len(v) for v in columns.values()
                 if isinstance(v, np.ndarray)]
        if scores is not None:
            sizes.append(len(scores))
        if not sizes:
            return self.run({"doc": DocMap(lambda f: []),
                             "params": dict(params or {}),
                             "_score": 0.0})
        nd = min(sizes)
        out = np.zeros(nd, dtype=np.float64)
        for d in range(nd):
            def resolve(field, _d=d):
                col = columns.get(field)
                if col is None:
                    return []
                lens = columns.get(field + "#len")
                if lens is not None and float(lens[_d]) == 0.0:
                    return []
                return [float(col[_d])]

            val = self.run({
                "doc": DocMap(resolve),
                "params": dict(params or {}),
                "_score": float(scores[d]) if scores is not None else 0.0,
            })
            if isinstance(val, bool):
                out[d] = 1.0 if val else 0.0
            elif isinstance(val, (int, float)):
                out[d] = float(val)
            else:
                out[d] = 0.0
        return out


def _host(value):
    """A column as a host numpy array (a tensor moves once); anything else
    as it is."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def segment_doc_resolver(segment, local_doc: int) -> Callable[[str],
                                                              List[Any]]:
    """Typed per-doc doc-values resolver: numeric fields yield floats
    (ints when integral), keyword/string fields yield their terms —
    the ScriptDocValues.Strings/Longs/Doubles split of the reference."""
    def resolve(field: str) -> List[Any]:
        col = segment.numeric_columns.get(field)
        if col is not None and col.exists[local_doc]:
            sel = col.flat_docs[: col.count] == local_doc
            out = []
            for v in col.flat_values[: col.count][sel]:
                f = float(v)
                out.append(int(f) if f.is_integer() else f)
            return out
        ocol = (segment.ordinal_columns.get(field)
                or segment.ordinal_columns.get(f"{field}.keyword"))
        if ocol is not None and ocol.exists[local_doc]:
            sel = ocol.flat_docs[: ocol.count] == local_doc
            return [ocol.terms[o]
                    for o in ocol.flat_ords[: ocol.count][sel]]
        return []

    return resolve


def execute_update_script(script: PainlessScript, source: dict,
                          params: Optional[Dict] = None,
                          doc_meta: Optional[Dict] = None) -> Tuple[dict,
                                                                    str]:
    """Scripted update (UpdateHelper.executeScripts): the script mutates
    ctx._source in place and may set ctx.op ('index' | 'none' | 'delete').
    Returns (new_source, op)."""
    ctx = {"_source": source, "op": "index", **(doc_meta or {})}
    script.run({"ctx": ctx, "params": dict(params or {})})
    op = ctx.get("op", "index")
    if op not in ("index", "none", "noop", "delete", "create"):
        raise ScriptException(f"Operation type [{op}] not allowed")
    return ctx["_source"], ("none" if op == "noop" else op)
