"""Text analysis: tokenizers, token filters, char filters, analyzers.

Counterpart of ``elasticsearch_tpu/analysis/analyzers.py``: an analyzer
is char_filters -> tokenizer -> token_filters, and an index's
``AnalysisRegistry`` builds named custom analyzers from its settings
(``index.analysis.analyzer.<name>.*`` with the tokenizers, filters and
char filters ``index.analysis.{tokenizer,filter,char_filter}.<name>.*``
define). Built-in analyzers: ``standard``, ``simple``, ``whitespace``,
``keyword``, ``stop``, ``english`` and ``snowball``.

Two parts of the JAX module stay out. Its native ASCII fast path for the
standard tokenizer with a leading lowercase filter produces the same
tokens as the pure-Python path the port runs. Its ``EXTRA_*`` plugin
hooks (analysis components a plugin registers) wait for the port's
``plugins/``.

Analysis runs on the host; tokens become term ids before staging. A
token's position is its index in the analyzed stream: a filter that
removes tokens leaves no gap (the JAX package's rule).
"""

from __future__ import annotations

import functools
import re
import unicodedata
from dataclasses import dataclass, field
from typing import Callable, Dict, List

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

# ---------------------------------------------------------------------------
# Tokenizers: text -> [ (token, start_offset, end_offset) ]
# ---------------------------------------------------------------------------

Token = tuple  # (text, start, end)

# Unicode-aware word pattern: letters/digits runs (approximates Lucene's
# StandardTokenizer UAX#29 word-break behavior for alphanumeric text).
_STANDARD_RE = re.compile(r"\w+", re.UNICODE)
_WHITESPACE_RE = re.compile(r"\S+")
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)


def standard_tokenizer(text: str) -> List[Token]:
    return [(m.group(), m.start(), m.end()) for m in _STANDARD_RE.finditer(text)]


def whitespace_tokenizer(text: str) -> List[Token]:
    return [(m.group(), m.start(), m.end()) for m in _WHITESPACE_RE.finditer(text)]


def letter_tokenizer(text: str) -> List[Token]:
    return [(m.group(), m.start(), m.end()) for m in _LETTER_RE.finditer(text)]


def keyword_tokenizer(text: str) -> List[Token]:
    return [(text, 0, len(text))] if text else []


def _ngram_tokens(text: str, min_gram: int, max_gram: int, edge: bool) -> List[Token]:
    out = []
    n = len(text)
    starts = [0] if edge else range(n)
    for i in starts:
        for g in range(min_gram, max_gram + 1):
            if i + g <= n:
                out.append((text[i : i + g], i, i + g))
    return out


def make_ngram_tokenizer(min_gram: int = 1, max_gram: int = 2, edge: bool = False):
    def tok(text: str) -> List[Token]:
        return _ngram_tokens(text, min_gram, max_gram, edge)

    return tok


def make_pattern_tokenizer(pattern: str = r"\W+"):
    rx = re.compile(pattern)

    def tok(text: str) -> List[Token]:
        out, pos = [], 0
        for m in rx.finditer(text):
            if m.start() > pos:
                out.append((text[pos : m.start()], pos, m.start()))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], pos, len(text)))
        return out

    return tok


TOKENIZERS: Dict[str, Callable] = {
    "standard": standard_tokenizer,
    "whitespace": whitespace_tokenizer,
    "letter": letter_tokenizer,
    "keyword": keyword_tokenizer,
    "lowercase": lambda t: [
        (tok.lower(), s, e) for tok, s, e in letter_tokenizer(t)
    ],
}

# ---------------------------------------------------------------------------
# Token filters: [tokens] -> [tokens]; a None/"" token is dropped.
# ---------------------------------------------------------------------------

# Lucene's default English stopword set (EnglishAnalyzer.ENGLISH_STOP_WORDS_SET).
ENGLISH_STOP_WORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


def lowercase_filter(tokens):
    return [(t.lower(), s, e) for t, s, e in tokens]


def uppercase_filter(tokens):
    return [(t.upper(), s, e) for t, s, e in tokens]


def asciifolding_filter(tokens):
    def fold(t):
        return "".join(
            c for c in unicodedata.normalize("NFKD", t) if not unicodedata.combining(c)
        )

    return [(fold(t), s, e) for t, s, e in tokens]


def make_stop_filter(stopwords=ENGLISH_STOP_WORDS):
    sw = frozenset(w.lower() for w in stopwords)

    def f(tokens):
        return [tok for tok in tokens if tok[0].lower() not in sw]

    return f


def make_length_filter(min_len=0, max_len=2**31 - 1):
    def f(tokens):
        return [tok for tok in tokens if min_len <= len(tok[0]) <= max_len]

    return f


def unique_filter(tokens):
    seen, out = set(), []
    for tok in tokens:
        if tok[0] not in seen:
            seen.add(tok[0])
            out.append(tok)
    return out


def reverse_filter(tokens):
    return [(t[::-1], s, e) for t, s, e in tokens]


def trim_filter(tokens):
    return [(t.strip(), s, e) for t, s, e in tokens if t.strip()]


def make_truncate_filter(length=10):
    def f(tokens):
        return [(t[:length], s, e) for t, s, e in tokens]

    return f


def make_shingle_filter(min_size=2, max_size=2, sep=" ", output_unigrams=True):
    def f(tokens):
        out = list(tokens) if output_unigrams else []
        words = [t for t, _, _ in tokens]
        for n in range(min_size, max_size + 1):
            for i in range(len(words) - n + 1):
                text = sep.join(words[i : i + n])
                out.append((text, tokens[i][1], tokens[i + n - 1][2]))
        return out

    return f


_PORTER_STEP1 = [
    ("sses", "ss"),
    ("ies", "i"),
    ("ss", "ss"),
    ("s", ""),
]


@functools.lru_cache(maxsize=1 << 16)
def porter_light_stem(word: str) -> str:
    """A light English stemmer (Porter step-1-ish + common suffixes).

    Stands in for Lucene's PorterStemFilter; exact Porter parity is not a
    conformance surface (scores differ, recall behavior is similar).
    """
    w = word
    if len(w) > 3:
        for suf, rep in _PORTER_STEP1:
            if w.endswith(suf):
                w = w[: -len(suf)] + rep
                break
    for suf in ("ingly", "edly", "ing", "ed", "ly"):
        if len(w) > len(suf) + 2 and w.endswith(suf):
            w = w[: -len(suf)]
            if suf in ("ing", "ed") and len(w) >= 2 and w[-1] == w[-2] and w[-1] not in "lsz":
                w = w[:-1]
            break
    return w


def stemmer_filter(tokens):
    return [(porter_light_stem(t), s, e) for t, s, e in tokens]


TOKEN_FILTERS: Dict[str, Callable] = {
    "lowercase": lowercase_filter,
    "uppercase": uppercase_filter,
    "asciifolding": asciifolding_filter,
    "stop": make_stop_filter(),
    "unique": unique_filter,
    "reverse": reverse_filter,
    "trim": trim_filter,
    "stemmer": stemmer_filter,
    "porter_stem": stemmer_filter,
    "shingle": make_shingle_filter(),
}

# ---------------------------------------------------------------------------
# Char filters: text -> text
# ---------------------------------------------------------------------------

_HTML_RE = re.compile(r"<[^>]*>")


def html_strip_char_filter(text: str) -> str:
    return _HTML_RE.sub(" ", text)


def make_mapping_char_filter(mappings: List[str]):
    pairs = []
    for m in mappings:
        if "=>" not in m:
            raise IllegalArgumentException(f"Invalid mapping rule : [{m}]")
        a, b = m.split("=>", 1)
        pairs.append((a.strip(), b.strip()))

    def f(text: str) -> str:
        for a, b in pairs:
            text = text.replace(a, b)
        return text

    return f


def make_pattern_replace_char_filter(pattern: str, replacement: str = ""):
    rx = re.compile(pattern)

    def f(text: str) -> str:
        return rx.sub(replacement, text)

    return f


CHAR_FILTERS: Dict[str, Callable] = {
    "html_strip": html_strip_char_filter,
}

# ---------------------------------------------------------------------------
# Analyzer = char_filters + tokenizer + filters
# ---------------------------------------------------------------------------


@dataclass
class Analyzer:
    name: str
    tokenizer: Callable[[str], List[Token]]
    token_filters: List[Callable] = field(default_factory=list)
    char_filters: List[Callable] = field(default_factory=list)
    # positions increment per token; a filter removing tokens leaves gaps in
    # the reference; we renumber contiguously (phrase slop semantics differ
    # only around removed stopwords).

    def analyze(self, text: str) -> List[str]:
        return [t for t, _, _ in self.analyze_tokens(text)]

    def analyze_tokens(self, text: str) -> List[Token]:
        if not isinstance(text, str):
            text = str(text)
        for cf in self.char_filters:
            text = cf(text)
        tokens = self.tokenizer(text)
        for f in self.token_filters:
            tokens = f(tokens)
        return [tok for tok in tokens if tok[0]]


def _builtin_analyzers() -> Dict[str, Analyzer]:
    return {
        "standard": Analyzer("standard", standard_tokenizer, [lowercase_filter]),
        "simple": Analyzer("simple", letter_tokenizer, [lowercase_filter]),
        "whitespace": Analyzer("whitespace", whitespace_tokenizer),
        "keyword": Analyzer("keyword", keyword_tokenizer),
        "stop": Analyzer("stop", letter_tokenizer, [lowercase_filter, make_stop_filter()]),
        "english": Analyzer(
            "english",
            standard_tokenizer,
            [lowercase_filter, make_stop_filter(), stemmer_filter],
        ),
        # analysis-common SnowballAnalyzer (default English): same
        # pipeline as "english" here — our stemmer approximates both
        "snowball": Analyzer(
            "snowball",
            standard_tokenizer,
            [lowercase_filter, make_stop_filter(), stemmer_filter],
        ),
    }


class AnalysisRegistry:
    """Builds an index's named analyzers from its settings.

    Settings shape (same as the reference):
      index.analysis.char_filter.<name>.type: mapping|pattern_replace|html_strip
      index.analysis.tokenizer.<name>.type: ngram|edge_ngram|pattern|standard|...
      index.analysis.filter.<name>.type: stop|length|truncate|shingle|...
      index.analysis.analyzer.<name>.type: custom
      index.analysis.analyzer.<name>.tokenizer: <tokenizer-name>
      index.analysis.analyzer.<name>.filter: [f1, f2]
      index.analysis.analyzer.<name>.char_filter: [c1]
    """

    def __init__(self, index_settings=None):
        from elasticsearch_tpu_torch.common.settings import Settings

        self.settings = index_settings or Settings.EMPTY
        self.analyzers: Dict[str, Analyzer] = _builtin_analyzers()
        self._tokenizers = dict(TOKENIZERS)
        self._filters = dict(TOKEN_FILTERS)
        self._char_filters = dict(CHAR_FILTERS)
        self._build_custom()

    def _component_names(self, kind: str) -> List[str]:
        prefix = f"index.analysis.{kind}."
        names = set()
        for key in self.settings.keys():
            if key.startswith(prefix):
                names.add(key[len(prefix) :].split(".")[0])
        return sorted(names)

    def _build_custom(self) -> None:
        s = self.settings
        for name in self._component_names("char_filter"):
            p = f"index.analysis.char_filter.{name}"
            typ = s.get_str(f"{p}.type")
            if typ == "mapping":
                self._char_filters[name] = make_mapping_char_filter(
                    s.get_list(f"{p}.mappings", [])
                )
            elif typ == "pattern_replace":
                self._char_filters[name] = make_pattern_replace_char_filter(
                    s.get_str(f"{p}.pattern", ""), s.get_str(f"{p}.replacement", "")
                )
            elif typ == "html_strip":
                self._char_filters[name] = html_strip_char_filter
            else:
                raise IllegalArgumentException(f"Unknown char_filter type [{typ}] for [{name}]")

        for name in self._component_names("tokenizer"):
            p = f"index.analysis.tokenizer.{name}"
            typ = s.get_str(f"{p}.type")
            if typ in ("ngram", "nGram"):
                self._tokenizers[name] = make_ngram_tokenizer(
                    s.get_int(f"{p}.min_gram", 1), s.get_int(f"{p}.max_gram", 2), False
                )
            elif typ in ("edge_ngram", "edgeNGram"):
                self._tokenizers[name] = make_ngram_tokenizer(
                    s.get_int(f"{p}.min_gram", 1), s.get_int(f"{p}.max_gram", 2), True
                )
            elif typ == "pattern":
                self._tokenizers[name] = make_pattern_tokenizer(
                    s.get_str(f"{p}.pattern", r"\W+")
                )
            elif typ in self._tokenizers:
                self._tokenizers[name] = self._tokenizers[typ]
            else:
                raise IllegalArgumentException(f"Unknown tokenizer type [{typ}] for [{name}]")

        for name in self._component_names("filter"):
            p = f"index.analysis.filter.{name}"
            typ = s.get_str(f"{p}.type")
            if typ == "stop":
                words = s.get_list(f"{p}.stopwords", None)
                self._filters[name] = make_stop_filter(
                    ENGLISH_STOP_WORDS if words in (None, ["_english_"]) else words
                )
            elif typ == "length":
                self._filters[name] = make_length_filter(
                    s.get_int(f"{p}.min", 0), s.get_int(f"{p}.max", 2**31 - 1)
                )
            elif typ == "truncate":
                self._filters[name] = make_truncate_filter(s.get_int(f"{p}.length", 10))
            elif typ == "shingle":
                self._filters[name] = make_shingle_filter(
                    s.get_int(f"{p}.min_shingle_size", 2),
                    s.get_int(f"{p}.max_shingle_size", 2),
                    s.get_str(f"{p}.token_separator", " "),
                    s.get_bool(f"{p}.output_unigrams", True),
                )
            elif typ in self._filters:
                self._filters[name] = self._filters[typ]
            else:
                raise IllegalArgumentException(f"Unknown filter type [{typ}] for [{name}]")

        for name in self._component_names("analyzer"):
            p = f"index.analysis.analyzer.{name}"
            typ = s.get_str(f"{p}.type", "custom")
            if typ != "custom" and typ in self.analyzers:
                self.analyzers[name] = self.analyzers[typ]
                continue
            tok_name = s.get_str(f"{p}.tokenizer", "standard")
            if tok_name not in self._tokenizers:
                raise IllegalArgumentException(
                    f"analyzer [{name}] must specify a known tokenizer, got [{tok_name}]"
                )
            filters = []
            for fn in s.get_list(f"{p}.filter", []):
                if fn not in self._filters:
                    raise IllegalArgumentException(f"Unknown filter [{fn}] for analyzer [{name}]")
                filters.append(self._filters[fn])
            char_filters = []
            for cn in s.get_list(f"{p}.char_filter", []):
                if cn not in self._char_filters:
                    raise IllegalArgumentException(
                        f"Unknown char_filter [{cn}] for analyzer [{name}]"
                    )
                char_filters.append(self._char_filters[cn])
            self.analyzers[name] = Analyzer(name, self._tokenizers[tok_name], filters, char_filters)

    def get(self, name: str) -> Analyzer:
        a = self.analyzers.get(name)
        if a is None:
            raise IllegalArgumentException(f"failed to find analyzer [{name}]")
        return a

    def default(self) -> Analyzer:
        return self.analyzers.get("default") or self.analyzers["standard"]
