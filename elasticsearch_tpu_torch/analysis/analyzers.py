"""Text analysis: tokenizers, token filters, analyzers.

Counterpart of ``elasticsearch_tpu/analysis/analyzers.py``, cut to the
built-in analyzers (``standard``, ``simple``, ``whitespace``,
``keyword``). The standard analyzer runs the pure-Python path: Unicode
``\\w+`` runs, lowercased. The JAX package has a native ASCII fast path
that produces the same tokens, so the port does not load it. Custom
analysis chains from index settings are a later slice and raise.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

Token = tuple  # (text, start, end)

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


def lowercase_filter(tokens):
    return [(t.lower(), s, e) for t, s, e in tokens]


@dataclass
class Analyzer:
    name: str
    tokenizer: Callable[[str], List[Token]]
    token_filters: List[Callable] = field(default_factory=list)

    def analyze(self, text: str) -> List[str]:
        return [t for t, _, _ in self.analyze_tokens(text)]

    def analyze_tokens(self, text: str) -> List[Token]:
        if not isinstance(text, str):
            text = str(text)
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
    }


class AnalysisRegistry:
    """An index's named analyzers (the built-ins)."""

    def __init__(self, index_settings=None):
        if index_settings is not None:
            custom = [k for k in index_settings.keys()
                      if k.startswith("index.analysis.")]
            if custom:
                raise IllegalArgumentException(
                    f"custom analysis settings {sorted(custom)} are not "
                    f"supported by the PyTorch port yet")
        self.analyzers: Dict[str, Analyzer] = _builtin_analyzers()

    def get(self, name: str) -> Analyzer:
        a = self.analyzers.get(name)
        if a is None:
            raise IllegalArgumentException(f"failed to find analyzer [{name}]")
        return a
