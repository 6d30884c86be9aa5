"""Suggesters: term (edit distance), phrase (a bigram language model over
corrected candidates), completion (prefix over the completion field's
sorted inputs). Counterpart of ``elasticsearch_tpu/search/suggest.py``.

All three run on the host over every shard's searchable segments, as in
the JAX package, beside the query phase (``run_suggest``, called by the
index's coordinator for a ``suggest`` body section):

- ``term``: each analyzed token of the text against the field's term
  dictionary: candidates within ``max_edits`` edits (the same
  prefix and length filters), ranked by (distance, -doc freq); a token
  that is itself in the dictionary gets no options. The edit distances
  of all candidates of one length are computed together
  (``query_dsl._levenshtein_leq_many``, the JAX package's banded
  Levenshtein test for every candidate at once).
- ``phrase``: per token the token itself and the terms one edit away
  (unigram probability, halved for a correction), the best four a token;
  a beam of 16 over the combinations with at most ``max_errors``
  corrections, scored by Stupid Backoff (discount 0.4) over the field's
  bigram counts. The JAX package counts every pair of adjacent tokens of
  the field up front; the port counts only the pairs the beam asks for
  (``_bigram_count``): the occurrences of ``b`` right after ``a``, one
  ``searchsorted`` of ``a``'s position keys (``doc << 32 | position``)
  shifted by one into ``b``'s, per segment. A position holds one token
  (the analyzer's token index), so the counts are the JAX package's.
- ``completion``: the inputs that start with the prefix, from the field's
  ordinal column (``bisect`` over its sorted terms), each doc's weight
  from ``<field>#weight`` times the boosts of the queried contexts
  (``<field>#ctx.<name>``: a category matches by value, a geo context by
  geohash prefix at the queried precision), ranked by (-score, text).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import ParsingException
from elasticsearch_tpu_torch.search.query_dsl import _levenshtein_leq_many


def _edit_distances(cands: List[str], token: str, cap: int) -> np.ndarray:
    """Each candidate's edit distance to ``token``, ``cap + 1`` beyond
    ``cap`` (the JAX package's ``_edit_distance`` of each)."""
    out = np.full(len(cands), cap + 1, np.int64)
    for k in range(cap, -1, -1):
        out[_levenshtein_leq_many(cands, token, k)] = k
    return out


def _field_term_freqs(segments, field: str) -> Dict[str, int]:
    """Each term of ``field`` and its doc freq summed over the segments,
    in the order the segments first name them (a segment's terms and doc
    freqs are cached in its ``host_cache``)."""
    freqs: Dict[str, int] = {}
    for seg in segments:
        key = f"term_freqs.{field}"
        pairs = seg.host_cache.get(key)
        if pairs is None:
            terms = seg.terms_for_field(field)
            dfs = seg.term_doc_freq[[tid for _, tid in terms]].tolist() \
                if terms else []
            pairs = seg.host_cache[key] = list(zip(
                (t for t, _ in terms), dfs))
        for token, df in pairs:
            freqs[token] = freqs.get(token, 0) + df
    return freqs


def term_suggest(segments, field: str, text: str, analyzer,
                 max_edits: int = 2, size: int = 5,
                 min_word_length: int = 4,
                 prefix_length: int = 1) -> List[dict]:
    """Per-token spelling candidates ranked by (distance, -freq)."""
    freqs = _field_term_freqs(segments, field)
    out = []
    for tok in analyzer.analyze_tokens(text):
        token, start, end = tok
        exists = token in freqs
        cands = [
            c for c in freqs
            if c != token
            and not (len(token) >= min_word_length and prefix_length
                     and c[:prefix_length] != token[:prefix_length])
            and abs(len(c) - len(token)) <= max_edits]
        dist = _edit_distances(cands, token, max_edits)
        options: List[Tuple[int, int, str]] = sorted(
            (int(d), -freqs[c], c) for c, d in zip(cands, dist.tolist())
            if d <= max_edits)
        out.append({
            "text": token,
            "offset": start,
            "length": end - start,
            "options": [] if exists else [
                {"text": c, "score": round(1.0 - d / (max_edits + 1), 3),
                 "freq": -nf}
                for d, nf, c in options[:size]
            ],
        })
    return out


def _bigram_count(segments, field: str, a: str, b: str) -> int:
    """How often token ``b`` directly follows token ``a`` in ``field``,
    over the segments."""
    n = 0
    for seg in segments:
        ta, tb = seg.term_id(field, a), seg.term_id(field, b)
        if ta < 0 or tb < 0:
            continue
        ka, kb = seg.positions.term_keys(ta), seg.positions.term_keys(tb)
        if not len(ka) or not len(kb):
            continue
        # the shorter run searches the longer one
        if len(ka) <= len(kb):
            want, keys = ka + 1, kb
        else:
            want, keys = kb - 1, ka
        idx = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
        n += int((keys[idx] == want).sum())
    return n


def phrase_suggest(segments, field: str, text: str, analyzer,
                   size: int = 5, max_errors: float = 1.0) -> List[dict]:
    """Whole-phrase correction: per-token candidates (the token itself
    too), the best combinations scored by a bigram language model with
    Stupid Backoff smoothing (discount 0.4)."""
    freqs = _field_term_freqs(segments, field)
    bigrams: Dict[Tuple[str, str], int] = {}
    total = sum(freqs.values()) or 1
    tokens = [t for t, _, _ in analyzer.analyze_tokens(text)]
    if not tokens:
        return []
    vocab = list(freqs)
    per_token: List[List[Tuple[str, float]]] = []
    for tok in tokens:
        cands: List[Tuple[str, float]] = []
        if tok in freqs:
            cands.append((tok, freqs[tok] / total))
        near = _levenshtein_leq_many(vocab, tok, 1)
        for cand, ok in zip(vocab, near.tolist()):
            if ok and cand != tok:
                cands.append((cand, freqs[cand] / total * 0.5))
        if not cands:
            cands.append((tok, 1e-9))
        cands.sort(key=lambda cf: -cf[1])
        per_token.append(cands[:4])

    DISCOUNT = 0.4  # Stupid Backoff alpha

    def transition_p(prev: Optional[str], word: str,
                     unigram_p: float) -> float:
        if prev is None:
            return unigram_p
        bi = bigrams.get((prev, word))
        if bi is None:
            bi = bigrams[(prev, word)] = _bigram_count(segments, field,
                                                       prev, word)
        if bi > 0 and freqs.get(prev):
            return bi / freqs[prev]
        return DISCOUNT * unigram_p

    # a beam over the combinations, the corrections bounded
    max_err = (int(max_errors) if max_errors >= 1
               else max(1, int(max_errors * len(tokens))))
    beams: List[Tuple[float, List[str], int]] = [(1.0, [], 0)]
    for i, cands in enumerate(per_token):
        nxt = []
        for score, words, errs in beams:
            prev = words[-1] if words else None
            for cand, p in cands:
                e = errs + (cand != tokens[i])
                if e > max_err:
                    continue
                nxt.append((score * transition_p(prev, cand, p),
                            words + [cand], e))
        nxt.sort(key=lambda b: -b[0])
        beams = nxt[:16]
    options = []
    seen = set()
    for score, words, errs in beams:
        phrase = " ".join(words)
        if phrase in seen or errs == 0:
            continue
        seen.add(phrase)
        options.append({"text": phrase, "score": round(score, 9)})
        if len(options) >= size:
            break
    return [{
        "text": text,
        "offset": 0,
        "length": len(text),
        "options": options,
    }]


def _doc_context_values(seg, field: str, cname: str, local: int) -> List[str]:
    ccol = seg.ordinal_columns.get(f"{field}#ctx.{cname}")
    if ccol is None or not ccol.exists[local]:
        return []
    sel = ccol.flat_docs[: ccol.count] == local
    return [ccol.terms[o] for o in ccol.flat_ords[: ccol.count][sel]]


def _context_boost(seg, field: str, local: int, contexts: dict,
                   ctx_defs: dict) -> Optional[float]:
    """None: filtered out; else the multiplicative boost (a doc must match
    at least one value of every queried context; the boosts multiply the
    suggestion's weight)."""
    total_boost = 1.0
    for cname, wanted in contexts.items():
        cdef = ctx_defs.get(cname)
        if cdef is None:
            raise ParsingException(
                f"Unknown context name [{cname}], must be one of "
                f"{sorted(ctx_defs)}")
        have = _doc_context_values(seg, field, cname, local)
        if not isinstance(wanted, list):
            wanted = [wanted]
        is_geo = cdef.get("type", "category") == "geo"
        best = None
        for w in wanted:
            if is_geo:
                from elasticsearch_tpu_torch.utils.geohash import encode

                boost = 1.0
                precision = int(cdef.get("precision", 6))
                if isinstance(w, dict):
                    pt = w.get("context") or w
                    precision = int(w.get("precision", precision))
                    boost = float(w.get("boost", 1.0))
                else:
                    pt = w
                if isinstance(pt, dict):
                    want_prefix = encode(float(pt["lat"]), float(pt["lon"]),
                                         precision)
                elif isinstance(pt, str) and "," in pt:
                    lat, lon = pt.split(",", 1)
                    want_prefix = encode(float(lat), float(lon), precision)
                else:
                    want_prefix = str(pt)  # a raw geohash prefix
                if any(h.startswith(want_prefix) for h in have):
                    best = max(best or 0.0, boost)
            else:
                if isinstance(w, dict):
                    if "context" not in w:
                        raise ParsingException(
                            f"context query for [{cname}] requires [context]")
                    value = str(w["context"])
                    boost = float(w.get("boost", 1.0))
                else:
                    value, boost = str(w), 1.0
                if value in have:
                    best = max(best or 0.0, boost)
        if best is None:
            return None
        total_boost *= best
    return total_boost


def completion_suggest(segments, field: str, prefix: str, size: int = 5,
                       skip_duplicates: bool = False,
                       contexts: Optional[dict] = None,
                       ctx_defs: Optional[dict] = None) -> List[dict]:
    """Prefix completion over the indexed completion inputs (the field's
    ordinal column), weights from ``<field>#weight``, contexts from
    ``<field>#ctx.<name>``."""
    options = []
    seen = set()
    for seg in segments:
        col = seg.ordinal_columns.get(field)
        if col is None:
            continue
        wcol = seg.numeric_columns.get(f"{field}#weight")
        lo = bisect.bisect_left(col.terms, prefix)
        hi = bisect.bisect_left(col.terms, prefix + "\uffff")
        flat_ords = col.flat_ords[: col.count]
        flat_docs = col.flat_docs[: col.count]
        for o in range(lo, hi):
            term = col.terms[o]
            for local in flat_docs[flat_ords == o]:
                if not seg.live[local]:
                    continue
                weight = 1.0
                if wcol is not None and wcol.exists[local]:
                    weight = float(wcol.first_value[local])
                if contexts:
                    boost = _context_boost(seg, field, int(local), contexts,
                                           ctx_defs or {})
                    if boost is None:
                        continue
                    weight *= boost
                if skip_duplicates and term in seen:
                    continue
                seen.add(term)
                options.append({
                    "text": term,
                    "_id": seg.doc_ids[local],
                    "_score": weight,
                    "_source": seg.sources[local],
                })
    options.sort(key=lambda opt: (-opt["_score"], opt["text"]))
    return [{
        "text": prefix,
        "offset": 0,
        "length": len(prefix),
        "options": options[:size],
    }]


def run_suggest(suggest_body: dict, shards, mapper_service) -> dict:
    """The ``suggest`` section of a search body, over every shard's
    searchable segments."""
    out = {}
    global_text = suggest_body.get("text")
    segments = [
        seg for shard in shards.values()
        for seg in shard.engine.searchable_segments()
    ]
    for name, spec in suggest_body.items():
        if name == "text":
            continue
        text = spec.get("text") or spec.get("prefix") or global_text
        if "term" in spec:
            cfg = spec["term"]
            field = cfg["field"]
            analyzer = mapper_service.analyzers.get(
                getattr(mapper_service.field_type(field), "analyzer", None)
                or "standard")
            out[name] = term_suggest(
                segments, field, text, analyzer,
                max_edits=int(cfg.get("max_edits", 2)),
                size=int(cfg.get("size", 5)),
                min_word_length=int(cfg.get("min_word_length", 4)),
                prefix_length=int(cfg.get("prefix_length", 1)),
            )
        elif "phrase" in spec:
            cfg = spec["phrase"]
            field = cfg["field"]
            analyzer = mapper_service.analyzers.get(
                getattr(mapper_service.field_type(field), "analyzer", None)
                or "standard")
            out[name] = phrase_suggest(
                segments, field, text, analyzer,
                size=int(cfg.get("size", 5)),
                max_errors=float(cfg.get("max_errors", 1.0)),
            )
        elif "completion" in spec:
            cfg = spec["completion"]
            ft = mapper_service.field_type(cfg["field"])
            out[name] = completion_suggest(
                segments, cfg["field"], text,
                size=int(cfg.get("size", 5)),
                skip_duplicates=bool(cfg.get("skip_duplicates", False)),
                contexts=cfg.get("contexts"),
                ctx_defs=getattr(ft, "contexts", None) or {},
            )
        else:
            raise ParsingException(
                f"suggestion [{name}] must specify one of [term, phrase, "
                f"completion]")
    return out
