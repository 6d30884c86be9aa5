"""Index sorting: segments store their documents sorted by
``index.sort.*`` (counterpart of ``elasticsearch_tpu/index/index_sort.py``,
copied but for its imports and a numeric sort key computed over arrays).

``parse_index_sort`` validates ``index.sort.field`` / ``order`` /
``missing`` / ``mode`` against the mapping at index creation.
``index_sort_permutation`` is the stable permutation the builder applies
at seal: a ``np.lexsort`` over one float key a sort field, a doc's
multi-valued field reduced by ``mode`` (min or max), strings ranked
first, ``desc`` negated, a missing value +-inf by ``_last`` / ``_first``.
Doc order is then sort order in every array, so a query sorted by a
prefix of the index sort (``query_sort_matches_index_sort``) takes the
first k matching docs of each segment and reports ``terminated_early``,
its total still exact (the host rung, ``search/service.py``; the mesh
plane declines such an index with ``index_sorted``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

# (field, order, missing, mode)
SortSpec = List[Tuple[str, str, str, str]]

_SORTABLE_TYPES = {
    "long", "integer", "short", "byte", "double", "float", "half_float",
    "scaled_float", "date", "boolean", "keyword", "ip",
}


def parse_index_sort(settings, mapper_service) -> Optional[SortSpec]:
    """Parse + validate ``index.sort.*`` settings against the mapping.

    Raises IllegalArgumentException for unknown fields or unsortable field
    types (IndexSortConfig.java: "unknown index sort field" /
    "docvalues not found for index sort field").
    """
    fields = settings.get_list("index.sort.field")
    if not fields:
        return None
    orders = settings.get_list("index.sort.order") or []
    missings = settings.get_list("index.sort.missing") or []
    modes = settings.get_list("index.sort.mode") or []

    def nth(lst, i, default):
        # option arrays must match the field array length exactly
        # (IndexSortConfig: a single-element list is NOT broadcast over
        # multiple sort fields)
        if not lst:
            return default
        if len(lst) != len(fields):
            raise IllegalArgumentException(
                f"index.sort option lists must match index.sort.field length "
                f"({len(fields)})")
        return lst[i]

    spec: SortSpec = []
    for i, field in enumerate(fields):
        order = str(nth(orders, i, "asc")).lower()
        if order not in ("asc", "desc"):
            raise IllegalArgumentException(f"Illegal sort order: {order}")
        missing = str(nth(missings, i, "_last"))
        if missing not in ("_last", "_first"):
            raise IllegalArgumentException(
                f"Illegal missing value: {missing}, must be one of [_last, _first]")
        mode = str(nth(modes, i, "min" if order == "asc" else "max")).lower()
        if mode not in ("min", "max"):
            raise IllegalArgumentException(
                f"Illegal sort mode: {mode}, must be one of [min, max]")
        ft = mapper_service.field_type(field)
        if ft is None:
            raise IllegalArgumentException(f"unknown index sort field:[{field}]")
        nested_paths = getattr(mapper_service.mapper, "nested_paths", {})
        if any(field == p or field.startswith(p + ".") for p in nested_paths):
            raise IllegalArgumentException(
                "index sorting on a field inside a nested object is not "
                f"supported: [{field}]")
        if ft.type_name not in _SORTABLE_TYPES:
            raise IllegalArgumentException(
                f"invalid index sort field:[{field}] of type [{ft.type_name}] "
                "(index sorting requires doc values)")
        if not getattr(ft, "doc_values", True):
            raise IllegalArgumentException(
                f"docvalues not found for index sort field:[{field}]")
        spec.append((field, order, missing, mode))
    return spec


_NUMERIC_SORT_TYPES = _SORTABLE_TYPES - {"keyword", "ip"}


def _query_key_mode(mapper_service, field: str, order: str) -> str:
    """The multi-value reduction the *query* sort path applies
    (service.py _sort_keys): numeric fields use min for asc / max for
    desc; ordinal (keyword/ip) keys always use the first (min) ordinal."""
    ft = mapper_service.field_type(field) if mapper_service else None
    if ft is not None and ft.type_name in _NUMERIC_SORT_TYPES:
        return "min" if order == "asc" else "max"
    return "min"


def query_sort_matches_index_sort(query_sort, index_sort: Optional[SortSpec],
                                  mapper_service=None) -> bool:
    """True when the query's sort is a prefix of the index sort — the
    early-termination eligibility check (QueryPhase.java:107
    canEarlyTerminate, which requires full SortField equality).

    Field + order must match; the query's missing placement must agree
    with the index sort's (custom numeric missing values disqualify); and
    the index sort's multi-value mode must equal the reduction the query
    sort path applies, else segment doc order can disagree with the
    cross-segment merge keys on multi-valued docs.
    """
    if not index_sort or not query_sort:
        return False
    if len(query_sort) > len(index_sort):
        return False
    for (qf, qorder, qmissing), (sf, sorder, smissing, smode) in zip(
            query_sort, index_sort):
        if qf != sf or qorder != sorder:
            return False
        q_missing = qmissing if qmissing is not None else "_last"
        if q_missing != smissing:
            return False
        if smode != _query_key_mode(mapper_service, sf, sorder):
            return False
    return True


def index_sort_permutation(builder, spec: SortSpec) -> Optional[np.ndarray]:
    """Compute the doc permutation (new order -> old doc) for a sealed
    builder. Stable: equal keys keep insertion (seqno) order."""
    n = builder.num_docs
    if n <= 1:
        return None
    lex_keys = []
    for field, order, missing, mode in reversed(spec):  # lexsort: last = primary
        fill = np.inf if missing == "_last" else -np.inf
        vals = np.full(n, np.nan, np.float64)
        have = np.zeros(n, bool)
        numeric = builder.numeric_values.get(field)
        if numeric is not None:
            docs, values = _numeric_pairs(numeric)
            if np.isnan(values).any():
                # the order-dependent min / max of NaNs: value by value
                for doc, v in zip(docs.tolist(), values.tolist()):
                    if not have[doc]:
                        vals[doc] = v
                        have[doc] = True
                    else:
                        vals[doc] = (min(vals[doc], v) if mode == "min"
                                     else max(vals[doc], v))
            else:
                # each doc's min or max over its values at once
                acc = np.full(n, np.inf if mode == "min" else -np.inf)
                (np.minimum if mode == "min" else np.maximum).at(
                    acc, docs, values)
                have[docs] = True
                vals[have] = acc[have]
        else:
            strings = builder.string_values.get(field) or []
            # rank strings so the float lexsort key preserves their order
            per_doc: dict = {}
            for doc, s in strings:
                cur = per_doc.get(doc)
                if cur is None:
                    per_doc[doc] = s
                else:
                    per_doc[doc] = min(cur, s) if mode == "min" else max(cur, s)
            rank = {s: i for i, s in enumerate(sorted(set(per_doc.values())))}
            for doc, s in per_doc.items():
                vals[doc] = float(rank[s])
                have[doc] = True
        oriented = np.where(have, -vals if order == "desc" else vals, fill)
        lex_keys.append(oriented)
    return np.lexsort(lex_keys)


def _numeric_pairs(pairs):
    """(docs int64, values float64) of a builder's (doc, value) pairs, or
    of a column given as those two arrays already."""
    if isinstance(pairs, tuple):
        return pairs
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    docs, values = zip(*pairs)
    return (np.asarray(docs, np.int64),
            np.asarray([float(v) for v in values], np.float64))

