"""Reindex, update by query and delete by query.

Counterpart of ``elasticsearch_tpu/index/reindex.py``. Each run walks a
point-in-time snapshot of the source (``_scan_batches``): every shard's
segment set and live masks are pinned (``PinnedSegmentView``) before the
first batch, so the writes the run itself makes (or a concurrent writer's)
never reach the scan. The source query's plan runs once per segment on
the segment's device (``search/plan.py`` ``execute``: a ``match`` is the
tile kernel's dense form), and the match mask comes to the host once per
segment. The batches are written back through ``Node.bulk`` and
``Node.delete_doc``, so on a mesh index they take the delta append and
tombstone paths of the staging lifecycle. A painless ``script`` runs on
the host over a deep copy of each hit's ``_source``; ``ctx.op`` may make
a doc a ``noop``, a ``delete`` or a ``create``.

Each run is a registered task (``indices:data/write/reindex``,
``.../update/byquery``, ``.../delete/byquery``) whose ``status`` holds its
counts after every batch; a cancel stops it before the next batch.

What the scan stages for the host rung is the index's in the
device-memory ledger: a segment it found unstaged has its staging
released when the scan ends (only the base tables, where the mesh plane
had staged the kernel tables), and the pinned live tensors are registered
under a ``scan#N`` scope of the index for as long as the scan holds them,
so ``memory_allocated`` is back at its level when the call returns.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import time
from typing import Optional

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ScriptException,
)

DEFAULT_BATCH = 1000

_SCAN_SEQ = itertools.count(1)


def _compile_byquery_script(body: dict):
    """The by-query script hook: a painless script mutating
    ``ctx._source``, with ``ctx.op`` deciding each doc's fate (index,
    noop, delete, create). None when no script is given."""
    spec = body.get("script")
    if spec is None:
        return None
    from elasticsearch_tpu_torch.script.expression import compile_script

    script = compile_script(spec)
    if not hasattr(script, "run"):
        raise IllegalArgumentException(
            "by-query scripts must be painless (ctx mutation)")
    params = (spec.get("params") if isinstance(spec, dict) else None) or {}
    return script, params


def _apply_byquery_script(compiled, hit) -> str:
    """Run the script against one hit and return the resulting op. The
    hit's ``_source`` is deep-copied first: the scan hands out the
    segment's stored source dicts, and a script that mutates a nested
    object and then noops must not alter them. ``ctx._id`` and
    ``ctx._index`` rewrites propagate to the hit."""
    script, params = compiled
    ctx = {"_source": copy.deepcopy(hit["_source"]),
           "_index": hit["_index"], "_id": hit["_id"], "op": "index"}
    script.run({"ctx": ctx, "params": dict(params)})
    op = ctx.get("op", "index")
    if op not in ("index", "none", "noop", "delete", "create"):
        raise ScriptException(f"Operation type [{op}] not allowed")
    hit["_source"] = ctx["_source"]
    hit["_index"] = ctx.get("_index", hit["_index"])
    hit["_id"] = str(ctx.get("_id", hit["_id"]))
    return "none" if op == "noop" else op


def _scan_batches(node, index_expr: str, query: Optional[dict],
                  batch_size: int):
    """Yield batches of hits from a point-in-time snapshot of every
    shard's segments of the indices ``index_expr`` names. The whole
    segment set and its live masks are pinned before the first batch;
    the cursor is (shard, segment, local doc). Close the generator (or
    exhaust it) to release what the scan staged."""
    import numpy as np

    from elasticsearch_tpu_torch.common.memory import (
        KIND_LIVE_MASK,
        memory_accountant,
    )
    from elasticsearch_tpu_torch.index.segment import (
        PinnedSegmentView,
        tensor_bytes,
    )
    from elasticsearch_tpu_torch.search import plan as P
    from elasticsearch_tpu_torch.search.query_dsl import (
        ShardQueryContext,
        parse_query,
    )

    qb = parse_query(query or {"match_all": {}})
    snapshot = []  # (svc, ctx, [views]) pinned before any batch yields
    for svc in node.resolve_search_indices(index_expr):
        for sid in sorted(svc.shards):
            shard = svc.shards[sid]
            ctx = ShardQueryContext(svc.mapper_service, shard.engine)
            snapshot.append((svc, ctx, [
                PinnedSegmentView(s)
                for s in shard.engine.searchable_segments()]))
    scope = f"scan#{next(_SCAN_SEQ)}"
    acct = memory_accountant()
    # segments the scan found without their host-rung staging (all of
    # it, or the base tables beside another plane's kernel tables)
    unstaged, base_unstaged = [], []
    batch = []
    try:
        for svc, ctx, views in snapshot:
            for view in views:
                seg = view._seg
                if seg._device is None:
                    (base_unstaged if seg._kernel_tables
                     else unstaged).append(seg)
                dev = view.device_arrays()
                acct.register(svc.name, scope, KIND_LIVE_MASK,
                              f"{seg.name}.pin",
                              sum(tensor_bytes(t)
                                  for t in view._pin_device.values()),
                              plane="host", quiet=True)
                _, matched = P.execute(dev, qb.to_plan(ctx, view))
                matched = matched[: view.num_docs].cpu().numpy()
                matched &= view.live[: view.num_docs]
                for local in np.nonzero(matched)[0]:
                    batch.append({
                        "_index": svc.name,
                        "_id": view.doc_ids[local],
                        "_source": view.sources[local],
                    })
                    if len(batch) >= batch_size:
                        yield batch
                        batch = []
        if batch:
            yield batch
    finally:
        for svc, _ctx, views in snapshot:
            for view in views:
                view._pin_device.clear()
                view._merged.clear()
            acct.release_scope(svc.name, scope)
        for seg in unstaged:
            seg.release_device()
        for seg in base_unstaged:
            seg.release_base_arrays()
        snapshot.clear()


def _scan(node, index_expr, query, batch_size):
    """The scan's batches; closing them releases what the scan staged."""
    return contextlib.closing(
        _scan_batches(node, index_expr, query, batch_size))


def reindex(node, body: dict) -> dict:
    t0 = time.monotonic()
    source = body.get("source") or {}
    dest = body.get("dest") or {}
    src_index = source.get("index")
    dst_index = dest.get("index")
    if not src_index or not dst_index:
        raise IllegalArgumentException(
            "reindex requires source.index and dest.index")
    batch_size = int(source.get("size", DEFAULT_BATCH))
    max_docs = body.get("max_docs") or body.get("size")
    op_type = dest.get("op_type", "index")
    pipeline = dest.get("pipeline")
    compiled = _compile_byquery_script(body)
    task = node.tasks.register("indices:data/write/reindex",
                               f"reindex from [{src_index}] to "
                               f"[{dst_index}]")
    created = updated = total = noops = deleted = 0
    failures = []
    try:
        with _scan(node, src_index, source.get("query"),
                   batch_size) as batches:
            for hits in batches:
                task.ensure_not_cancelled()
                ops = []
                reached_max = False
                for h in hits:
                    if max_docs is not None and total >= int(max_docs):
                        reached_max = True
                        break
                    total += 1
                    dest_for_doc = dst_index
                    doc_action = "create" if op_type == "create" else "index"
                    if compiled is not None:
                        op = _apply_byquery_script(compiled, h)
                        if op == "create":
                            # a script's ctx.op = 'create' wins over
                            # dest.op_type: an existing dest doc conflicts
                            doc_action = "create"
                        if op == "none":
                            noops += 1
                            continue
                        if op == "delete":
                            # ctx.op = 'delete' removes the doc from the
                            # destination
                            try:
                                r = node.delete_doc(dst_index, h["_id"])
                                if r.get("found", True):
                                    deleted += 1
                            except Exception:  # noqa: BLE001 — absent
                                pass
                            continue
                        # a script may rewrite ctx._index (routing by doc)
                        if h["_index"] != src_index:
                            dest_for_doc = h["_index"]
                    ops.append((doc_action,
                                {"_index": dest_for_doc, "_id": h["_id"],
                                 "pipeline": pipeline},
                                h["_source"]))
                if ops:
                    resp = node.bulk(ops)
                    for item in resp["items"]:
                        r = next(iter(item.values()))
                        if "error" in r:
                            failures.append(r["error"])
                        elif r.get("result") == "created":
                            created += 1
                        else:
                            updated += 1
                task.status = {"total": total, "created": created,
                               "updated": updated, "noops": noops,
                               "deleted": deleted}
                if reached_max:
                    break
    finally:
        node.tasks.unregister(task)
    if dst_index in node.indices:
        node.indices[dst_index].refresh()
    return {
        "took": int((time.monotonic() - t0) * 1000),
        "timed_out": False,
        "total": total,
        "created": created,
        "updated": updated,
        "deleted": deleted,
        "batches": -(-total // batch_size) if total else 0,
        "version_conflicts": 0,
        "noops": noops,
        "retries": {"bulk": 0, "search": 0},
        "failures": failures,
    }


def update_by_query(node, index_expr: str, body: Optional[dict]) -> dict:
    """Re-index the matching docs in place; with a painless ``script``
    each doc's ``ctx._source`` is transformed and ``ctx.op`` may make the
    update a noop or a delete."""
    t0 = time.monotonic()
    body = body or {}
    compiled = _compile_byquery_script(body)
    updated = total = noops = deleted = 0
    task = node.tasks.register("indices:data/write/update/byquery",
                               f"update-by-query [{index_expr}]")
    try:
        with _scan(node, index_expr, body.get("query"),
                   DEFAULT_BATCH) as batches:
            for hits in batches:
                task.ensure_not_cancelled()
                ops = []
                for h in hits:
                    total += 1
                    if compiled is not None:
                        op = _apply_byquery_script(compiled, h)
                        if op == "none":
                            noops += 1
                            continue
                        if op == "delete":
                            r = node.delete_doc(h["_index"], h["_id"])
                            if r.get("found", True):
                                deleted += 1
                            continue
                    ops.append(("index",
                                {"_index": h["_index"], "_id": h["_id"]},
                                h["_source"]))
                if ops:
                    resp = node.bulk(ops)
                    updated += sum(1 for i in resp["items"]
                                   if "error" not in next(iter(i.values())))
                task.status = {"total": total, "updated": updated,
                               "noops": noops, "deleted": deleted}
    finally:
        node.tasks.unregister(task)
    for name in node.resolve_index_names(index_expr):
        node.indices[name].refresh()
    return {
        "took": int((time.monotonic() - t0) * 1000),
        "timed_out": False,
        "total": total,
        "updated": updated,
        "deleted": deleted,
        "version_conflicts": 0,
        "noops": noops,
        "failures": [],
    }


def delete_by_query(node, index_expr: str, body: Optional[dict]) -> dict:
    t0 = time.monotonic()
    body = body or {}
    if "query" not in body:
        raise IllegalArgumentException(
            "delete_by_query requires a query in the request body")
    deleted = total = 0
    task = node.tasks.register("indices:data/write/delete/byquery",
                               f"delete-by-query [{index_expr}]")
    try:
        with _scan(node, index_expr, body.get("query"),
                   DEFAULT_BATCH) as batches:
            for hits in batches:
                task.ensure_not_cancelled()
                total += len(hits)
                for h in hits:
                    r = node.delete_doc(h["_index"], h["_id"])
                    if r.get("found"):
                        deleted += 1
                task.status = {"total": total, "deleted": deleted}
    finally:
        node.tasks.unregister(task)
    for name in node.resolve_index_names(index_expr):
        node.indices[name].refresh()
    return {
        "took": int((time.monotonic() - t0) * 1000),
        "timed_out": False,
        "total": total,
        "deleted": deleted,
        "version_conflicts": 0,
        "noops": 0,
        "failures": [],
    }
