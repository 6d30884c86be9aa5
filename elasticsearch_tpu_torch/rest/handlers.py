"""All REST handlers, over the PyTorch port's ``Node``.

Counterpart of ``elasticsearch_tpu/rest/handlers.py``. ``register_all``
registers the JAX package's route table in full, pair for pair and in the
same order, so route specificity and 405 answers behave alike. A route
whose Node API the port lacks answers ``_unported``: a 400
``illegal_argument_exception`` saying the route is not supported by the
port yet (no route is dropped). Ported here: ``GET /`` and ``HEAD /``,
document CRUD (index, create, auto-id, get, head, ``_source``, delete;
``version``, ``op_type``, ``routing``, the legacy ``parent`` (the routing
of a ``_parent``-mapped index, required there), ``refresh``, ``_source``
filtering, GET's ``stored_fields`` (``_parent`` too), the typed-path
deprecation warning), ``_update`` (``version`` with the internal
``version_type`` only, ``routing`` and ``parent``, ``refresh``, the
``get`` section for ``_source`` and ``fields``), ``_mget`` (``realtime``,
``refresh``, ``stored_fields``), ``_bulk`` (index, create, update,
delete; ``parent``),
``_search`` with the URI parameters (``?scroll=`` opens a point-in-time
scroll; ``timeout``, ``allow_partial_search_results`` and
``track_total_hits`` go into the body) over an index expression (names,
wildcards, comma lists, ``_all``), ``_search/scroll`` (next page,
clear), ``_count``, ``_msearch``, ``_explain`` (four routes: ``?q=``,
the ``_source`` parameters, the per-term BM25 details), ``_validate/query``
(``?explain``), ``_refresh``, ``_flush``, ``_flush/synced``,
``_forcemerge``, index create/delete/get/head, ``_mapping``,
``_settings``, ``_analyze`` over the built-in analyzers, ``_cluster/health`` and the cat
tables ``indices``, ``count``, ``health``, ``nodes``, ``master``,
``thread_pool`` and the empty ones. Handlers are (node, request) ->
(status, payload); the cat API returns text tables unless
``?format=json``.
"""

from __future__ import annotations

import fnmatch
import time
from typing import List, Tuple

import torch

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common.deprecation import DeprecationLogger
from elasticsearch_tpu_torch.common.errors import (
    ActionRequestValidationException,
    IllegalArgumentException,
    IndexNotFoundException,
    ResourceNotFoundException,
    RoutingMissingException,
    VersionConflictEngineException,
)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.search.service import filter_source
from elasticsearch_tpu_torch.version import __version__

_DEPRECATION = DeprecationLogger("rest.typed_api")


def register_all(c) -> None:
    r = c.register
    # --- root ---
    r("GET", "/", _root)
    r("HEAD", "/", lambda n, q: (200, {}))

    # --- document CRUD ---
    r("PUT", "/{index}/_doc/{id}", _index_doc)
    r("POST", "/{index}/_doc/{id}", _index_doc)
    r("POST", "/{index}/_doc", _index_doc_auto_id)
    r("POST", "/{index}/{type}", _index_doc_auto_id)
    r("GET", "/{index}/_doc/{id}", _get_doc)
    r("HEAD", "/{index}/_doc/{id}", _head_doc)
    r("DELETE", "/{index}/_doc/{id}", _delete_doc)
    r("POST", "/{index}/_update/{id}", _update_doc)
    r("GET", "/{index}/_source/{id}", _get_source)
    r("PUT", "/{index}/{type}/{id}", _index_doc)
    r("POST", "/{index}/{type}/{id}", _index_doc)
    r("GET", "/{index}/{type}/{id}", _get_doc)
    r("HEAD", "/{index}/{type}/{id}", _head_doc)
    r("DELETE", "/{index}/{type}/{id}", _delete_doc)
    r("POST", "/{index}/{type}/{id}/_update", _update_doc)
    r("PUT", "/{index}/{type}/{id}/_create", _create_doc)
    r("POST", "/{index}/{type}/{id}/_create", _create_doc)
    r("PUT", "/{index}/_create/{id}", _create_doc)
    r("POST", "/{index}/_create/{id}", _create_doc)
    r("GET", "/{index}/{type}/{id}/_explain", _explain)
    r("POST", "/{index}/{type}/{id}/_explain", _explain)
    r("GET", "/{index}/{type}/{id}/_source", _get_source)
    r("POST", "/_mget", _mget)
    r("POST", "/{index}/_mget", _mget)
    r("POST", "/{index}/{type}/_mget", _mget)
    r("POST", "/{index}/_doc/_mget", _mget)
    r("GET", "/_mget", _mget)
    r("GET", "/{index}/{type}/_mget", _mget)
    r("GET", "/{index}/_doc/_mget", _mget)

    # --- bulk ---
    r("POST", "/_bulk", _bulk)
    r("PUT", "/_bulk", _bulk)
    r("POST", "/{index}/_bulk", _bulk)

    # --- search family (typed 6.x forms included) ---
    r("GET", "/{index}/{type}/_search", _search)
    r("POST", "/{index}/{type}/_search", _search)
    r("GET", "/{index}/{type}/_count", _count)
    r("POST", "/{index}/{type}/_count", _count)
    r("GET", "/_search", _search)
    r("POST", "/_search", _search)
    r("GET", "/{index}/_search", _search)
    r("POST", "/{index}/_search", _search)
    r("POST", "/_search/scroll", _scroll)
    r("GET", "/_search/scroll", _scroll)
    r("POST", "/_search/scroll/{scroll_id}", _scroll)
    r("GET", "/_search/scroll/{scroll_id}", _scroll)
    r("DELETE", "/_search/scroll", _clear_scroll)
    r("DELETE", "/_search/scroll/{scroll_id}", _clear_scroll)
    r("POST", "/_msearch", _msearch)
    r("GET", "/_msearch", _msearch)
    r("POST", "/{index}/_msearch", _msearch)
    r("GET", "/_count", _count)
    r("POST", "/_count", _count)
    r("GET", "/{index}/_count", _count)
    r("POST", "/{index}/_count", _count)
    r("GET", "/{index}/_validate/query", _validate_query)
    r("POST", "/{index}/_validate/query", _validate_query)
    r("GET", "/_field_caps", _unported)
    r("POST", "/_field_caps", _unported)
    r("GET", "/{index}/_field_caps", _unported)
    r("POST", "/{index}/_field_caps", _unported)
    r("GET", "/{index}/_explain/{id}", _explain)
    r("POST", "/{index}/_explain/{id}", _explain)

    # --- templates / termvectors / rollover / shrink / hot_threads ---
    r("GET", "/_search/template", _unported)
    r("POST", "/_search/template", _unported)
    r("GET", "/{index}/_search/template", _unported)
    r("POST", "/{index}/_search/template", _unported)
    r("GET", "/_render/template", _unported)
    r("POST", "/_render/template", _unported)
    r("GET", "/{index}/_termvectors/{id}", _unported)
    r("POST", "/{index}/_termvectors/{id}", _unported)
    r("GET", "/{index}/{type}/{id}/_termvectors", _unported)
    r("POST", "/{index}/_rollover", _unported)
    r("POST", "/{index}/_rollover/{new_index}", _unported)
    r("POST", "/{index}/_shrink/{target}", _unported)
    r("PUT", "/{index}/_shrink/{target}", _unported)
    r("GET", "/_nodes/hot_threads", _unported)
    r("GET", "/_nodes/{node_id}/hot_threads", _unported)
    r("POST", "/_nodes/_local/_drain", _unported)
    r("DELETE", "/_nodes/_local/_drain", _unported)

    # --- reindex family ---
    r("POST", "/_reindex", _unported)
    r("POST", "/{index}/_update_by_query", _unported)
    r("POST", "/{index}/_delete_by_query", _unported)

    # --- index admin ---
    r("PUT", "/{index}", _create_index)
    r("DELETE", "/{index}", _delete_index)
    r("GET", "/{index}", _get_index)
    r("HEAD", "/{index}", _head_index)
    r("POST", "/{index}/_open", _unported)
    r("POST", "/{index}/_close", _unported)
    r("POST", "/{index}/_refresh", _refresh)
    r("GET", "/{index}/_refresh", _refresh)
    r("POST", "/_refresh", _refresh)
    r("POST", "/{index}/_flush", _flush)
    r("GET", "/{index}/_flush", _flush)
    r("POST", "/_flush", _flush)
    r("POST", "/{index}/_flush/synced", _flush_synced)
    r("POST", "/_flush/synced", _flush_synced)
    r("GET", "/{index}/_flush/synced", _flush_synced)
    r("POST", "/{index}/_forcemerge", _forcemerge)
    r("POST", "/_forcemerge", _forcemerge)
    r("GET", "/{index}/_stats", _unported)
    r("GET", "/_stats", _unported)
    r("GET", "/{index}/_stats/{metric}", _unported)
    r("GET", "/_stats/{metric}", _unported)
    r("GET", "/{index}/_segments", _unported)
    r("GET", "/_segments", _unported)
    r("PUT", "/{index}/_mapping", _unported)
    r("PUT", "/{index}/_mapping/{type}", _unported)
    r("POST", "/{index}/_mapping", _unported)
    r("GET", "/{index}/_mapping", _get_mapping)
    r("GET", "/_mapping", _get_mapping)
    r("GET", "/{index}/_mapping/{type}", _get_mapping)
    r("PUT", "/{index}/_settings", _unported)
    r("PUT", "/_settings", _unported)
    r("GET", "/{index}/_settings", _get_index_settings)
    r("GET", "/_settings", _get_index_settings)
    r("GET", "/{index}/_settings/{setting}", _get_index_settings)
    r("GET", "/_settings/{setting}", _get_index_settings)
    r("GET", "/_analyze", _analyze)
    r("POST", "/_analyze", _analyze)
    r("GET", "/{index}/_analyze", _analyze)
    r("POST", "/{index}/_analyze", _analyze)
    r("POST", "/_aliases", _unported)
    r("GET", "/_alias", _unported)
    r("GET", "/_alias/{name}", _unported)
    r("GET", "/{index}/_alias", _unported)
    r("GET", "/{index}/_alias/{name}", _unported)
    r("PUT", "/{index}/_alias/{name}", _unported)
    r("DELETE", "/{index}/_alias/{name}", _unported)
    r("HEAD", "/_alias/{name}", _unported)
    r("HEAD", "/{index}/_alias/{name}", _unported)
    r("PUT", "/_template/{name}", _unported)
    r("GET", "/_template", _unported)
    r("GET", "/_template/{name}", _unported)
    r("DELETE", "/_template/{name}", _unported)
    r("HEAD", "/_template/{name}", _unported)
    r("POST", "/{index}/_cache/clear", _unported)
    r("POST", "/_cache/clear", _unported)

    # --- cluster admin ---
    r("GET", "/_cluster/health", lambda n, q: (200, n.health()))
    r("GET", "/_cluster/health/{index}", lambda n, q: (200, n.health()))
    r("GET", "/_cluster/state", _unported)
    r("GET", "/_cluster/state/{metrics}", _unported)
    r("GET", "/_cluster/stats", _unported)
    r("GET", "/_cluster/settings", _unported)
    r("PUT", "/_cluster/settings", _unported)
    r("POST", "/_cluster/reroute", _unported)
    r("GET", "/_cluster/allocation/explain", _unported)
    r("GET", "/_nodes", _unported)
    r("GET", "/_nodes/stats", _unported)
    r("GET", "/_nodes/stats/{metric}", _unported)
    r("GET", "/_nodes/stats/{metric}/{index_metric}", _unported)
    r("GET", "/_nodes/{node_id}", _unported)
    r("GET", "/_nodes/{node_id}/stats", _unported)
    r("GET", "/_nodes/{node_id}/stats/{metric}", _unported)
    r("GET", "/_nodes/{node_id}/stats/{metric}/{index_metric}", _unported)
    r("GET", "/_remote/info", _unported)

    # --- tasks ---
    r("GET", "/_tasks", _unported)
    r("GET", "/_tasks/{task_id}", _unported)
    r("POST", "/_tasks/{task_id}/_cancel", _unported)

    # --- scripts ---
    r("PUT", "/_scripts/{id}", _unported)
    r("GET", "/_scripts/{id}", _unported)
    r("DELETE", "/_scripts/{id}", _unported)

    # --- ingest ---
    r("PUT", "/_ingest/pipeline/{id}", _unported)
    r("GET", "/_ingest/pipeline", _unported)
    r("GET", "/_ingest/pipeline/{id}", _unported)
    r("DELETE", "/_ingest/pipeline/{id}", _unported)
    r("POST", "/_ingest/pipeline/_simulate", _unported)
    r("GET", "/_ingest/pipeline/_simulate", _unported)
    r("POST", "/_ingest/pipeline/{id}/_simulate", _unported)

    # --- snapshots ---
    r("PUT", "/_snapshot/{repo}", _unported)
    r("POST", "/_snapshot/{repo}", _unported)
    r("GET", "/_snapshot", _unported)
    r("GET", "/_snapshot/{repo}", _unported)
    r("DELETE", "/_snapshot/{repo}", _unported)
    r("PUT", "/_snapshot/{repo}/{snapshot}", _unported)
    r("GET", "/_snapshot/{repo}/_status", _unported)
    r("GET", "/_snapshot/{repo}/{snapshot}/_status", _unported)
    r("GET", "/_snapshot/{repo}/{snapshot}", _unported)
    r("DELETE", "/_snapshot/{repo}/{snapshot}", _unported)
    r("POST", "/_snapshot/{repo}/{snapshot}/_restore", _unported)
    r("POST", "/_snapshot/{repo}/_verify", _unported)

    # --- cat API (rest/action/cat/, 22 handlers in the reference) ---
    r("GET", "/_cat", _cat_help)
    r("GET", "/_cat/indices", _cat_indices)
    r("GET", "/_cat/indices/{index}", _cat_indices)
    r("GET", "/_cat/health", _cat_health)
    r("GET", "/_cat/nodes", _cat_nodes)
    r("GET", "/_cat/shards", _unported)
    r("GET", "/_cat/shards/{index}", _unported)
    r("GET", "/_cat/staging", _cat_staging)
    r("GET", "/_cat/count", _cat_count)
    r("GET", "/_cat/count/{index}", _cat_count)
    r("GET", "/_cat/aliases", _unported)
    r("GET", "/_cat/aliases/{name}", _unported)
    r("GET", "/_cat/templates", _unported)
    r("GET", "/_cat/templates/{name}", _unported)
    r("GET", "/_cat/master", _cat_master)
    r("GET", "/_cat/segments", _unported)
    r("GET", "/_cat/plugins", _unported)
    r("GET", "/_cat/tasks", _unported)
    r("GET", "/_cat/pending_tasks", lambda n, q: _cat_table(
        q, [], ["insertOrder", "timeInQueue", "priority", "source"]))
    r("GET", "/_cat/allocation", _unported)
    r("GET", "/_cat/recovery", _unported)
    r("GET", "/_cat/thread_pool", _cat_thread_pool)
    r("GET", "/_cat/fielddata", lambda n, q: _cat_table(
        q, [], ["id", "host", "ip", "node", "field", "size"]))
    r("GET", "/_cat/fielddata/{fields}", lambda n, q: _cat_table(
        q, [], ["id", "host", "ip", "node", "field", "size"]))
    r("GET", "/_cat/nodeattrs", lambda n, q: _cat_table(
        q, [], ["node", "id", "pid", "host", "ip", "port", "attr", "value"]))
    r("GET", "/_cat/repositories", _unported)
    r("GET", "/_cat/snapshots/{repo}", _unported)


def _unported(node, req):
    """Every route whose Node API the port lacks."""
    raise IllegalArgumentException(
        f"[{req.method} {req.path}] is not supported by the PyTorch port yet")


def _not_supported(what: str) -> IllegalArgumentException:
    return IllegalArgumentException(
        f"{what} is not supported by the PyTorch port yet")


# ---------------------------------------------------------------------------
# Root / info
# ---------------------------------------------------------------------------


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "the CPU"


def _root(node, req):
    return 200, {
        "name": node.node_name,
        "cluster_name": node.cluster_name,
        "cluster_uuid": node.node_id,
        "version": {
            "number": __version__,
            "lucene_version": "tpu-block-packed-1",
            "build_flavor": f"torch-{node.device.type}",
        },
        "tagline": f"You Know, for Search (on {_device_name(node.device)})",
    }


# ---------------------------------------------------------------------------
# Document CRUD
# ---------------------------------------------------------------------------


def _typed_api_warning(req) -> None:
    """Custom type names in document API paths are deprecated (6.x
    single-type enforcement)."""
    t = req.param("type")
    if t is not None and t != "_doc":
        _DEPRECATION.deprecated(
            "specifying a custom type in document API paths is deprecated; "
            "use /{index}/_doc/{id} instead")


def _doc_type_of(node, index):
    svc = node.indices.get(index)
    return svc.doc_type if svc is not None else "_doc"


def _echo_type(req, r, node=None):
    """6.x typed-path compatibility: document API responses echo the type
    from the request path; type `_all` (or none, given the node) resolves
    to the index's own type."""
    t = req.param("type")
    if (t is None or t == "_all") and node is not None:
        t = _doc_type_of(node, req.param("index"))
    r["_type"] = t or "_doc"
    return r


def _write_shards_header(node, req, r):
    """Single-doc write responses carry the replication-group header:
    total = 1 primary + replicas."""
    if "_shards" not in r:
        svc = node.indices.get(req.param("index"))
        total = 1 + svc.num_replicas if svc is not None else 1
        r["_shards"] = {"total": total, "successful": 1, "failed": 0}
    return r


def _forced_refresh(req, r):
    if req.param("refresh") in ("", "true", True):
        r["forced_refresh"] = True
    return r


def _validate_type_param(req):
    """Type names can't start with '_' (only the canonical _doc)."""
    t = req.param("type")
    if t is not None and t.startswith("_") and t != "_doc":
        raise IllegalArgumentException(
            f"Document mapping type name can't start with '_', "
            f"found: [{t}]")


def _record_doc_type(node, req):
    """6.x first-write-wins type naming: indexing through a typed path
    onto an index whose type is still the default records the custom
    name, so later responses echo it."""
    t = req.param("type")
    if t in (None, "_doc", "_all"):
        return
    svc = node.indices.get(req.param("index"))
    if svc is not None and svc.doc_type == "_doc":
        svc.doc_type = t


def _parent_routing(node, req):
    """(effective routing, parent): the legacy ``parent`` param acts as the
    routing, and a ``_parent``-mapped index requires one of the two on
    every single-doc op (``RoutingMissingException``). Ingest pipelines
    are not ported."""
    if req.param("pipeline") is not None:
        raise _not_supported("ingest pipelines")
    routing = req.param("routing")
    parent = req.param("parent")
    eff = routing if routing is not None else parent
    if eff is None:
        svc = node.indices.get(req.param("index"))
        if svc is not None and svc.mapper_service.parent_type is not None:
            raise RoutingMissingException(svc.doc_type or "_doc",
                                          req.param("id") or "")
    return eff, parent


def _routing(node, req):
    return _parent_routing(node, req)[0]


def _version_kw(req) -> dict:
    if req.param("version") is None:
        return {}
    if req.param("version_type", "internal") != "internal":
        raise _not_supported(
            f"version_type [{req.param('version_type')}]")
    return {"version": int(req.param("version"))}


def _index_doc(node, req, force_create: bool = False):
    _validate_type_param(req)
    _typed_api_warning(req)
    body = req.json_body()
    if body is None:
        raise ActionRequestValidationException("request body is required")
    kw = _version_kw(req)
    if force_create or req.param("op_type") == "create":
        kw["op_type"] = "create"
    routing, parent = _parent_routing(node, req)
    r = node.index_doc(req.param("index"), req.param("id"), body,
                       routing=routing, refresh=req.param("refresh"),
                       wait_for_active_shards=req.param(
                           "wait_for_active_shards"), parent=parent, **kw)
    _record_doc_type(node, req)
    _echo_type(req, _forced_refresh(req, _write_shards_header(node, req, r)))
    return (201 if r.get("result") == "created" else 200), r


def _create_doc(node, req):
    return _index_doc(node, req, force_create=True)


def _index_doc_auto_id(node, req):
    if req.param("type") is not None:
        # POST /{index}/{type} would otherwise swallow a typoed
        # /{index}/_endpoint POST as a document
        _validate_type_param(req)
        _typed_api_warning(req)
    body = req.json_body()
    if body is None:
        raise ActionRequestValidationException(
            "Validation Failed: 1: source is missing;")
    routing, parent = _parent_routing(node, req)
    r = node.index_doc(req.param("index"), None, body,
                       routing=routing, refresh=req.param("refresh"),
                       wait_for_active_shards=req.param(
                           "wait_for_active_shards"), parent=parent)
    _record_doc_type(node, req)
    _echo_type(req, _forced_refresh(req, _write_shards_header(node, req, r)))
    return 201, r


def _apply_source_filtering(req, r):
    """_source=false / _source=a,b / _source_include(s) /
    _source_exclude(s) on single-doc GETs: the same filter_source the
    search fetch phase uses."""
    if "_source" not in r:
        return r
    src_param = req.param("_source")
    includes = req.param("_source_includes") or req.param("_source_include")
    excludes = req.param("_source_excludes") or req.param("_source_exclude")
    if src_param is None and includes is None and excludes is None:
        return r
    if src_param is not None and src_param.lower() == "false":
        del r["_source"]
        return r
    if src_param is not None and src_param.lower() != "true":
        includes = src_param
    inc = [f.strip() for f in includes.split(",")] if includes else None
    exc = [f.strip() for f in excludes.split(",")] if excludes else None
    r["_source"] = filter_source(r["_source"], inc, exc)
    return r


def _get_kw(req) -> dict:
    rt = req.param("realtime")
    return {"realtime": not (rt is not None and rt.lower() == "false"),
            "refresh": req.param("refresh")}


def _get_doc(node, req):
    _typed_api_warning(req)
    r = node.get_doc(req.param("index"), req.param("id"),
                     _routing(node, req), **_get_kw(req))
    if r["found"] and req.param("version") is not None:
        # reading a stale version conflicts: only equality passes
        try:
            want = int(req.param("version"))
        except ValueError:
            raise IllegalArgumentException(
                f"failed to parse version [{req.param('version')}]") from None
        if want != r["_version"]:
            raise VersionConflictEngineException(
                req.param("id"), r["_version"], want)
    stored = req.param("stored_fields")
    if r["found"] and stored is not None:
        _stored_fields(node, req, r, [f for f in str(stored).split(",") if f])
    _echo_type(req, _apply_source_filtering(req, r), node)
    return (200 if r["found"] else 404), r


def _stored_fields(node, req, r: dict, wanted: List[str]) -> None:
    """GET's ``stored_fields``: ``_parent`` from the index's registry,
    ``_routing`` as stored, and mapped fields with ``store: true`` from
    the source under ``fields``; the source only when ``_source`` is
    asked for."""
    src = r.get("_source") or {}
    svc = node.index_service(req.param("index"))
    fields = {}
    for f in wanted:
        if f in ("_source", "_routing"):
            continue
        if f == "_parent":
            p = svc.parents.get(str(req.param("id")))
            if p is not None:
                r["_parent"] = p
            continue
        ft = svc.mapper_service.field_type(f)
        if ft is None or not ft.params.get("store", False) or f not in src:
            continue
        v = src[f]
        fields[f] = v if isinstance(v, list) else [v]
    if fields:
        r["fields"] = fields
    if "_source" not in wanted:
        r.pop("_source", None)


def _head_doc(node, req):
    r = node.get_doc(req.param("index"), req.param("id"), _routing(node, req),
                     **_get_kw(req))
    return (200 if r["found"] else 404), {}


def _get_source(node, req):
    r = node.get_doc(req.param("index"), req.param("id"), _routing(node, req),
                     **_get_kw(req))
    if not r["found"]:
        return 404, {}
    _apply_source_filtering(req, r)
    return 200, r.get("_source", {})


def _delete_doc(node, req):
    _typed_api_warning(req)
    r = node.delete_doc(req.param("index"), req.param("id"),
                        routing=_routing(node, req), refresh=req.param("refresh"),
                        **_version_kw(req))
    _echo_type(req, _forced_refresh(req, _write_shards_header(node, req, r)))
    return (200 if r.get("found") else 404), r


def _update_doc(node, req):
    _typed_api_warning(req)
    routing, parent = _parent_routing(node, req)
    version = req.param("version")
    if version is not None and req.param(
            "version_type", "internal") != "internal":
        # UpdateRequest.validate(): only internal versioning applies
        raise ActionRequestValidationException(
            "Validation Failed: 1: version type [force/external] is not "
            "supported by the update API;")
    r = node.update_doc(req.param("index"), req.param("id"), req.json_body({}),
                        routing=routing, refresh=req.param("refresh"),
                        version=int(version) if version is not None else None)
    if parent is not None and r.get("_id") is not None:
        svc = node.indices.get(req.param("index"))
        if svc is not None:
            svc.parents[str(r["_id"])] = str(parent)
    _echo_type(req, _forced_refresh(req, _write_shards_header(node, req, r)))
    # the "get" section: the updated source (filtered) and fields
    src_param = req.param("_source")
    want_get = (req.param("fields")
                or (src_param is not None and src_param.lower() != "false"))
    if want_get and r.get("result") != "noop":
        g = node.get_doc(req.param("index"), req.param("id"),
                         req.param("routing"))
        if g.get("found"):
            src = g["_source"]
            if src_param and src_param.lower() != "true":
                src = filter_source(src, src_param.split(","), None)
            get_sec = {"found": True, "_source": src}
            if req.param("fields"):
                want = req.param("fields").split(",")
                get_sec["fields"] = {f: [g["_source"][f]]
                                     for f in want if f in g["_source"]}
            r["get"] = get_sec
    return 200, r


def _mget(node, req):
    rp = _get_kw(req)
    stored = req.param("stored_fields")
    return 200, node.mget(req.json_body({}), req.param("index"),
                          req.param("type"), realtime=rp["realtime"],
                          refresh=rp["refresh"],
                          stored_fields=([f for f in str(stored).split(",")
                                          if f] if stored else None))


def _bulk(node, req):
    if req.param("pipeline") is not None:
        raise _not_supported("ingest pipelines")
    lines = req.ndjson_lines()
    if not lines:
        raise ActionRequestValidationException("request body is required")
    default_index = req.param("index")
    ops = []
    i = 0
    while i < len(lines):
        action_line = lines[i]
        if not action_line:
            raise IllegalArgumentException(
                f"Malformed action/metadata line [{i + 1}], expected "
                f"FIELD_NAME but found [END_OBJECT]")
        ((action, meta),) = action_line.items()
        meta = dict(meta or {})
        meta.setdefault("_index", default_index)
        i += 1
        if action in ("index", "create", "update"):
            if i >= len(lines):
                raise ActionRequestValidationException(
                    "Validation Failed: 1: no requests added;")
            ops.append((action, meta, lines[i]))
            i += 1
        else:
            ops.append((action, meta, None))
    return 200, node.bulk(ops, refresh=req.param("refresh"))


# ---------------------------------------------------------------------------
# Search family
# ---------------------------------------------------------------------------


def _search_body(req):
    body = req.json_body({}) or {}
    # URI search: ?q= (with df, default_operator, analyzer, lenient) is a
    # query_string query
    q = req.param("q")
    if q is not None:
        qs = {"query": q}
        for name, key in (("df", "default_field"),
                          ("default_operator", "default_operator"),
                          ("analyzer", "analyzer")):
            if req.param(name) is not None:
                qs[key] = req.param(name)
        if req.param("lenient") is not None:
            qs["lenient"] = req.bool_param("lenient")
        body["query"] = {"query_string": qs}
    for p in ("size", "from"):
        if req.param(p) is not None:
            body[p] = int(req.param(p))
    if req.param("timeout") is not None:
        body["timeout"] = req.param("timeout")
    if req.param("allow_partial_search_results") is not None:
        body["allow_partial_search_results"] = req.bool_param(
            "allow_partial_search_results")
    if req.param("track_total_hits") is not None:
        # boolean OR the integer-threshold form; an explicit false is the
        # default, so the key is simply not set
        raw = req.param("track_total_hits")
        try:
            body["track_total_hits"] = int(raw)
        except (TypeError, ValueError):
            if req.bool_param("track_total_hits"):
                body["track_total_hits"] = True
    if req.param("sort") is not None:
        sort = []
        for part in req.param("sort").split(","):
            if ":" in part:
                f, o = part.split(":", 1)
                sort.append({f: o})
            else:
                sort.append(part)
        body["sort"] = sort
    if req.param("_source") is not None:
        v = req.param("_source")
        body["_source"] = False if v == "false" else (True if v == "true" else v.split(","))
    return body


def _search(node, req):
    body = _search_body(req)
    resp = node.search(req.param("index", "_all"), body,
                       scroll=req.param("scroll"))
    _echo_hit_types(node, resp)
    _render_total_hits(resp, body)
    return 200, resp


def _scroll(node, req):
    body = req.json_body({}) or {}
    scroll_id = body.get("scroll_id") or req.param("scroll_id")
    return 200, node.scroll(scroll_id,
                            body.get("scroll") or req.param("scroll"))


def _clear_scroll(node, req):
    body = req.json_body({}) or {}
    ids = body.get("scroll_id") or req.param("scroll_id") or ["_all"]
    if isinstance(ids, str):
        ids = [i for i in ids.split(",") if i]
    r = node.clear_scroll(ids)
    # clearing ids of which none existed is a 404; _all always answers 200
    status = 200 if (r.get("num_freed", 0) > 0 or ids == ["_all"]) else 404
    return status, r


def _render_total_hits(resp, body) -> None:
    """Inexact totals render as ``{"value": N, "relation": "gte"}``: the
    6.x response keeps ``hits.total`` a bare int, but block-max pruned
    scoring (``_pruned``) and hybrid fusion (``_total_relation``) report
    lower bounds. A request that asked with ``track_total_hits`` gets the
    object form too (``"eq"`` when exact)."""
    hits = (resp or {}).get("hits")
    if not isinstance(hits, dict) or not isinstance(hits.get("total"), int):
        return
    relation = "eq"
    pruned = resp.get("_pruned")
    if isinstance(pruned, dict) and pruned.get("total_relation"):
        relation = str(pruned["total_relation"])
    elif resp.get("_total_relation") == "gte":
        relation = "gte"
    tth = (body or {}).get("track_total_hits")
    opted_in = tth is True or (isinstance(tth, int)
                               and not isinstance(tth, bool) and tth > 0)
    if relation != "eq" or opted_in:
        hits["total"] = {"value": hits["total"], "relation": relation}


def _echo_hit_types(node, resp):
    """Hits echo their index's 6.x type name."""
    for hit in (resp.get("hits", {}) or {}).get("hits", []):
        if isinstance(hit, dict) and hit.get("_type") == "_doc":
            hit["_type"] = _doc_type_of(node, hit.get("_index"))


def _msearch(node, req):
    lines = req.ndjson_lines()
    searches = []
    for i in range(0, len(lines), 2):
        header = lines[i] if isinstance(lines[i], dict) else {}
        body = lines[i + 1] if i + 1 < len(lines) else {}
        header.setdefault("index", req.param("index", "_all"))
        searches.append((header, body))
    resp = node.msearch(searches)
    # the same inexact-total rendering as _search, per entry
    for (_header, body), entry in zip(searches, resp["responses"]):
        _render_total_hits(entry, body)
    return 200, resp


def _count(node, req):
    body = _search_body(req)
    body["size"] = 0
    resp = node.search(req.param("index", "_all"), body)
    return 200, {"count": resp["hits"]["total"], "_shards": resp["_shards"]}


def _validate_query(node, req):
    """Whether the body's query parses; ``?explain`` adds the error."""
    from elasticsearch_tpu_torch.search.query_dsl import parse_query

    body = req.json_body({}) or {}
    shards = {"total": 1, "successful": 1, "failed": 0}
    try:
        parse_query(body.get("query"))
        return 200, {"valid": True, "_shards": shards}
    except Exception as e:  # noqa: BLE001 — any parse failure is invalid
        resp = {"valid": False, "_shards": shards}
        if req.bool_param("explain"):
            resp["explanations"] = [{"index": req.param("index"),
                                     "valid": False, "error": str(e)}]
        return 200, resp


def _explain(node, req):
    """Whether one doc matches a query, and its score: the query AND an
    ``ids`` filter of the doc, searched through the index's planes, so the
    value is the score the doc gets in a search; for queries that expand
    to term lanes, the per-term BM25 breakdown of that score."""
    body = req.json_body({}) or {}
    if body and "query" not in body:
        # a bare query object at the top level is a parse error
        raise ActionRequestValidationException(
            "Validation Failed: 1: query is missing;")
    svc = node.index_service(req.param("index"))
    doc_id = req.param("id")
    inner = body.get("query")
    if inner is None and req.param("q") is not None:
        # the URI-search form: ?q= with df, default_operator, analyzer and
        # lenient
        inner = {"query_string": {
            "query": req.param("q"),
            **({"default_field": req.param("df")} if req.param("df")
               else {}),
            **({"default_operator": req.param("default_operator")}
               if req.param("default_operator") else {}),
            **({"analyzer": req.param("analyzer")}
               if req.param("analyzer") else {}),
            **({"lenient": req.bool_param("lenient")}
               if req.param("lenient") is not None else {}),
        }}
    q = dict(body)
    q["query"] = {"bool": {"must": [inner or {"match_all": {}}],
                           "filter": [{"ids": {"values": [doc_id]}}]}}
    q["size"] = 1
    resp = svc.search(q)
    matched = resp["hits"]["total"] > 0
    score = resp["hits"]["hits"][0]["_score"] if matched else 0.0
    details = _bm25_explanation_details(
        svc, doc_id, body.get("query")) if matched else []
    out = {
        "_index": svc.name,
        "_id": doc_id,
        "matched": matched,
        "explanation": {
            "value": score,
            "description": ("sum of:" if details else
                            "score via the fused query program"),
            "details": details,
        },
    }
    # the get section carries the (filtered) source when any _source
    # parameter was given
    if any(req.param(p) is not None for p in (
            "_source", "_source_include", "_source_includes",
            "_source_exclude", "_source_excludes")):
        g = svc.get_doc(doc_id, routing=req.param("routing"))
        if g.found:
            get_out = {"found": True, "_source": dict(g.source)}
            _apply_source_filtering(req, get_out)
            out["get"] = get_out
    _echo_type(req, out)
    return 200, out


def _explanation_leaf(value, description) -> dict:
    return {"value": value, "description": description, "details": []}


def _bm25_explanation_details(svc, doc_id, query_body):
    """The per-term BM25 breakdown (BM25Similarity.explain's tree: boost
    x idf x tfNorm with their inputs) of the doc's segment, for queries
    that expand to term lanes; other shapes keep the summary."""
    from elasticsearch_tpu_torch.ops.scoring import B, K1, bm25_idf
    from elasticsearch_tpu_torch.search.query_dsl import (
        ShardQueryContext,
        parse_query,
    )

    try:
        qb = parse_query(query_body)
    except Exception:  # noqa: BLE001 — the summary stands
        return []
    shard = svc.shards[svc._route(doc_id)]
    ctx = ShardQueryContext(svc.mapper_service, shard.engine)
    lanes = qb.explain_terms(ctx)
    if not lanes:
        return []
    entry = shard.engine.version_map.get(doc_id)
    if entry is None or entry.segment is None:
        return []
    segment = next((s for s in shard.engine.searchable_segments()
                    if s.name == entry.segment), None)
    if segment is None:
        return []
    local = entry.local_doc
    details = []
    for field, token, boost in lanes:
        tid = segment.term_id(field, token)
        if tid < 0:
            continue
        start = int(segment.term_block_start[tid])
        count = int(segment.term_block_count[tid])
        blk = segment.block_docs[start:start + count]
        sel = blk == local
        if not sel.any():
            continue
        freq = float(segment.block_tfs[start:start + count][sel][0])
        row = segment.field_norm_idx.get(field, 0)
        dl = float(segment.norms[row][local])
        avgdl = segment.field_avgdl(field)
        st = segment.field_stats.get(field, {})
        n_docs = int(st.get("doc_count", segment.num_docs))
        df = int(segment.term_doc_freq[tid])
        idf = bm25_idf(df, n_docs)
        tf_norm = freq * (K1 + 1) / (freq + K1 * (1 - B + B * dl / avgdl))
        value = boost * idf * tf_norm
        leaf = _explanation_leaf
        details.append({
            "value": value,
            "description": f"weight({field}:{token} in {local}) "
                           f"[PerFieldSimilarity], result of:",
            "details": [{
                "value": value,
                "description": f"score(doc={local}, freq={freq}), "
                               f"product of:",
                "details": [
                    leaf(boost, "boost"),
                    {"value": idf,
                     "description": "idf, computed as log(1 + (N - n + 0.5)"
                                    " / (n + 0.5)) from:",
                     "details": [
                         leaf(df, "n, number of documents containing "
                                  "term"),
                         leaf(n_docs, "N, total number of documents with "
                                      "field")]},
                    {"value": tf_norm,
                     "description": "tfNorm, computed as (freq * (k1 + 1)) /"
                                    " (freq + k1 * (1 - b + b * dl / avgdl))"
                                    " from:",
                     "details": [
                         leaf(freq, "termFreq"),
                         leaf(K1, "parameter k1"),
                         leaf(B, "parameter b"),
                         leaf(avgdl, "avgFieldLength"),
                         leaf(dl, "fieldLength")]},
                ],
            }],
        })
    return details


# ---------------------------------------------------------------------------
# Index admin
# ---------------------------------------------------------------------------


def _create_index(node, req):
    return 200, node.create_index(req.param("index"), req.json_body({}))


def _delete_index(node, req):
    return 200, node.delete_index(
        req.param("index"),
        ignore_unavailable=req.bool_param("ignore_unavailable"),
        allow_no_indices=req.bool_param("allow_no_indices", True))


def _get_index(node, req):
    expr = req.param("index")
    if req.bool_param("ignore_unavailable"):
        names = []
        for part in str(expr).split(","):
            try:
                names.extend(node.resolve_index_names(part))
            except IndexNotFoundException:
                continue  # ignore_unavailable skips only missing parts
    else:
        names = node.resolve_index_names(expr)
    return 200, {name: node.index_metadata(name) for name in names}


def _head_index(node, req):
    try:
        node.resolve_index_names(req.param("index"))
    except IndexNotFoundException:
        return 404, {}
    return 200, {}


def _refresh(node, req):
    names = node.resolve_index_names(req.param("index", "_all"))
    for name in names:
        node.indices[name].refresh()
    n = sum(node.indices[x].num_shards for x in names)
    return 200, {"_shards": {"total": n, "successful": n, "failed": 0}}


def _flush(node, req):
    return 200, node.flush(req.param("index", "_all"))


def _flush_synced(node, req):
    """``_flush/synced``: a flush that stamps a sync id on every shard, in
    the per-index shape."""
    return 200, node.synced_flush(req.param("index", "_all"))


def _forcemerge(node, req):
    return 200, node.force_merge(req.param("index", "_all"))


def _get_mapping(node, req):
    want_type = req.param("type")
    out = {}
    for name in node.resolve_index_names(req.param("index", "_all")):
        (dt, mapping), = node.index_mapping(name).items()
        if want_type and want_type not in (dt, "_all"):
            continue
        out[name] = {"mappings": {dt: mapping}}
    if want_type and not out:
        raise ResourceNotFoundException(f"type[[{want_type}]] missing")
    return 200, out


def _settings_values_as_strings(obj):
    """Every setting value renders as a string; booleans lowercase."""
    if isinstance(obj, dict):
        return {k: _settings_values_as_strings(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_settings_values_as_strings(v) for v in obj]
    if isinstance(obj, bool):
        return "true" if obj else "false"
    return str(obj)


def _get_index_settings(node, req):
    flat = req.bool_param("flat_settings")
    name_filter = req.param("setting")
    out = {}
    for name in node.resolve_index_names(req.param("index", "_all")):
        settings = node.index_settings(name)
        if name_filter and name_filter != "_all":
            pats = [p for p in str(name_filter).split(",") if p]
            settings = {k: v for k, v in settings.items()
                        if any(fnmatch.fnmatchcase(k, p) for p in pats)}
        s = Settings.from_dict(settings).with_index_prefix()
        out[name] = {"settings": _settings_values_as_strings(
            s.as_dict() if flat else s.as_nested_dict())}
    return 200, out


def _analyze(node, req):
    body = req.json_body({}) or {}
    text = body.get("text") or req.param("text")
    if text is None:
        raise ActionRequestValidationException(
            "Validation Failed: 1: text is missing;")
    texts = text if isinstance(text, list) else [text]
    index = req.param("index")
    registry = (node.index_service(index).analyzers if index is not None
                else AnalysisRegistry())
    analyzer_name = body.get("analyzer") or req.param("analyzer")
    field = body.get("field")
    if analyzer_name is None and field is not None and index is not None:
        ft = node.index_service(index).mapper_service.field_type(field)
        analyzer_name = getattr(ft, "analyzer", None) or "standard"
    analyzer = registry.get(analyzer_name or "standard")
    tokens = []
    for t in texts:
        for pos, (tok, start, end) in enumerate(analyzer.analyze_tokens(t)):
            tokens.append({"token": tok, "start_offset": start,
                           "end_offset": end, "type": "<ALPHANUM>",
                           "position": pos})
    return 200, {"tokens": tokens}


# ---------------------------------------------------------------------------
# cat API
# ---------------------------------------------------------------------------


def _cat_table(req, rows: List[List], headers: List[str]) -> Tuple[int, object]:
    if req.bool_param("help"):
        # one line per column: name | alias | description
        w = max(len(h) for h in headers)
        return 200, "".join(f"{h.ljust(w)} | - | {h}\n" for h in headers)
    # s: sort by column(s), `name` or `name:desc`, comma list
    sort_spec = req.param("s")
    if sort_spec:
        for key in reversed([k for k in str(sort_spec).split(",") if k]):
            name, _, direction = key.partition(":")
            if name not in headers:
                raise IllegalArgumentException(
                    f"Unable to sort by unknown sort key `{name}`")
            i = headers.index(name)

            def sort_key(row, _i=i):
                v = row[_i]
                try:
                    return (0, float(v), "")
                except (TypeError, ValueError):
                    return (1, 0.0, str(v))
            rows = sorted(rows, key=sort_key, reverse=direction == "desc")
    # h: select/reorder columns
    h_spec = req.param("h")
    if h_spec:
        idx = []
        for name in [w for w in str(h_spec).split(",") if w]:
            if name not in headers:
                raise IllegalArgumentException(
                    f"Field [{name}] not found in the cat table")
            idx.append(headers.index(name))
        headers = [headers[i] for i in idx]
        rows = [[row[i] for i in idx] for row in rows]
    if req.param("format") == "json":
        return 200, [dict(zip(headers, row)) for row in rows]
    cols = [[str(c) for c in row] for row in rows]
    if req.bool_param("v"):
        cols = [headers] + cols
    if not cols:
        return 200, ""
    widths = [max(len(r[i]) for r in cols) for i in range(len(headers))]
    lines = [" ".join(c.ljust(w) for c, w in zip(row, widths))
             for row in cols]
    return 200, "\n".join(lines) + "\n"


def _cat_help(node, req):
    paths = sorted({r.pattern for r in node.rest_controller.routes
                    if r.pattern.startswith("/_cat")})
    return 200, "\n".join(paths) + "\n"


def _cat_indices(node, req):
    rows = []
    for name in node.resolve_index_names(req.param("index", "_all")):
        svc = node.indices[name]
        segments = [seg for shard in svc.shards.values()
                    for seg in shard.engine.segments]
        deleted = sum(seg.num_docs - seg.live_doc_count for seg in segments)
        store = sum(seg.memory_bytes() for seg in segments)
        rows.append([
            "green" if svc.num_replicas == 0 else "yellow", "open", name,
            svc.uuid, svc.num_shards, svc.num_replicas, svc.num_docs(),
            deleted, f"{store}b", f"{store}b",
        ])
    return _cat_table(req, rows, [
        "health", "status", "index", "uuid", "pri", "rep", "docs.count",
        "docs.deleted", "store.size", "pri.store.size",
    ])


def _cat_health(node, req):
    h = node.health()
    row = [h["cluster_name"], h["status"], h["number_of_nodes"],
           h["number_of_data_nodes"], h["active_shards"],
           h["active_primary_shards"], h["relocating_shards"],
           h["initializing_shards"], h["unassigned_shards"], 0, "-",
           f"{h['active_shards_percent_as_number']:.1f}%"]
    headers = ["cluster", "status", "node.total", "node.data", "shards",
               "pri", "relo", "init", "unassign", "pending_tasks",
               "max_task_wait_time", "active_shards_percent"]
    if req.param("ts") in ("false", False, "0"):
        return _cat_table(req, [row], headers)
    return _cat_table(
        req, [[int(time.time()), time.strftime("%H:%M:%S")] + row],
        ["epoch", "timestamp"] + headers)


def _cat_staging(node, req):
    """``_cat/staging``: the device-memory ledger one row an (index,
    scope, kind): what is staged on the card, how big, how recently used,
    and whether the budget may evict it; plus, for each index's staged
    mesh generation, its free slots a device on the scope's rows and one
    summary row a slot (live/total docs and tombstone density, the
    compaction trigger's inputs)."""
    from elasticsearch_tpu_torch.common.memory import memory_accountant

    scope_meta: dict = {}
    for name in sorted(node.indices):
        ms = node.indices[name]._mesh_search
        stats = ms.staging_slot_stats() if ms is not None else None
        executor = ms._executor if ms is not None else None
        if not stats or executor is None:
            continue
        scope_meta[(name, executor.scope)] = (stats,
                                              stats["free_slots_per_device"])
    rows = []
    for row in memory_accountant().table():
        meta = scope_meta.get((row["index"], row["segment"]))
        rows.append([
            row["index"], row["segment"], row["kind"], f"{row['bytes']}b",
            row["tables"], row["stage_count"],
            "-" if row["idle_s"] is None else f"{row['idle_s']:.1f}s",
            "*" if row["evictable"] else "-",
            "-" if meta is None else f"{meta[1]}", "-",
        ])
    for (name, scope), (stats, free_dev) in sorted(scope_meta.items()):
        for sl in stats["slots"]:
            rows.append([
                name, f"{scope}/slot{sl['slot']}", "slot",
                f"{sl['live']}/{sl['docs']}d", 1, "-", "-", "-",
                f"{free_dev}", f"{sl['tombstone_density']}",
            ])
    return _cat_table(req, rows, [
        "index", "segment", "kind", "bytes", "tables", "stage_count",
        "idle", "evictable", "free_slots_per_dev", "tombstone_density"])


def _cat_nodes(node, req):
    rows = [["127.0.0.1", 0, 0, "mdi", "*", node.node_name]]
    return _cat_table(req, rows, ["ip", "heap.percent", "cpu", "node.role",
                                  "master", "name"])


def _cat_count(node, req):
    total = sum(node.indices[n].num_docs()
                for n in node.resolve_index_names(req.param("index", "_all")))
    rows = [[int(time.time()), time.strftime("%H:%M:%S"), total]]
    return _cat_table(req, rows, ["epoch", "timestamp", "count"])


def _cat_master(node, req):
    rows = [[node.node_id, "127.0.0.1", "127.0.0.1", node.node_name]]
    return _cat_table(req, rows, ["id", "host", "ip", "node"])


def _cat_thread_pool(node, req):
    stats = node.thread_pool.stats()
    rows = [[node.node_name, pool, st["active"], st["queue"], st["rejected"]]
            for pool, st in stats.items()]
    return _cat_table(req, rows, ["node_name", "name", "active", "queue", "rejected"])
