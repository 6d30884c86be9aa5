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
aliases, wildcards, comma lists, ``_all``), ``_search/scroll`` (next
page, clear), ``_search/template`` and ``_render/template`` (inline or
stored), ``_count``, ``_msearch``, ``_explain`` (four routes: ``?q=``,
the ``_source`` parameters, the per-term BM25 details), ``_validate/query``
(``?explain``), ``_refresh``, ``_flush``, ``_flush/synced``,
``_forcemerge``, index create (with ``aliases`` and the matching
templates)/delete/get/head, ``_open`` and ``_close``, ``_stats[/{metric}]``
and ``_segments``, ``_mapping`` GET and PUT, ``_settings`` GET and PUT
(dynamic settings), ``_aliases`` and ``_alias`` in every form,
``_template``, ``_scripts``, ``_analyze`` over the built-in analyzers,
``_cluster/health|state|stats|settings``, ``_nodes[/stats]`` and the cat
tables ``indices``, ``count``, ``health``, ``nodes``, ``master``,
``shards``, ``aliases``, ``templates``, ``segments``, ``thread_pool``
and the empty ones. The data-movement routes: ``_reindex``,
``_update_by_query`` and ``_delete_by_query`` (``index/reindex.py``),
``_tasks`` (list, get, ``_cancel``), ``_ingest/pipeline`` (CRUD and
``_simulate``; ``?pipeline=`` on index and ``_bulk``), ``_snapshot``
(repositories, create, status, get, delete, restore, ``_verify``),
``_rollover``, ``_shrink``, ``_field_caps`` over an index expression,
``_termvectors``, and the cat tables ``tasks``, ``repositories`` and
``snapshots``. ``_cache/clear`` (both routes) drops the segments'
staged doc-value columns, as the JAX package's does, and the request
cache too (ROADMAP C20). ``GET /_nodes/hot_threads`` (and
``/_nodes/{node_id}/hot_threads``) answers ``Node.hot_threads`` as text,
``POST`` and ``DELETE /_nodes/_local/_drain`` the node's drain and
undrain. The cluster routes: ``_cluster/reroute`` (``Node.reroute``:
the commands, ``dry_run``, ``explain``), ``_cluster/allocation/explain``
(the corrupted copies' markers), ``_cat/allocation`` and
``_cat/recovery`` (the store rows and the cluster's peer-recovery
rows, ``index/recovery_progress.recovery_progress_rows``). Two routes
still answer ``_unported``: ``_remote/info`` and ``_cat/plugins``.
Writes take ``refresh=wait_for``. Handlers are (node, request) ->
(status, payload); the cat API returns text tables unless
``?format=json``.
"""

from __future__ import annotations

import fnmatch
import time
from typing import List, Tuple

import torch

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common import monitor
from elasticsearch_tpu_torch.common.deprecation import DeprecationLogger
from elasticsearch_tpu_torch.common.errors import (
    ActionRequestValidationException,
    ElasticsearchTpuException,
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
    r("GET", "/_field_caps", _field_caps)
    r("POST", "/_field_caps", _field_caps)
    r("GET", "/{index}/_field_caps", _field_caps)
    r("POST", "/{index}/_field_caps", _field_caps)
    r("GET", "/{index}/_explain/{id}", _explain)
    r("POST", "/{index}/_explain/{id}", _explain)

    # --- templates / termvectors / rollover / shrink / hot_threads ---
    r("GET", "/_search/template", _search_template)
    r("POST", "/_search/template", _search_template)
    r("GET", "/{index}/_search/template", _search_template)
    r("POST", "/{index}/_search/template", _search_template)
    r("GET", "/_render/template", _render_template)
    r("POST", "/_render/template", _render_template)
    r("GET", "/{index}/_termvectors/{id}", _termvectors)
    r("POST", "/{index}/_termvectors/{id}", _termvectors)
    r("GET", "/{index}/{type}/{id}/_termvectors", _termvectors)
    r("POST", "/{index}/_rollover", _rollover)
    r("POST", "/{index}/_rollover/{new_index}", _rollover)
    r("POST", "/{index}/_shrink/{target}", _shrink)
    r("PUT", "/{index}/_shrink/{target}", _shrink)
    r("GET", "/_nodes/hot_threads", lambda n, q: (200, n.hot_threads()))
    r("GET", "/_nodes/{node_id}/hot_threads",
      lambda n, q: (200, n.hot_threads()))
    r("POST", "/_nodes/_local/_drain", lambda n, q: (200, n.drain()))
    r("DELETE", "/_nodes/_local/_drain", lambda n, q: (200, n.undrain()))

    # --- reindex family ---
    r("POST", "/_reindex", _reindex)
    r("POST", "/{index}/_update_by_query", _update_by_query)
    r("POST", "/{index}/_delete_by_query", _delete_by_query)

    # --- index admin ---
    r("PUT", "/{index}", _create_index)
    r("DELETE", "/{index}", _delete_index)
    r("GET", "/{index}", _get_index)
    r("HEAD", "/{index}", _head_index)
    r("POST", "/{index}/_open", lambda n, q: (200, n.open_index(
        q.param("index"))))
    r("POST", "/{index}/_close", lambda n, q: (200, n.close_index(
        q.param("index"))))
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
    r("GET", "/{index}/_stats", _index_stats)
    r("GET", "/_stats", _index_stats)
    r("GET", "/{index}/_stats/{metric}", _index_stats)
    r("GET", "/_stats/{metric}", _index_stats)
    r("GET", "/{index}/_segments", _segments)
    r("GET", "/_segments", _segments)
    r("PUT", "/{index}/_mapping", _put_mapping)
    r("PUT", "/{index}/_mapping/{type}", _put_mapping)
    r("POST", "/{index}/_mapping", _put_mapping)
    r("GET", "/{index}/_mapping", _get_mapping)
    r("GET", "/_mapping", _get_mapping)
    r("GET", "/{index}/_mapping/{type}", _get_mapping)
    r("PUT", "/{index}/_settings", _put_index_settings)
    r("PUT", "/_settings", _put_index_settings)
    r("GET", "/{index}/_settings", _get_index_settings)
    r("GET", "/_settings", _get_index_settings)
    r("GET", "/{index}/_settings/{setting}", _get_index_settings)
    r("GET", "/_settings/{setting}", _get_index_settings)
    r("GET", "/_analyze", _analyze)
    r("POST", "/_analyze", _analyze)
    r("GET", "/{index}/_analyze", _analyze)
    r("POST", "/{index}/_analyze", _analyze)
    r("POST", "/_aliases", _update_aliases)
    r("GET", "/_alias", _get_alias)
    r("GET", "/_alias/{name}", _get_alias)
    r("GET", "/{index}/_alias", _get_alias)
    r("GET", "/{index}/_alias/{name}", _get_alias)
    r("PUT", "/{index}/_alias/{name}", _put_alias)
    r("DELETE", "/{index}/_alias/{name}", _delete_alias)
    r("HEAD", "/_alias/{name}", _head_alias)
    r("HEAD", "/{index}/_alias/{name}", _head_alias)
    r("PUT", "/_template/{name}", _put_template)
    r("GET", "/_template", _get_template)
    r("GET", "/_template/{name}", _get_template)
    r("DELETE", "/_template/{name}", lambda n, q: (200, n.delete_template(
        q.param("name"))))
    r("HEAD", "/_template/{name}", _head_template)
    r("POST", "/{index}/_cache/clear", _clear_cache)
    r("POST", "/_cache/clear", _clear_cache)

    # --- cluster admin ---
    r("GET", "/_cluster/health", lambda n, q: (200, n.health()))
    r("GET", "/_cluster/health/{index}", lambda n, q: (200, n.health()))
    r("GET", "/_cluster/state", _cluster_state)
    r("GET", "/_cluster/state/{metrics}", _cluster_state)
    r("GET", "/_cluster/stats", lambda n, q: (200, n.cluster_stats()))
    r("GET", "/_cluster/settings", _get_cluster_settings)
    r("PUT", "/_cluster/settings", lambda n, q: (200, n.put_cluster_settings(
        q.json_body({}))))
    r("POST", "/_cluster/reroute", lambda n, q: (200, n.reroute(
        q.json_body({}) or {},
        dry_run=q.bool_param("dry_run", False),
        explain=q.bool_param("explain", False))))
    r("GET", "/_cluster/allocation/explain", _allocation_explain)
    r("GET", "/_nodes", lambda n, q: (200, n.node_info()))
    r("GET", "/_nodes/stats", lambda n, q: (200, n.node_stats()))
    r("GET", "/_nodes/stats/{metric}", lambda n, q: (200, n.node_stats()))
    r("GET", "/_nodes/stats/{metric}/{index_metric}",
      lambda n, q: (200, n.node_stats()))
    r("GET", "/_nodes/{node_id}", lambda n, q: (200, n.node_info()))
    r("GET", "/_nodes/{node_id}/stats", lambda n, q: (200, n.node_stats()))
    r("GET", "/_nodes/{node_id}/stats/{metric}",
      lambda n, q: (200, n.node_stats()))
    r("GET", "/_nodes/{node_id}/stats/{metric}/{index_metric}",
      lambda n, q: (200, n.node_stats()))
    r("GET", "/_remote/info", _unported)

    # --- tasks ---
    r("GET", "/_tasks", lambda n, q: (200, n.tasks.list_tasks(
        q.param("actions"))))
    r("GET", "/_tasks/{task_id}", _get_task)
    r("POST", "/_tasks/{task_id}/_cancel", _cancel_task)

    # --- scripts ---
    r("PUT", "/_scripts/{id}", lambda n, q: (200, n.put_stored_script(
        q.param("id"), q.json_body({}))))
    r("GET", "/_scripts/{id}", lambda n, q: (200, n.get_stored_script(
        q.param("id"))))
    r("DELETE", "/_scripts/{id}", lambda n, q: (200, n.delete_stored_script(
        q.param("id"))))

    # --- ingest ---
    r("PUT", "/_ingest/pipeline/{id}", lambda n, q: (
        200, n.ingest.put_pipeline(q.param("id"), q.json_body({}))))
    r("GET", "/_ingest/pipeline", lambda n, q: (200, n.ingest.get_pipeline()))
    r("GET", "/_ingest/pipeline/{id}", lambda n, q: (
        200, n.ingest.get_pipeline(q.param("id"))))
    r("DELETE", "/_ingest/pipeline/{id}", lambda n, q: (
        200, n.ingest.delete_pipeline(q.param("id"))))
    r("POST", "/_ingest/pipeline/_simulate", lambda n, q: (
        200, n.ingest.simulate(q.json_body({}))))
    r("GET", "/_ingest/pipeline/_simulate", lambda n, q: (
        200, n.ingest.simulate(q.json_body({}))))
    r("POST", "/_ingest/pipeline/{id}/_simulate", _simulate_pipeline_by_id)

    # --- snapshots ---
    r("PUT", "/_snapshot/{repo}", lambda n, q: (
        200, n.snapshots.put_repository(q.param("repo"), q.json_body({}))))
    r("POST", "/_snapshot/{repo}", lambda n, q: (
        200, n.snapshots.put_repository(q.param("repo"), q.json_body({}))))
    r("GET", "/_snapshot", lambda n, q: (200, n.snapshots.get_repository()))
    r("GET", "/_snapshot/{repo}", lambda n, q: (
        200, n.snapshots.get_repository(q.param("repo"))))
    r("DELETE", "/_snapshot/{repo}", lambda n, q: (
        200, n.snapshots.delete_repository(q.param("repo"))))
    r("PUT", "/_snapshot/{repo}/{snapshot}", lambda n, q: (
        200, n.snapshots.create_snapshot(
            q.param("repo"), q.param("snapshot"), q.json_body({}),
            wait_for_completion=q.bool_param("wait_for_completion", True))))
    r("GET", "/_snapshot/{repo}/_status", lambda n, q: (
        200, n.snapshots.snapshot_status(q.param("repo"))))
    r("GET", "/_snapshot/{repo}/{snapshot}/_status", lambda n, q: (
        200, n.snapshots.snapshot_status(q.param("repo"),
                                         q.param("snapshot"))))
    r("GET", "/_snapshot/{repo}/{snapshot}", lambda n, q: (
        200, n.snapshots.get_snapshot(q.param("repo"), q.param("snapshot"))))
    r("DELETE", "/_snapshot/{repo}/{snapshot}", lambda n, q: (
        200, n.snapshots.delete_snapshot(q.param("repo"),
                                         q.param("snapshot"))))
    r("POST", "/_snapshot/{repo}/{snapshot}/_restore", lambda n, q: (
        200, n.snapshots.restore_snapshot(q.param("repo"),
                                          q.param("snapshot"),
                                          q.json_body({}))))
    r("POST", "/_snapshot/{repo}/_verify", lambda n, q: (
        200, n.snapshots.verify_repository(q.param("repo"))))

    # --- cat API (rest/action/cat/, 22 handlers in the reference) ---
    r("GET", "/_cat", _cat_help)
    r("GET", "/_cat/indices", _cat_indices)
    r("GET", "/_cat/indices/{index}", _cat_indices)
    r("GET", "/_cat/health", _cat_health)
    r("GET", "/_cat/nodes", _cat_nodes)
    r("GET", "/_cat/shards", _cat_shards)
    r("GET", "/_cat/shards/{index}", _cat_shards)
    r("GET", "/_cat/staging", _cat_staging)
    r("GET", "/_cat/count", _cat_count)
    r("GET", "/_cat/count/{index}", _cat_count)
    r("GET", "/_cat/aliases", _cat_aliases)
    r("GET", "/_cat/aliases/{name}", _cat_aliases)
    r("GET", "/_cat/templates", _cat_templates)
    r("GET", "/_cat/templates/{name}", _cat_templates)
    r("GET", "/_cat/master", _cat_master)
    r("GET", "/_cat/segments", _cat_segments)
    r("GET", "/_cat/plugins", _unported)
    r("GET", "/_cat/tasks", _cat_tasks)
    r("GET", "/_cat/pending_tasks", lambda n, q: _cat_table(
        q, [], ["insertOrder", "timeInQueue", "priority", "source"]))
    r("GET", "/_cat/allocation", _cat_allocation)
    r("GET", "/_cat/recovery", _cat_recovery)
    r("GET", "/_cat/thread_pool", _cat_thread_pool)
    r("GET", "/_cat/fielddata", lambda n, q: _cat_table(
        q, [], ["id", "host", "ip", "node", "field", "size"]))
    r("GET", "/_cat/fielddata/{fields}", lambda n, q: _cat_table(
        q, [], ["id", "host", "ip", "node", "field", "size"]))
    r("GET", "/_cat/nodeattrs", lambda n, q: _cat_table(
        q, [], ["node", "id", "pid", "host", "ip", "port", "attr", "value"]))
    r("GET", "/_cat/repositories", _cat_repositories)
    r("GET", "/_cat/snapshots/{repo}", _cat_snapshots)


def _clear_cache(node, req):
    node.clear_cache(req.param("index", "_all"))
    return 200, {"_shards": {"total": 0, "successful": 0, "failed": 0}}


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
        try:
            total = 1 + node.index_service(req.param("index")).num_replicas
        except ElasticsearchTpuException:
            total = 1
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
    try:
        svc = node.index_service(req.param("index"))
    except ElasticsearchTpuException:
        return
    if svc.doc_type == "_doc":
        svc.doc_type = t


def _parent_routing(node, req):
    """(effective routing, parent): the legacy ``parent`` param acts as the
    routing, and a ``_parent``-mapped index requires one of the two on
    every single-doc op (``RoutingMissingException``)."""
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
                       pipeline=req.param("pipeline"),
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
                       pipeline=req.param("pipeline"),
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
    return 200, node.bulk(ops, refresh=req.param("refresh"),
                          pipeline=req.param("pipeline"))


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
    entry = shard.engine.lookup_version(doc_id)
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


def _field_caps(node, req):
    """Each field the ``fields`` patterns match, over the indices the
    index expression names, by type: searchable and aggregatable."""
    fields_param = (req.param("fields")
                    or (req.json_body({}) or {}).get("fields", "*"))
    if isinstance(fields_param, str):
        fields_param = fields_param.split(",")
    out: dict = {}
    for svc in node.resolve_search_indices(req.param("index", "_all")):
        mapper = svc.mapper_service
        for pattern in fields_param:
            for fname in mapper.mapper.simple_match_to_fields(pattern):
                ft = mapper.field_type(fname)
                t = ft.type_name
                out.setdefault(fname, {}).setdefault(t, {
                    "type": t,
                    "searchable": bool(ft.index),
                    "aggregatable": (bool(ft.doc_values)
                                     or t == "text" and ft.fielddata),
                })
    return 200, {"fields": out}


def _termvectors(node, req):
    _typed_api_warning(req)
    body = req.json_body({}) or {}
    fields = body.get("fields") or (
        req.param("fields").split(",") if req.param("fields") else None)
    return 200, node.termvectors(req.param("index"), req.param("id"), fields)


def _rollover(node, req):
    body = req.json_body({}) or {}
    if req.param("new_index"):
        body["new_index"] = req.param("new_index")
    if req.bool_param("dry_run"):
        body["dry_run"] = True
    return 200, node.rollover(req.param("index"), body)


def _shrink(node, req):
    return 200, node.shrink_index(req.param("index"), req.param("target"),
                                  req.json_body({}))


def _reindex(node, req):
    from elasticsearch_tpu_torch.index.reindex import reindex

    return 200, reindex(node, req.json_body({}))


def _update_by_query(node, req):
    from elasticsearch_tpu_torch.index.reindex import update_by_query

    return 200, update_by_query(node, req.param("index"), req.json_body({}))


def _delete_by_query(node, req):
    from elasticsearch_tpu_torch.index.reindex import delete_by_query

    return 200, delete_by_query(node, req.param("index"), req.json_body({}))


def _get_task(node, req):
    task = node.tasks.get(req.param("task_id"))
    return 200, {"completed": False, "task": task.to_dict()}


def _cancel_task(node, req):
    task = node.tasks.cancel(req.param("task_id"))
    return 200, {"nodes": {node.node_id: {"tasks": {
        task.id_string: task.to_dict()}}}}


def _simulate_pipeline_by_id(node, req):
    body = req.json_body({}) or {}
    body["id"] = req.param("id")
    return 200, node.ingest.simulate(body)


def _search_template(node, req):
    """``_search/template``: an inline or stored mustache template
    rendered into the search body, then searched as ``_search`` is."""
    from elasticsearch_tpu_torch.search.templates import resolve_template

    body = resolve_template(node, req.json_body({}) or {})
    return 200, node.search(req.param("index", "_all"), body)


def _render_template(node, req):
    from elasticsearch_tpu_torch.search.templates import resolve_template

    return 200, {"template_output": resolve_template(
        node, req.json_body({}) or {})}


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


_STATS_METRICS = {
    "docs": "docs", "store": "store", "indexing": "indexing", "get": "get",
    "search": "search", "merge": "merges", "refresh": "refresh",
    "flush": "flush", "warmer": "warmer", "query_cache": "query_cache",
    "fielddata": "fielddata", "completion": "completion",
    "segments": "segments", "translog": "translog", "recovery": "recovery",
    "request_cache": "request_cache", "suggest": "search",
}


def _filter_named(entries, param):
    """``groups=`` / ``types=`` filtering: comma lists, ``_all`` and
    ``*`` wildcards."""
    if not param or not entries:
        return None
    wanted = param if isinstance(param, list) else str(param).split(",")
    if "_all" in wanted:
        return dict(entries)
    return {k: v for k, v in entries.items()
            if any(fnmatch.fnmatchcase(k, w) for w in wanted if w)}


def _sum_stats(dicts):
    """Element-wise numeric merge of section dicts (nested)."""
    out = {}
    for d in dicts:
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = _sum_stats([out.get(k, {}), v])
            elif isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v
            else:
                out[k] = v
    return out


def _stats_sections(req):
    """The sections a ``{metric}`` path names (None: all); an unknown one
    is a 400 with the nearest names."""
    import difflib

    metric_param = req.param("metric")
    if not metric_param or metric_param == "_all":
        return None
    sections = set()
    for m in str(metric_param).split(","):
        if not m or m == "_all":
            return None
        if m not in _STATS_METRICS:
            near = difflib.get_close_matches(m, _STATS_METRICS, n=3)
            hint = (" -> did you mean " + (
                f"[{near[0]}]" if len(near) == 1
                else "any of [" + ", ".join(near) + "]") + "?") \
                if near else ""
            raise IllegalArgumentException(
                f"request [{req.path}] contains unrecognized metric: "
                f"[{m}]{hint}")
        sections.add(_STATS_METRICS[m])
    return sections


def _index_stats(node, req):
    """``_stats[/{metric}]``: each index's sections (``IndexService.
    stats``), filtered by metric, ``groups`` and ``types``, at the
    ``level`` asked (cluster, indices or shards)."""
    names = node.resolve_index_names(req.param("index", "_all"))
    sections = _stats_sections(req)
    level = req.param("level", "indices")
    if level not in ("cluster", "indices", "shards"):
        raise IllegalArgumentException(
            f"level parameter must be one of [cluster] or [indices] or "
            f"[shards] but was [{level}]")
    groups_param = req.param("groups")
    types_param = req.param("types")

    def shape(stats_pair):
        out = {}
        for side in ("primaries", "total"):
            side_out = {}
            for key, val in stats_pair[side].items():
                if sections is not None and key not in sections:
                    continue
                val = dict(val) if isinstance(val, dict) else val
                if key == "search" and isinstance(val, dict):
                    kept = _filter_named(val.pop("groups", None), groups_param)
                    if kept:
                        val["groups"] = kept
                if key == "indexing" and isinstance(val, dict):
                    kept = _filter_named(val.pop("types", None), types_param)
                    if kept:
                        val["types"] = kept
                side_out[key] = val
            out[side] = side_out
        return out

    state = node.cluster_service.state
    indices = {}
    shards_total = shards_ok = 0
    for name in names:
        svc = node.indices[name]
        # total counts every copy, the unassigned replicas too
        shards_total += svc.num_shards * (1 + state.indices[name].num_replicas)
        shards_ok += svc.num_shards
        raw = svc.stats()
        if req.bool_param("include_segment_file_sizes"):
            for side in ("primaries", "total"):
                seg = raw[side].get("segments")
                if seg is not None:
                    seg["file_sizes"] = {"postings": {
                        "size_in_bytes": seg.get("memory_in_bytes", 0),
                        "description": "block-packed postings arrays"}}
        entry = shape(raw)
        if level == "shards":
            entry["shards"] = {str(sid): [{
                k: v for k, v in s.items()
                if sections is None or k in sections
                or k in ("routing", "commit", "seq_no")}]
                for sid, s in raw["shards"].items()}
        indices[name] = entry
    resp = {
        "_shards": {"total": shards_total, "successful": shards_ok,
                    "failed": 0},
        "_all": {
            "primaries": _sum_stats([i["primaries"] for i in indices.values()]),
            "total": _sum_stats([i["total"] for i in indices.values()]),
        },
    }
    if level != "cluster":
        resp["indices"] = indices
    return 200, resp


def _segments(node, req):
    indices = {}
    total = 0
    for name in node.resolve_index_names(req.param("index", "_all")):
        shards = {}
        for sid, shard in node.indices[name].shards.items():
            shards[str(sid)] = [{"segments": {
                s.name: s.stats() for s in shard.engine.segments}}]
            total += 1
        indices[name] = {"shards": shards}
    return 200, {"indices": indices,
                 "_shards": {"total": total, "successful": total,
                             "failed": 0}}


def _put_mapping(node, req):
    body = req.json_body({}) or {}
    if "properties" not in body and len(body) == 1:
        body = next(iter(body.values()))  # the typed form {"_doc": {...}}
    return 200, node.put_mapping(req.param("index"), body)


def _put_index_settings(node, req):
    return 200, node.update_index_settings(req.param("index", "_all"),
                                           req.json_body({}) or {})


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


def _render_settings(settings, flat: bool):
    """Settings as a response: ``index.``-prefixed, flat or nested, every
    value a string."""
    if isinstance(settings, dict):
        settings = Settings.from_dict(settings)
    settings = settings.with_index_prefix()
    return _settings_values_as_strings(
        settings.as_dict() if flat else settings.as_nested_dict())


def _update_aliases(node, req):
    body = req.json_body({}) or {}
    return 200, node.update_aliases(body.get("actions", []))


def _get_alias(node, req):
    state = node.cluster_service.state
    name_filter = req.param("name")
    patterns = ([p for p in str(name_filter).split(",") if p]
                if name_filter and name_filter != "_all" else None)
    out = {}
    for idx in node.resolve_index_names(req.param("index", "_all")):
        aliases = state.indices[idx].aliases
        if patterns is not None:
            aliases = {a: v for a, v in aliases.items()
                       if any(fnmatch.fnmatchcase(a, p) for p in patterns)}
            if not aliases:
                continue
        out[idx] = {"aliases": aliases}
    if patterns is not None:
        # a named (not wildcard) alias that matched nothing is a 404; the
        # body still carries what did match
        found = {a for v in out.values() for a in v["aliases"]}
        missing = [p for p in patterns if "*" not in p and p not in found]
        if missing:
            return 404, {**out, "error": f"aliases {missing} missing",
                         "status": 404}
    return 200, out


def _put_alias(node, req):
    spec = req.json_body({}) or {}
    return 200, node.update_aliases([{"add": {
        "index": req.param("index"), "alias": req.param("name"), **spec}}])


def _delete_alias(node, req):
    return 200, node.update_aliases([{"remove": {
        "index": req.param("index"), "alias": req.param("name")}}])


def _head_alias(node, req):
    state = node.cluster_service.state
    index = req.param("index")
    names = node.resolve_index_names(index) if index else list(state.indices)
    found = any(req.param("name") in state.indices[n].aliases for n in names)
    return (200 if found else 404), {}


def _put_template(node, req):
    name = req.param("name")
    if req.bool_param("create") and \
            name in node.cluster_service.state.templates:
        raise IllegalArgumentException(
            f"index_template [{name}] already exists")
    return 200, node.put_template(name, req.json_body({}) or {})


def _get_template(node, req):
    templates = node.cluster_service.state.templates
    name = req.param("name")
    flat = req.bool_param("flat_settings")

    def render(t):
        t = dict(t)
        if "settings" in t:
            t["settings"] = _render_settings(t["settings"] or {}, flat)
        if t.get("aliases"):
            # an alias's routing shows as index_routing and search_routing
            out = {}
            for a, spec in t["aliases"].items():
                spec = dict(spec or {})
                routing = spec.pop("routing", None)
                if routing is not None:
                    spec.setdefault("index_routing", routing)
                    spec.setdefault("search_routing", routing)
                out[a] = spec
            t["aliases"] = out
        return t

    if name:
        matched = {k: render(v) for k, v in templates.items()
                   if fnmatch.fnmatchcase(k, name)}
        if not matched:
            return 404, {"error": f"index_template [{name}] missing",
                         "status": 404}
        return 200, matched
    return 200, {k: render(v) for k, v in templates.items()}


def _head_template(node, req):
    found = req.param("name") in node.cluster_service.state.templates
    return (200 if found else 404), {}


# ---------------------------------------------------------------------------
# Cluster admin
# ---------------------------------------------------------------------------


def _cluster_state(node, req):
    return 200, node.cluster_service.state.to_dict()


def _get_cluster_settings(node, req):
    state = node.cluster_service.state
    return 200, {
        "persistent": state.persistent_settings.as_nested_dict(),
        "transient": state.transient_settings.as_nested_dict(),
    }


# ---------------------------------------------------------------------------
# cat API
# ---------------------------------------------------------------------------


def _allocation_explain(node, req):
    """Every marked (index, shard) copy: a corrupted copy is unusable for
    allocation until it is re-recovered from a healthy copy."""
    corrupted = []
    for name, svc in node.indices.items():
        for sid, shard in svc.shards.items():
            store = shard.engine.store  # None: a shard without a data path
            for marker in store.corruption_markers() if store else []:
                corrupted.append({
                    "index": name, "shard": sid,
                    "marker": marker.get("marker", "corrupted"),
                    "site": marker.get("site", "load"),
                    "reason": marker.get("reason", ""),
                })
    out = {
        "note": "single-node cluster: all primaries allocated locally",
        "can_allocate": "yes",
    }
    if corrupted:
        out["can_allocate"] = "no"
        out["note"] = ("corrupted store copies are unusable for "
                       "allocation until re-recovered from a healthy "
                       "copy (docs/RESILIENCE.md \"Data integrity\")")
        out["corrupted_copies"] = corrupted
    return 200, out


def _cat_allocation(node, req):
    n_shards = sum(s.num_shards for s in node.indices.values())
    fs = monitor.fs_stats(node.data_path if node.persistent_path else ".")
    tot = fs.get("total", {})
    total_b = tot.get("total_in_bytes", 0)
    free_b = tot.get("free_in_bytes", 0)
    used_b = max(total_b - free_b, 0)
    rows = [[n_shards, "0b", f"{used_b // (1 << 30)}gb",
             f"{free_b // (1 << 30)}gb", f"{total_b // (1 << 30)}gb",
             int(used_b * 100 / total_b) if total_b else 0,
             "127.0.0.1", "127.0.0.1", node.node_name]]
    return _cat_table(req, rows, ["shards", "disk.indices", "disk.used",
                                  "disk.avail", "disk.total", "disk.percent",
                                  "host", "ip", "node"])


def _cat_recovery(node, req):
    """Per shard copy: the local store recoveries, then every tracked
    recovery (store rows of cold boots, the cluster's peer recoveries:
    stage init -> index -> translog -> finalize -> done, the file, byte
    and op progress, source -> target)."""
    from elasticsearch_tpu_torch.index.recovery_progress import (
        recovery_progress_rows,
    )

    def pct(done, total):
        if not total:
            return "100.0%" if done == total else "0.0%"
        return f"{min(done / total, 1.0) * 100:.1f}%"

    rows = []
    for name, svc in node.indices.items():
        for sid in svc.shards:
            rows.append([name, sid, "0ms", "store", "done", "-",
                         node.node_name, 0, "100.0%", "0b", "100.0%",
                         0, 0, "100.0%"])
    now_ms = int(time.time() * 1000)
    for r in recovery_progress_rows():
        took_ms = (r["stop_ms"] or now_ms) - (r["start_ms"] or now_ms)
        rows.append([
            r["index"], r["shard"], f"{max(took_ms, 0)}ms", r["type"],
            r["stage"], r["source"] or "-", r["target"],
            r["files_total"],
            pct(r["files_recovered"], r["files_total"]),
            f"{r['bytes_total']}b",
            pct(r["bytes_recovered"], r["bytes_total"]),
            r["ops_total"], r["ops_recovered"],
            pct(r["ops_recovered"], r["ops_total"]),
        ])
    return _cat_table(req, rows, [
        "index", "shard", "time", "type", "stage", "source_node",
        "target_node", "files", "files_percent", "bytes",
        "bytes_percent", "translog_ops", "translog_ops_recovered",
        "translog_ops_percent"])


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
    state = node.cluster_service.state
    rows = []
    for name in node.resolve_index_names(req.param("index", "_all")):
        svc = node.indices[name]
        segments = [seg for shard in svc.shards.values()
                    for seg in shard.engine.segments]
        deleted = sum(seg.num_docs - seg.live_doc_count for seg in segments)
        store = sum(seg.memory_bytes() for seg in segments)
        md = state.indices[name]
        rows.append([
            "green" if md.num_replicas == 0 else "yellow", md.state, name,
            svc.uuid, md.num_shards, md.num_replicas, svc.num_docs(),
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


def _cat_tasks(node, req):
    rows = []
    for data in node.tasks.list_tasks()["nodes"].values():
        for tid, t in data["tasks"].items():
            rows.append([t["action"], tid, "-", t["type"],
                         t["start_time_in_millis"],
                         t["running_time_in_nanos"]])
    return _cat_table(req, rows, ["action", "task_id", "parent_task_id",
                                  "type", "start_time", "running_time"])


def _cat_repositories(node, req):
    rows = [[name, body.get("type", "fs")]
            for name, body in node.cluster_service.state.repositories.items()]
    return _cat_table(req, rows, ["id", "type"])


def _cat_snapshots(node, req):
    snaps = node.snapshots.get_snapshot(req.param("repo"))["snapshots"]
    rows = []
    for s in snaps:
        t0 = int(s.get("start_time_in_millis", 0) // 1000)
        t1 = int(s.get("end_time_in_millis", 0) // 1000)
        ns = s.get("shards_total", len(s["indices"]))
        rows.append([s["snapshot"], s["state"], t0,
                     time.strftime("%H:%M:%S", time.gmtime(t0)), t1,
                     time.strftime("%H:%M:%S", time.gmtime(t1)),
                     f"{max(t1 - t0, 0)}s", len(s["indices"]),
                     ns, 0, ns, "-"])
    return _cat_table(req, rows, ["id", "status", "start_epoch",
                                  "start_time", "end_epoch", "end_time",
                                  "duration", "indices", "successful_shards",
                                  "failed_shards", "total_shards", "reason"])


def _cat_shards(node, req):
    rows = []
    for name in node.resolve_index_names(req.param("index", "_all")):
        for sid, shard in node.indices[name].shards.items():
            store = shard.stats()["segments"]["memory_in_bytes"]
            # the integrity column: the newest corruption marker's name,
            # "-" for a healthy (or store-less) copy
            markers = (shard.engine.store.corruption_markers()
                       if shard.engine.store is not None else [])
            integrity = (markers[0].get("marker", "corrupted")
                         if markers else "-")
            rows.append([name, sid, "p", shard.state, shard.num_docs,
                         f"{store}b", "127.0.0.1", node.node_name,
                         integrity])
    return _cat_table(req, rows, ["index", "shard", "prirep", "state", "docs",
                                  "store", "ip", "node", "integrity"])


def _cat_aliases(node, req):
    rows = []
    for name, md in node.cluster_service.state.indices.items():
        for alias, spec in md.aliases.items():
            spec = spec or {}
            routing = spec.get("routing")
            rows.append([
                alias, name, "*" if spec.get("filter") else "-",
                spec.get("index_routing") or routing or "-",
                spec.get("search_routing") or routing or "-",
            ])
    return _cat_table(req, rows, ["alias", "index", "filter", "routing.index",
                                  "routing.search"])


def _cat_templates(node, req):
    pat = req.param("name")
    rows = []
    for name, t in node.cluster_service.state.templates.items():
        if pat and not fnmatch.fnmatchcase(name, pat):
            continue
        rows.append([name, "[" + ", ".join(t.get("index_patterns", [])) + "]",
                     t.get("order", 0), t.get("version", "")])
    return _cat_table(req, rows, ["name", "index_patterns", "order", "version"])


def _cat_segments(node, req):
    rows = []
    for name, svc in node.indices.items():
        for sid, shard in svc.shards.items():
            for seg in shard.engine.segments:
                st = seg.stats()
                rows.append([name, sid, "p", "127.0.0.1", node.node_id,
                             seg.name, 1, st["num_docs"], st["deleted_docs"],
                             f"{st['memory_in_bytes']}b",
                             f"{st['memory_in_bytes']}b", "true", "true",
                             __version__, "false"])
    return _cat_table(req, rows, ["index", "shard", "prirep", "ip", "id",
                                  "segment", "generation", "docs.count",
                                  "docs.deleted", "size", "size.memory",
                                  "committed", "searchable", "version",
                                  "compound"])
