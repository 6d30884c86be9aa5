"""Ingest pipelines: document preprocessing before indexing.

Counterpart of ``elasticsearch_tpu/ingest/pipeline.py``, a copy but for
its imports. The common processors (set, remove, rename, convert,
lowercase/uppercase, trim, split, join, gsub, append, json, kv, date over
``mapper/field_types.py``'s ``parse_date`` and ``format_epoch_millis``,
fail, drop, dot_expander, grok, script over ``script/``) and the geoip
and user_agent processors of ``geo_ua.py``; a processor's or the
pipeline's ``on_failure`` handlers. Pipelines live in the cluster state
(``ingest_pipelines``, kept in the global ``_state`` of a durable node)
and run on the host on the write path: ``Node.index_doc(pipeline=...)``
and ``Node.bulk`` (request-level or per item). ``IngestService.simulate``
serves ``_ingest/pipeline/_simulate``.
"""

from __future__ import annotations

import datetime as _dt
import json
import re
from typing import Optional

from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuException,
    IllegalArgumentException,
    ResourceNotFoundException,
)


class IngestProcessorException(ElasticsearchTpuException):
    status_code = 500


class IngestDocument:
    """Mutable doc view with dotted-path access + ingest metadata
    (ingest/IngestDocument.java)."""

    def __init__(self, source: dict, doc_id: Optional[str], index: Optional[str]):
        self.source = source
        self.meta = {"_id": doc_id, "_index": index}
        self.dropped = False

    def get(self, path: str, default=None):
        if path.startswith("_ingest."):
            if path == "_ingest.timestamp":
                return _dt.datetime.now(_dt.timezone.utc).isoformat()
        if path in self.meta:
            return self.meta[path]
        node = self.source
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def has(self, path: str) -> bool:
        sentinel = object()
        return self.get(path, sentinel) is not sentinel

    def set(self, path: str, value) -> None:
        if path in ("_id", "_index"):
            self.meta[path] = value
            return
        parts = path.split(".")
        node = self.source
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = value

    def remove(self, path: str) -> None:
        parts = path.split(".")
        node = self.source
        for p in parts[:-1]:
            node = node.get(p)
            if not isinstance(node, dict):
                return
        node.pop(parts[-1], None)

    def render(self, template: str):
        """{{field}} template substitution (mustache-lite)."""
        def sub(m):
            v = self.get(m.group(1).strip())
            return "" if v is None else str(v)

        return re.sub(r"\{\{(.*?)\}\}", sub, template)


# ---------------------------------------------------------------------------
# Processors
# ---------------------------------------------------------------------------


def _p_set(cfg, doc: IngestDocument):
    field = cfg["field"]
    if not cfg.get("override", True) and doc.has(field):
        return
    value = cfg.get("value")
    if isinstance(value, str):
        value = doc.render(value)
    doc.set(field, value)


def _p_remove(cfg, doc):
    fields = cfg["field"]
    for f in fields if isinstance(fields, list) else [fields]:
        if not doc.has(f) and not cfg.get("ignore_missing", False):
            raise IngestProcessorException(f"field [{f}] not present as part of path [{f}]")
        doc.remove(f)


def _p_rename(cfg, doc):
    src, dst = cfg["field"], cfg["target_field"]
    if not doc.has(src):
        if cfg.get("ignore_missing", False):
            return
        raise IngestProcessorException(f"field [{src}] doesn't exist")
    doc.set(dst, doc.get(src))
    doc.remove(src)


def _p_convert(cfg, doc):
    field = cfg["field"]
    target = cfg.get("target_field", field)
    typ = cfg["type"]
    v = doc.get(field)
    if v is None:
        if cfg.get("ignore_missing", False):
            return
        raise IngestProcessorException(f"field [{field}] is null or missing")
    try:
        if typ == "integer":
            v = int(v)
        elif typ == "long":
            v = int(v)
        elif typ == "float" or typ == "double":
            v = float(v)
        elif typ == "boolean":
            v = str(v).lower() == "true"
        elif typ == "string":
            v = str(v)
        elif typ == "auto":
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except (TypeError, ValueError):
                    continue
    except (TypeError, ValueError) as e:
        raise IngestProcessorException(
            f"unable to convert [{v}] to {typ}"
        ) from e
    doc.set(target, v)


def _p_case(upper: bool):
    def run(cfg, doc):
        f = cfg["field"]
        v = doc.get(f)
        if v is None:
            if cfg.get("ignore_missing", False):
                return
            raise IngestProcessorException(f"field [{f}] is null or missing")
        doc.set(cfg.get("target_field", f), str(v).upper() if upper else str(v).lower())

    return run


def _p_trim(cfg, doc):
    f = cfg["field"]
    v = doc.get(f)
    if v is not None:
        doc.set(cfg.get("target_field", f), str(v).strip())


def _p_split(cfg, doc):
    f = cfg["field"]
    v = doc.get(f)
    if v is None:
        if cfg.get("ignore_missing", False):
            return
        raise IngestProcessorException(f"field [{f}] is null or missing")
    doc.set(cfg.get("target_field", f), re.split(cfg["separator"], str(v)))


def _p_join(cfg, doc):
    f = cfg["field"]
    v = doc.get(f)
    if isinstance(v, list):
        doc.set(cfg.get("target_field", f), cfg["separator"].join(str(x) for x in v))


def _p_gsub(cfg, doc):
    f = cfg["field"]
    v = doc.get(f)
    if v is not None:
        doc.set(cfg.get("target_field", f),
                re.sub(cfg["pattern"], cfg["replacement"], str(v)))


def _p_append(cfg, doc):
    f = cfg["field"]
    v = doc.get(f)
    add = cfg["value"]
    add = add if isinstance(add, list) else [add]
    add = [doc.render(x) if isinstance(x, str) else x for x in add]
    if v is None:
        doc.set(f, list(add))
    elif isinstance(v, list):
        v.extend(add)
    else:
        doc.set(f, [v] + list(add))


def _p_json(cfg, doc):
    f = cfg["field"]
    v = doc.get(f)
    try:
        parsed = json.loads(v)
    except (TypeError, json.JSONDecodeError) as e:
        raise IngestProcessorException(f"field [{f}] is not valid JSON") from e
    if cfg.get("add_to_root", False) and isinstance(parsed, dict):
        doc.source.update(parsed)
    else:
        doc.set(cfg.get("target_field", f), parsed)


def _p_kv(cfg, doc):
    f = cfg["field"]
    v = doc.get(f)
    if v is None:
        return
    target = cfg.get("target_field")
    for pair in str(v).split(cfg["field_split"]):
        if cfg["value_split"] in pair:
            k, val = pair.split(cfg["value_split"], 1)
            doc.set(f"{target}.{k}" if target else k, val)


def _p_date(cfg, doc):
    from elasticsearch_tpu_torch.mapper.field_types import format_epoch_millis, parse_date

    f = cfg["field"]
    v = doc.get(f)
    formats = cfg.get("formats") or ["ISO8601"]
    millis = None
    for fmt in formats:
        try:
            if fmt in ("ISO8601", "UNIX", "UNIX_MS", "epoch_millis"):
                millis = parse_date(v)
                if fmt == "UNIX":
                    millis = int(float(v) * 1000)
            else:
                millis = parse_date(v, [fmt])
            break
        except Exception:
            continue
    if millis is None:
        raise IngestProcessorException(
            f"unable to parse date [{v}] with formats {formats}"
        )
    doc.set(cfg.get("target_field", "@timestamp"), format_epoch_millis(millis))


def _p_fail(cfg, doc):
    raise IngestProcessorException(doc.render(cfg.get("message", "Fail processor executed")))


def _p_drop(cfg, doc):
    doc.dropped = True


def _p_dot_expander(cfg, doc):
    f = cfg["field"]
    if f in doc.source and "." in f:
        v = doc.source.pop(f)
        doc.set(f, v)


_GROK_PATTERNS = {
    "WORD": r"\w+",
    "NUMBER": r"(?:[+-]?(?:\d+(?:\.\d+)?))",
    "INT": r"[+-]?\d+",
    "IP": r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}",
    "DATA": r".*?",
    "GREEDYDATA": r".*",
    "NOTSPACE": r"\S+",
    "SPACE": r"\s*",
    "USERNAME": r"[a-zA-Z0-9._-]+",
    "TIMESTAMP_ISO8601": r"\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}:\d{2}(?:\.\d+)?(?:Z|[+-]\d{2}:?\d{2})?",
    "LOGLEVEL": r"(?:DEBUG|INFO|WARN|ERROR|FATAL|TRACE)",
    "HTTPMETHOD": r"(?:GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH)",
}


def _grok_to_regex(pattern: str):
    """-> (regex string, {group_name: type}) — supports %{NAME:field:type}."""
    types: dict = {}

    def sub(m):
        name, field, typ = m.group(1), m.group(3), m.group(5)
        base = _GROK_PATTERNS.get(name)
        if base is None:
            raise IllegalArgumentException(f"Unable to find pattern [{name}] in Grok's pattern dictionary")
        if field:
            group = field.replace(".", "__DOT__")
            if typ:
                types[group] = typ
            return f"(?P<{group}>{base})"
        return f"(?:{base})"

    return re.sub(r"%\{(\w+)(:([\w.]+?))?(:(\w+))?\}", sub, pattern), types


def _p_grok(cfg, doc):
    f = cfg["field"]
    v = doc.get(f)
    if v is None:
        if cfg.get("ignore_missing", False):
            return
        raise IngestProcessorException(f"field [{f}] is null or missing")
    for pattern in cfg["patterns"]:
        regex, types = _grok_to_regex(pattern)
        m = re.compile(regex).search(str(v))
        if m:
            for name, val in m.groupdict().items():
                if val is None:
                    continue
                typ = types.get(name)
                if typ == "int":
                    val = int(float(val))
                elif typ == "float":
                    val = float(val)
                doc.set(name.replace("__DOT__", "."), val)
            return
    raise IngestProcessorException(f"Provided Grok expressions do not match field value: [{v}]")


def _p_uppercase(cfg, doc):
    _p_case(True)(cfg, doc)


def _p_script(cfg, doc):
    """Script processor (ingest/common/ScriptProcessor.java): the painless
    script mutates ``ctx`` in place. Like the reference's
    getSourceAndMetadata, ctx exposes the source AND the _index/_id
    metadata keys; metadata writes flow back to the document metadata,
    not into the stored source."""
    from elasticsearch_tpu_torch.script.expression import compile_script

    # accept both config shapes: {source, lang, params} inline, or the
    # nested {"script": {source, lang, params}} form
    nested = cfg.get("script") if isinstance(cfg.get("script"), dict) else {}
    spec = {k: v for k, v in {**nested, **cfg}.items()
            if k in ("source", "inline", "lang", "id")}
    params = cfg.get("params") or nested.get("params") or {}
    script = compile_script(spec)
    run = getattr(script, "run", None)
    if run is None:  # numeric expression engine: no ctx mutation surface
        raise IngestProcessorException(
            "script processor requires a painless script")
    ctx = doc.source
    saved = {k: ctx.get(k) for k in ("_index", "_id") if k in ctx}
    ctx.update(doc.meta)
    try:
        run({"ctx": ctx, "params": dict(params)})
    finally:
        for k in ("_index", "_id"):
            value = ctx.pop(k, None)
            if value != doc.meta.get(k):
                doc.meta[k] = value
        ctx.update(saved)  # a source field literally named _index/_id


PROCESSORS = {
    "script": _p_script,
    "set": _p_set,
    "remove": _p_remove,
    "rename": _p_rename,
    "convert": _p_convert,
    "lowercase": _p_case(False),
    "uppercase": _p_case(True),
    "trim": _p_trim,
    "split": _p_split,
    "join": _p_join,
    "gsub": _p_gsub,
    "append": _p_append,
    "json": _p_json,
    "kv": _p_kv,
    "date": _p_date,
    "fail": _p_fail,
    "drop": _p_drop,
    "dot_expander": _p_dot_expander,
    "grok": _p_grok,
}

# geoip + user_agent ship as plugins in the reference (ingest-geoip,
# ingest-user-agent); registered here as always-available processors
from elasticsearch_tpu_torch.ingest.geo_ua import (  # noqa: E402
    geoip_processor,
    user_agent_processor,
)

PROCESSORS["geoip"] = geoip_processor
PROCESSORS["user_agent"] = user_agent_processor


class Pipeline:
    def __init__(self, pipeline_id: str, body: dict):
        self.pipeline_id = pipeline_id
        self.description = body.get("description", "")
        self.processors = body.get("processors") or []
        self.on_failure = body.get("on_failure") or []
        for proc in self.processors:
            ((ptype, _),) = proc.items()
            if ptype not in PROCESSORS:
                raise IllegalArgumentException(
                    f"No processor type exists with name [{ptype}]"
                )

    def run(self, doc: IngestDocument) -> IngestDocument:
        for proc in self.processors:
            ((ptype, cfg),) = proc.items()
            try:
                PROCESSORS[ptype](cfg or {}, doc)
                if doc.dropped:
                    return doc
            except Exception as e:
                handlers = (cfg or {}).get("on_failure") or self.on_failure
                if not handlers and not (cfg or {}).get("ignore_failure"):
                    raise
                doc.set("_ingest.on_failure_message", str(e))
                for h in handlers:
                    ((htype, hcfg),) = h.items()
                    PROCESSORS[htype](hcfg or {}, doc)
        return doc


class IngestService:
    def __init__(self, node):
        self.node = node

    def put_pipeline(self, pipeline_id: str, body: dict) -> dict:
        Pipeline(pipeline_id, body)  # validate

        def update(state):
            new = state.copy()
            new.ingest_pipelines[pipeline_id] = body
            return new

        self.node.cluster_service.submit_state_update_task(
            f"put-pipeline [{pipeline_id}]", update
        )
        return {"acknowledged": True}

    def get_pipeline(self, pipeline_id: Optional[str] = None) -> dict:
        pipelines = self.node.cluster_service.state.ingest_pipelines
        if pipeline_id in (None, "*", "_all"):
            return dict(pipelines)
        if pipeline_id not in pipelines:
            raise ResourceNotFoundException(f"pipeline [{pipeline_id}] is missing")
        return {pipeline_id: pipelines[pipeline_id]}

    def delete_pipeline(self, pipeline_id: str) -> dict:
        if pipeline_id not in self.node.cluster_service.state.ingest_pipelines:
            raise ResourceNotFoundException(f"pipeline [{pipeline_id}] is missing")

        def update(state):
            new = state.copy()
            new.ingest_pipelines.pop(pipeline_id, None)
            return new

        self.node.cluster_service.submit_state_update_task(
            f"delete-pipeline [{pipeline_id}]", update
        )
        return {"acknowledged": True}

    def run_pipeline(self, pipeline_id: str, source: dict, doc_id, index) -> Optional[dict]:
        body = self.node.cluster_service.state.ingest_pipelines.get(pipeline_id)
        if body is None:
            raise IllegalArgumentException(f"pipeline with id [{pipeline_id}] does not exist")
        doc = IngestDocument(dict(source), doc_id, index)
        Pipeline(pipeline_id, body).run(doc)
        if doc.dropped:
            return None
        return doc.source

    def simulate(self, body: dict) -> dict:
        """_ingest/pipeline/_simulate."""
        pipeline_body = body.get("pipeline")
        if pipeline_body is None:
            pid = body.get("id")
            pipeline_body = self.get_pipeline(pid)[pid]
        pipeline = Pipeline("_simulate", pipeline_body)
        docs_out = []
        for d in body.get("docs", []):
            doc = IngestDocument(dict(d.get("_source", {})), d.get("_id"), d.get("_index"))
            try:
                pipeline.run(doc)
                docs_out.append({"doc": {
                    "_source": doc.source,
                    "_id": doc.meta.get("_id"),
                    "_index": doc.meta.get("_index"),
                }})
            except Exception as e:
                docs_out.append({"error": {"type": type(e).__name__, "reason": str(e)}})
        return {"docs": docs_out}
