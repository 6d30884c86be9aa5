"""Exception taxonomy with REST status codes (subset of the search path).

Counterpart of ``elasticsearch_tpu/common/errors.py``: every failure maps
to an HTTP status and serializes to ``{"error": {"type", "reason"}}``.
"""

from __future__ import annotations


def es_type_name(class_name: str) -> str:
    """CamelCase -> snake_case, mirroring ES "type" strings like
    "index_not_found_exception"."""
    out = []
    for i, ch in enumerate(class_name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


class ElasticsearchTpuException(Exception):
    """Base for all engine errors; carries an HTTP status."""

    status_code = 500

    def __init__(self, reason: str, **metadata):
        super().__init__(reason)
        self.reason = reason
        self.metadata = metadata

    @property
    def error_type(self) -> str:
        return es_type_name(type(self).__name__)

    def to_dict(self) -> dict:
        err = {"type": self.error_type, "reason": self.reason}
        err.update(self.metadata)
        cause = self.__cause__
        if isinstance(cause, ElasticsearchTpuException):
            err["caused_by"] = cause.to_dict()
        elif cause is not None:
            err["caused_by"] = {"type": type(cause).__name__, "reason": str(cause)}
        return {"error": err, "status": self.status_code}


class IndexNotFoundException(ElasticsearchTpuException):
    status_code = 404

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index)


class IndexAlreadyExistsException(ElasticsearchTpuException):
    status_code = 400

    def __init__(self, index: str):
        super().__init__(f"index [{index}] already exists", index=index)


class DocumentMissingException(ElasticsearchTpuException):
    """An update of a document that does not exist and has no upsert
    (404)."""

    status_code = 404

    def __init__(self, index: str, doc_id: str):
        super().__init__(f"[{index}]: document missing [{doc_id}]", index=index)


class ParsingException(ElasticsearchTpuException):
    """Malformed query DSL / request body (ES: ParsingException, 400)."""

    status_code = 400


class ScriptException(ParsingException):
    """A script failed to compile or run (``script/painless.py``): a 400,
    as the reference's script_exception."""


class QueryShardException(ElasticsearchTpuException):
    """Query cannot execute against this shard's mapping (ES: 400)."""

    status_code = 400


class QueryPhaseExecutionException(ElasticsearchTpuException):
    """The query phase failed executing (500): a slice count over
    ``index.max_slices_per_scroll``."""

    status_code = 500


class MapperParsingException(ElasticsearchTpuException):
    status_code = 400


class IllegalArgumentException(ElasticsearchTpuException):
    status_code = 400


class ActionRequestValidationException(ElasticsearchTpuException):
    status_code = 400


class VersionConflictEngineException(ElasticsearchTpuException):
    """Optimistic concurrency failure (ES: 409)."""

    status_code = 409

    def __init__(self, doc_id: str, current_version: int, expected: int):
        super().__init__(
            f"[{doc_id}]: version conflict, current version [{current_version}] "
            f"is different than the one provided [{expected}]"
        )


class RoutingMissingException(ElasticsearchTpuException):
    """A single-doc op on a ``_parent``-mapped type without routing or
    parent (400)."""

    status_code = 400

    def __init__(self, doc_type: str, doc_id: str):
        super().__init__(
            f"routing is required for [{doc_type}]/[{doc_id}]")


class InvalidIndexNameException(ElasticsearchTpuException):
    status_code = 400

    def __init__(self, index: str, reason: str):
        super().__init__(f"Invalid index name [{index}], {reason}", index=index)


class ResourceNotFoundException(ElasticsearchTpuException):
    status_code = 404


class ResourceAlreadyExistsException(ElasticsearchTpuException):
    status_code = 400


class CorruptedSnapshotException(ElasticsearchTpuException):
    """Snapshot blob bytes no longer match the per-file digests the
    create recorded in the manifest: the restore of that index fails
    rather than install unverified bytes."""

    status_code = 500


class EsRejectedExecutionException(ElasticsearchTpuException):
    """A named thread pool's queue is full: HTTP 429
    (RestStatus.TOO_MANY_REQUESTS). ``retry_after_s``, where set, becomes
    the response's Retry-After header."""

    status_code = 429


class NodeDrainingException(ElasticsearchTpuException):
    """The node is draining for a restart: new searches get a clean 503,
    and ``retry_after_s`` becomes the Retry-After header, as on a 429;
    searches in flight finish within the drain deadline."""

    status_code = 503


class CircuitBreakingException(ElasticsearchTpuException):
    """A memory circuit breaker tripped (``common/breaker.py``): HTTP 429."""

    status_code = 429

    def __init__(self, reason: str, bytes_wanted: int = 0,
                 byte_limit: int = 0):
        super().__init__(reason, bytes_wanted=bytes_wanted,
                         bytes_limit=byte_limit)


class UnavailableShardsException(ElasticsearchTpuException):
    """wait_for_active_shards not met (action/UnavailableShardsException)."""

    status_code = 503


class TaskCancelledException(ElasticsearchTpuException):
    """The request's task was cancelled: raised at the next checkpoint of
    its search deadline (``search/cancellation.py``)."""

    status_code = 400


class TranslogCorruptedException(ElasticsearchTpuException):
    """Unreadable translog data at or below the checkpointed seqno: acked
    (possibly committed) operations cannot be replayed. A torn final line
    of the newest generation is not this: that is an unacked in-flight
    append cut by a crash, which recovery tolerates."""

    status_code = 500


class SearchPhaseExecutionException(ElasticsearchTpuException):
    """Every shard of a search failed, or a failure or timeout met
    ``allow_partial_search_results: false``; ``failed_shards`` lists
    why."""

    status_code = 500

    def __init__(self, phase: str, reason: str, shard_failures=()):
        super().__init__(reason, phase=phase)
        self.shard_failures = list(shard_failures)

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["error"]["failed_shards"] = [
            {"shard": f.get("shard"), "index": f.get("index"),
             "reason": f.get("reason")}
            for f in self.shard_failures]
        return d
