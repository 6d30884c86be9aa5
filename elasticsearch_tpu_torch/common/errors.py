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


class ParsingException(ElasticsearchTpuException):
    """Malformed query DSL / request body (ES: ParsingException, 400)."""

    status_code = 400


class QueryShardException(ElasticsearchTpuException):
    """Query cannot execute against this shard's mapping (ES: 400)."""

    status_code = 400


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
