"""Value-with-unit parsing: durations and byte sizes.

Counterpart of ``elasticsearch_tpu/common/units.py``, copied but for its
imports; ``common/settings.py`` parses its time and byte settings here.

Role model: ``TimeValue`` / ``ByteSizeValue``
(core/src/main/java/org/elasticsearch/common/unit/). Settings like
``index.refresh_interval: "1s"`` and ``indices.breaker.total.limit: "70%"``
flow through these parsers.
"""

from __future__ import annotations

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

_TIME_UNITS = {
    "nanos": 1e-9,
    "micros": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
    "d": 86400.0,
}

_BYTE_UNITS = {
    "b": 1,
    "kb": 1024,
    "mb": 1024**2,
    "gb": 1024**3,
    "tb": 1024**4,
    "pb": 1024**5,
}


def parse_time_value(value, setting_name: str = "") -> float:
    """Parse '30s' / '1m' / '500ms' / -1 into seconds (float). -1 => -1.0."""
    if isinstance(value, (int, float)):
        if value == -1:
            return -1.0
        raise IllegalArgumentException(
            f"failed to parse setting [{setting_name}] with value [{value}] as a time "
            "value: unit is missing or unrecognized"
        )
    s = str(value).strip().lower()
    if s in ("-1", "-1ms"):
        return -1.0
    for unit in sorted(_TIME_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            num = s[: -len(unit)].strip()
            try:
                return float(num) * _TIME_UNITS[unit]
            except ValueError:
                break
    raise IllegalArgumentException(
        f"failed to parse setting [{setting_name}] with value [{value}] as a time value"
    )


def format_time_value(seconds: float) -> str:
    if seconds == -1.0:
        return "-1"
    if seconds >= 1 and seconds == int(seconds):
        return f"{int(seconds)}s"
    ms = seconds * 1000.0
    if ms == int(ms):
        return f"{int(ms)}ms"
    return f"{ms}ms"


def parse_byte_size(value, setting_name: str = "") -> int:
    """Parse '10gb' / '512mb' / bare int (bytes) into bytes."""
    if isinstance(value, int) and not isinstance(value, bool):
        return value
    s = str(value).strip().lower()
    if s == "-1":
        return -1
    for unit in sorted(_BYTE_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            num = s[: -len(unit)].strip()
            try:
                return int(float(num) * _BYTE_UNITS[unit])
            except ValueError:
                break
    try:
        return int(s)
    except ValueError:
        raise IllegalArgumentException(
            f"failed to parse setting [{setting_name}] with value [{value}] as a size "
            "in bytes"
        ) from None


def parse_ratio_or_bytes(value, total: int, setting_name: str = "") -> int:
    """Parse '70%' against a total, or an absolute byte size."""
    s = str(value).strip()
    if s.endswith("%"):
        try:
            pct = float(s[:-1])
        except ValueError:
            raise IllegalArgumentException(
                f"failed to parse [{value}] as a percentage for [{setting_name}]"
            ) from None
        return int(total * pct / 100.0)
    return parse_byte_size(value, setting_name)
