"""Distance units (counterpart of the unit table in
``elasticsearch_tpu/utils/geometry.py``).

One table serves the ``geo_distance`` query's ``distance`` and the
``_geo_distance`` sort's ``unit``. The shapes of that module wait for
``geo_shape``.
"""

from __future__ import annotations

_DISTANCE_UNITS = {
    "m": 1.0, "meters": 1.0, "km": 1000.0, "kilometers": 1000.0,
    "mi": 1609.344, "miles": 1609.344, "yd": 0.9144, "ft": 0.3048,
    "in": 0.0254, "cm": 0.01, "mm": 0.001, "nmi": 1852.0, "nm": 1852.0,
}


def _parse_radius(value) -> float:
    """'10km', '500m' or a number of meters -> meters."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().lower()
    for unit in sorted(_DISTANCE_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            return float(s[: -len(unit)]) * _DISTANCE_UNITS[unit]
    return float(s)
