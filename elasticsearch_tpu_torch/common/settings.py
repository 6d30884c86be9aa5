"""Settings: an immutable flat key->value map with typed getters.

Counterpart of ``elasticsearch_tpu/common/settings.py``, cut to what the
index -> refresh -> search path reads: the shard count (default 5,
``INDEX_NUMBER_OF_SHARDS``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException


class Settings:
    """Immutable flat key->value map. Keys are dotted paths
    ("index.number_of_shards"); typed getters coerce."""

    EMPTY: "Settings"

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = dict(data or {})

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "Settings":
        """Flatten a possibly-nested dict into dotted keys."""
        flat: Dict[str, Any] = {}

        def walk(prefix: str, obj):
            for k, v in obj.items():
                if isinstance(v, dict):
                    walk(prefix + k + ".", v)
                else:
                    flat[prefix + k] = v

        walk("", d or {})
        return Settings(flat)

    def with_index_prefix(self) -> "Settings":
        """Bare keys get the ``index.`` prefix (``number_of_shards`` and
        ``index.number_of_shards`` are both accepted)."""
        out = {}
        for k, v in self._data.items():
            if not k.startswith("index.") and k != "index":
                k = "index." + k
            out[k] = v
        return Settings(out)

    def keys(self) -> Iterable[str]:
        return self._data.keys()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self._data.get(key)
        if v is None:
            return default
        try:
            return int(v)
        except (TypeError, ValueError):
            raise IllegalArgumentException(
                f"Failed to parse value [{v}] for setting [{key}]"
            ) from None


Settings.EMPTY = Settings()


class IntSetting:
    """A typed integer setting with a default and bounds."""

    def __init__(self, key: str, default: int, min_value: int, max_value: int):
        self.key = key
        self.default = default
        self.min_value = min_value
        self.max_value = max_value

    def get(self, settings: Settings) -> int:
        v = settings.get_int(self.key, self.default)
        if not self.min_value <= v <= self.max_value:
            raise IllegalArgumentException(
                f"Failed to parse value [{v}] for setting [{self.key}] must be "
                f"between {self.min_value} and {self.max_value}")
        return v


INDEX_NUMBER_OF_SHARDS = IntSetting("index.number_of_shards", 5, 1, 1024)
