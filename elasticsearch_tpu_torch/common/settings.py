"""Settings: an immutable flat key->value map with typed getters.

Counterpart of ``elasticsearch_tpu/common/settings.py``, cut to what the
port's path reads, each with the JAX package's default and validator:

- ``index.number_of_shards`` (default 5);
- the mesh data plane: ``index.search.mesh`` (true),
  ``index.search.mesh.max_slots_per_device`` (4, 1..64),
  ``index.search.mesh.plane`` (auto | pallas | scatter) and
  ``index.search.plane_quarantine.cooldown`` (60s);
- the cross-query micro-batcher (node scope, seeded into each index by
  ``Node``): ``search.batch.enabled`` (true), ``search.batch.window_ms``
  (0.2, >= 0) and ``search.batch.max_queries`` (16, 1..64);
- the dense-vector plane: ``search.knn.enabled`` (true) and
  ``search.knn.tile_sub`` (64; one of 8, 16, 32, 64, 128), node scope and
  seeded into each index like ``search.batch.*``, and
  ``index.mapping.dense_vector.max_dims`` (1024, >= 1);
- the tile kernel's postings codec and block-max pruning:
  ``search.pallas.postings_codec`` (raw | packed, default raw; node scope,
  seeded into each index like ``search.batch.*``),
  ``index.search.pallas.postings_codec`` (default | raw | packed; default
  follows the node), ``search.pallas.pruning.enabled`` (false) and
  ``search.pallas.pruning.probe_tiles`` (8; one of 2, 4, 8, 16, 32);
- the memory breakers and the device-memory ledger (node scope):
  ``indices.breaker.{total,request,fielddata}.limit`` (byte sizes; the
  JAX package's "70%" / "60%" of a JVM heap become the absolute
  defaults of ``common/breaker.py``), ``search.memory.hbm_budget_bytes``
  (0 = unlimited) and the staging retry ``search.staging.retry.
  max_attempts`` (3, 1..10) and ``.backoff_ms`` (10.0, >= 0);
- delta staging of the mesh plane (index scope):
  ``index.staging.delta.enabled`` (true) and
  ``index.staging.compact.threshold`` (0.25; <= 0 turns compaction off);
- the scheduled refresh ``index.refresh_interval`` (1s; -1 off),
  ``index.max_result_window`` and ``index.max_slices_per_scroll``;
- the device-side infrastructure: admission (``search.queue.size``
  1000, ``search.admission.*``, ``search.drain.deadline`` 30s,
  ``search.batch.max_window_ms`` 5.0), telemetry's kill switch
  ``search.telemetry.enabled`` (true), the variant registry
  ``search.compile.cache_path`` ("") and ``search.compile.warm_on_start``
  (true), the scrubber ``index.scrub.interval`` (none: off) and the search
  slowlog ``index.search.slowlog.threshold.query.{warn,info}`` (none).

Each ``Setting`` has a scope (node or index) and may be dynamic. The
registries ``cluster_settings()`` and ``index_scoped_settings()``
(``AbstractScopedSettings``) hold every setting the JAX package
registers, with its flags. ``PUT /{index}/_settings`` takes only
registered dynamic keys (``validate_dynamic_update``), create-index
validates the registered keys it is given, and ``PUT _cluster/settings``
stores any key, as the JAX package's does, firing the update consumers.
A setting whose consumer module is not ported yet (the host-only modules
ROADMAP A.6 lists) is stored like any other. The cluster
(``cluster/multinode.py``) reads ``transport.*``, ``discovery.zen.*``,
``cluster.replication.timeout`` and ``indices.recovery.*``.
``Settings.merged_with`` drops a key mapped to None (a cleared cluster
setting).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException
from elasticsearch_tpu_torch.common.units import (  # noqa: F401 (re-exported)
    parse_byte_size,
    parse_time_value,
)


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

    def filtered_by_prefix(self, prefix: str) -> "Settings":
        return Settings({k: v for k, v in self._data.items()
                         if k.startswith(prefix)})

    def merged_with(self, other: "Settings") -> "Settings":
        """``other``'s keys win; a key ``other`` maps to None is removed
        (``PUT _cluster/settings`` clears a setting with a null)."""
        d = dict(self._data)
        for k, v in other._data.items():
            if v is None:
                d.pop(k, None)
            else:
                d[k] = v
        return Settings(d)

    def keys(self) -> Iterable[str]:
        return self._data.keys()

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    def as_nested_dict(self) -> Dict[str, Any]:
        """Dotted keys -> nested dicts (the ``GET /{index}`` shape)."""
        out: Dict[str, Any] = {}
        for key, value in sorted(self._data.items()):
            node = out
            parts = key.split(".")
            for p in parts[:-1]:
                nxt = node.get(p)
                if not isinstance(nxt, dict):
                    nxt = {}
                    node[p] = nxt
                node = nxt
            node[parts[-1]] = value
        return out

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def get_str(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self._data.get(key)
        return default if v is None else str(v)

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

    def get_float(self, key: str,
                  default: Optional[float] = None) -> Optional[float]:
        v = self._data.get(key)
        if v is None:
            return default
        try:
            return float(v)
        except (TypeError, ValueError):
            raise IllegalArgumentException(
                f"Failed to parse value [{v}] for setting [{key}]"
            ) from None

    def get_bool(self, key: str,
                 default: Optional[bool] = None) -> Optional[bool]:
        v = self._data.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        s = str(v).lower()
        if s == "true":
            return True
        if s == "false":
            return False
        raise IllegalArgumentException(
            f"Failed to parse value [{v}] as only [true] or [false] are "
            f"allowed for setting [{key}]")

    def get_list(self, key: str,
                 default: Optional[list] = None) -> Optional[list]:
        """A list value, or a comma-separated string split on commas."""
        v = self._data.get(key)
        if v is None:
            return default
        if isinstance(v, (list, tuple)):
            return list(v)
        return [p.strip() for p in str(v).split(",") if p.strip()]

    def get_time(self, key: str,
                 default: Optional[float] = None) -> Optional[float]:
        v = self._data.get(key)
        return default if v is None else parse_time_value(v, key)

    def get_bytes(self, key: str,
                  default: Optional[int] = None) -> Optional[int]:
        v = self._data.get(key)
        return default if v is None else parse_byte_size(v, key)


Settings.EMPTY = Settings()


class Scope:
    NODE = "node"
    INDEX = "index"


class Setting:
    """A typed setting: key, default, the JAX package's validator (numeric
    bounds or a set of choices), its scope (node or index) and whether
    ``PUT _cluster/settings`` or ``PUT /{index}/_settings`` may change it
    (``dynamic``). ``get`` parses and validates."""

    def __init__(self, key: str, default, kind: str, min_value=None,
                 max_value=None, choices=None, scope: str = Scope.NODE,
                 dynamic: bool = False):
        self.key = key
        self.default = default
        self.kind = kind
        self.min_value = min_value
        self.max_value = max_value
        self.choices = choices
        self.scope = scope
        self.dynamic = dynamic

    def get(self, settings: Settings):
        if self.kind == "int":
            v = settings.get_int(self.key, self.default)
            if self.choices is not None and v not in self.choices:
                raise IllegalArgumentException(
                    f"Failed to parse value [{v}] for setting [{self.key}]: "
                    f"must be one of "
                    f"{', '.join(str(c) for c in sorted(self.choices))}")
        elif self.kind == "float":
            v = settings.get_float(self.key, self.default)
        elif self.kind == "bool":
            return settings.get_bool(self.key, self.default)
        elif self.kind == "time":
            return settings.get_time(self.key, None if self.default is None
                                     else parse_time_value(self.default,
                                                           self.key))
        elif self.kind == "bytes":
            v = settings.get_bytes(self.key, parse_byte_size(
                self.default, self.key))
        elif self.kind == "list":
            return settings.get_list(self.key, self.default)
        else:
            v = settings.get_str(self.key, self.default)
            if isinstance(settings.get(self.key), bool):
                # a JSON boolean for a "true" / "false" choice (the JAX
                # package refuses it; the port's index settings took it
                # before the registry existed)
                v = v.lower()
            if self.choices is not None and v not in self.choices:
                raise IllegalArgumentException(
                    f"unknown value [{v}] for setting [{self.key}], "
                    f"allowed: {sorted(self.choices)}")
            return v
        if v is None:
            return v
        if self.min_value is not None and v < self.min_value:
            raise IllegalArgumentException(
                f"Failed to parse value [{v}] for setting [{self.key}] must "
                f"be >= {self.min_value}")
        if self.max_value is not None and v > self.max_value:
            raise IllegalArgumentException(
                f"Failed to parse value [{v}] for setting [{self.key}] must "
                f"be <= {self.max_value}")
        return v


INDEX_NUMBER_OF_SHARDS = Setting("index.number_of_shards", 5, "int", 1, 1024,
                                 scope=Scope.INDEX)
# replicas are never allocated on one node: the count only shapes health
# (yellow while any are unassigned) and the write responses' _shards
INDEX_NUMBER_OF_REPLICAS = Setting("index.number_of_replicas", 1, "int", 0,
                                   scope=Scope.INDEX, dynamic=True)

# --- mesh data plane (parallel/plan_exec.py) ---
INDEX_SEARCH_MESH = Setting("index.search.mesh", True, "bool",
                            scope=Scope.INDEX)
INDEX_SEARCH_MESH_MAX_SLOTS = Setting(
    "index.search.mesh.max_slots_per_device", 4, "int", 1, 64,
    scope=Scope.INDEX)
INDEX_SEARCH_MESH_PLANE = Setting(
    "index.search.mesh.plane", "auto", "str",
    choices={"auto", "pallas", "scatter"}, scope=Scope.INDEX)
INDEX_SEARCH_PLANE_QUARANTINE_COOLDOWN = Setting(
    "index.search.plane_quarantine.cooldown", "60s", "time",
    scope=Scope.INDEX, dynamic=True)

# --- the search request's deadline and partial results (node.py,
# search/cancellation.py); node scope ---
# the query phase's deadline when a request carries no ``timeout``; unset
# = no bound. An expired deadline returns what the shards finished, with
# ``timed_out: true``
SEARCH_DEFAULT_TIMEOUT = Setting("search.default_search_timeout", None,
                                 "time", dynamic=True)
# whether a shard failure or an expired deadline gives a partial response
# (true) or a search_phase_execution_exception (false); a request's
# ``allow_partial_search_results`` wins
SEARCH_ALLOW_PARTIAL_RESULTS = Setting(
    "search.default_allow_partial_results", True, "bool", dynamic=True)

# --- cross-query micro-batching (search/batching.py) ---
SEARCH_BATCH_ENABLED = Setting("search.batch.enabled", True, "bool",
                               dynamic=True)
SEARCH_BATCH_WINDOW_MS = Setting("search.batch.window_ms", 0.2, "float",
                                 min_value=0.0, dynamic=True)
SEARCH_BATCH_MAX_QUERIES = Setting("search.batch.max_queries", 16, "int",
                                   1, 64, dynamic=True)

# --- dense-vector kNN (ops/knn_scoring.py, the mesh plane's kNN rung) ---
# false: every vector query runs the host rung (same ids, scores within
# the host rung's tolerance)
SEARCH_KNN_ENABLED = Setting("search.knn.enabled", True, "bool", dynamic=True)
# doc-tile sublane count of the kNN kernel: W = tile_sub * 128 docs a tile
SEARCH_KNN_TILE_SUB = Setting("search.knn.tile_sub", 64, "int",
                              choices={8, 16, 32, 64, 128}, dynamic=True)
INDEX_MAPPING_DENSE_VECTOR_MAX_DIMS = Setting(
    "index.mapping.dense_vector.max_dims", 1024, "int", min_value=1,
    scope=Scope.INDEX)

# --- postings codec and block-max pruning (ops/tile_scoring.py) ---
# node-wide postings representation of the tile kernel's staging: "raw" =
# (doc i32, frac f32) pairs, "packed" = one i32 word a posting (half the
# bytes; frac quantized to 12 bits)
SEARCH_PALLAS_POSTINGS_CODEC = Setting(
    "search.pallas.postings_codec", "raw", "str", choices={"raw", "packed"})
# per-index override; "default" follows the node. Read when a segment or
# the mesh plane stages its tables
INDEX_SEARCH_PALLAS_POSTINGS_CODEC = Setting(
    "index.search.pallas.postings_codec", "default", "str",
    choices={"default", "raw", "packed"}, scope=Scope.INDEX)
# skip the tiles whose summed block-max bound cannot beat the running
# k-th score; totals become a lower bound (marked "gte"), so exact-total
# and dense-output requests run exhaustively whatever this says
SEARCH_PALLAS_PRUNING_ENABLED = Setting(
    "search.pallas.pruning.enabled", False, "bool", dynamic=True)
# how many highest-bound tiles the probe pass scores to seed the threshold
SEARCH_PALLAS_PRUNING_PROBE_TILES = Setting(
    "search.pallas.pruning.probe_tiles", 8, "int",
    choices={2, 4, 8, 16, 32}, dynamic=True)

# --- fused aggregations (search/fused_aggs.py, the mesh plane) ---
# reduce eligible aggregations inside the mesh program instead of copying
# the per-slot matched masks to the host; false: every aggregation runs
# the host reduce (the same bytes either way)
SEARCH_AGGS_FUSED = Setting("search.aggs.fused", True, "bool", dynamic=True)
# per-index override; "default" follows the node
INDEX_SEARCH_AGGS_FUSED = Setting(
    "index.search.aggs.fused", "default", "str",
    choices={"default", "true", "false"}, scope=Scope.INDEX, dynamic=True)

# --- durability (index/translog.py, index/store.py, node.py) ---
# the node's data directory; a Node given neither this nor data_path keeps
# nothing on disk
PATH_DATA = Setting("path.data", "data", "str")
# request: one fsync per op before it is acknowledged; async: the buffer
# is synced at flush and close
INDEX_TRANSLOG_DURABILITY = Setting(
    "index.translog.durability", "request", "str",
    choices={"request", "async"}, scope=Scope.INDEX, dynamic=True)
# registered only, as in the JAX package: no size-triggered flush yet
INDEX_TRANSLOG_FLUSH_THRESHOLD = Setting(
    "index.translog.flush_threshold_size", "512mb", "str",
    scope=Scope.INDEX, dynamic=True)

# --- memory breakers and the device-memory ledger (common/breaker.py,
# common/memory.py); node scope ---
BREAKER_TOTAL_LIMIT = Setting("indices.breaker.total.limit", 1_500_000_000,
                              "bytes", min_value=0, dynamic=True)
BREAKER_REQUEST_LIMIT = Setting("indices.breaker.request.limit",
                                900_000_000, "bytes", min_value=0,
                                dynamic=True)
BREAKER_FIELDDATA_LIMIT = Setting("indices.breaker.fielddata.limit",
                                  900_000_000, "bytes", min_value=0,
                                  dynamic=True)
# the device staging budget: over it a staging first LRU-evicts the coldest
# evictable scopes, then the mesh plane demotes to the host rung with
# decision reason hbm_budget (never a 429 or a 5xx); 0 = unlimited
SEARCH_MEMORY_HBM_BUDGET = Setting("search.memory.hbm_budget_bytes", "0b",
                                   "bytes", min_value=0, dynamic=True)

# --- device-staging retry (common/staging.py); node scope ---
# total attempts of one staging whose fault classifies transient (an out
# of memory, a transfer error); a deterministic fault never retries
SEARCH_STAGING_RETRY_MAX_ATTEMPTS = Setting(
    "search.staging.retry.max_attempts", 3, "int", 1, 10, dynamic=True)
# the first retry's backoff; doubles on each retry
SEARCH_STAGING_RETRY_BACKOFF_MS = Setting(
    "search.staging.retry.backoff_ms", 10.0, "float", min_value=0.0,
    dynamic=True)

# --- delta staging of the mesh plane (parallel/plan_exec.py) ---
# a refresh that adds segments within the generation's free slots stages
# only the new slots; a delete rewrites only the live-mask rows of its
# slot. false: every change rebuilds the generation
INDEX_STAGING_DELTA_ENABLED = Setting("index.staging.delta.enabled", True,
                                      "bool", scope=Scope.INDEX,
                                      dynamic=True)
# background compaction: when a staged slot's tombstone density (or the
# slot fragmentation) reaches this fraction, a single-flight pass merges
# the shards and restages a compact generation; <= 0 turns it off
INDEX_STAGING_COMPACT_THRESHOLD = Setting(
    "index.staging.compact.threshold", 0.25, "float", scope=Scope.INDEX,
    dynamic=True)

# --- the index's refresh and request limits (index/index_service.py) ---
# the scheduled refresh: every interval each shard seals its buffer; -1
# turns it off (a write's refresh=wait_for then forces one). Dynamic: an
# update restarts the timer
INDEX_REFRESH_INTERVAL = Setting("index.refresh_interval", "1s", "time",
                                 scope=Scope.INDEX, dynamic=True)
INDEX_MAX_RESULT_WINDOW = Setting("index.max_result_window", 10000, "int",
                                  min_value=1, scope=Scope.INDEX,
                                  dynamic=True)
# each shard's searcher reads it; an update reaches every searcher
INDEX_MAX_SLICES_PER_SCROLL = Setting("index.max_slices_per_scroll", 1024,
                                      "int", min_value=1, scope=Scope.INDEX,
                                      dynamic=True)

# --- registered and stored, as in the JAX package, with no consumer in the
# port yet: each waits for its module (the settings APIs validate and keep
# them like any other) ---
CLUSTER_NAME = Setting("cluster.name", "elasticsearch-tpu", "str")
NODE_NAME = Setting("node.name", "node-0", "str")
NODE_DATA = Setting("node.data", True, "bool")
NODE_MASTER = Setting("node.master", True, "bool")
NODE_INGEST = Setting("node.ingest", True, "bool")
PATH_REPO = Setting("path.repo", [], "list")
HTTP_PORT = Setting("http.port", 9200, "int", 0, 65535)
HTTP_HOST = Setting("http.host", "127.0.0.1", "str")
ACTION_AUTO_CREATE_INDEX = Setting("action.auto_create_index", True, "bool",
                                   dynamic=True)
ACTION_DESTRUCTIVE_REQUIRES_NAME = Setting(
    "action.destructive_requires_name", False, "bool", dynamic=True)
SEARCH_DEFAULT_SIZE = Setting("search.default_size", 10, "int", min_value=0)
SEARCH_MAX_BUCKETS = Setting("search.max_buckets", 65536, "int", min_value=1,
                             dynamic=True)
SEARCH_KEEPALIVE = Setting("search.default_keep_alive", "5m", "time",
                           dynamic=True)
# transport, discovery, replication and recovery: the multi-node control
# plane (cluster/multinode.py reads them)
TRANSPORT_REQUEST_TIMEOUT = Setting("transport.request.timeout", "30s",
                                    "time", dynamic=True)
TRANSPORT_RETRY_MAX_ATTEMPTS = Setting("transport.retry.max_attempts", 3,
                                       "int", min_value=1, dynamic=True)
TRANSPORT_RETRY_INITIAL_BACKOFF = Setting("transport.retry.initial_backoff",
                                          "50ms", "time", dynamic=True)
TRANSPORT_RETRY_BACKOFF_MULTIPLIER = Setting(
    "transport.retry.backoff_multiplier", 2.0, "float", min_value=1.0,
    dynamic=True)
TRANSPORT_RETRY_MAX_BACKOFF = Setting("transport.retry.max_backoff", "2s",
                                      "time", dynamic=True)
TRANSPORT_HEALTH_FAILURE_THRESHOLD = Setting(
    "transport.health.failure_threshold", 3, "int", min_value=1,
    dynamic=True)
TRANSPORT_HEALTH_QUARANTINE = Setting("transport.health.quarantine", "1s",
                                      "time", dynamic=True)
FD_PING_TIMEOUT = Setting("discovery.zen.fd.ping_timeout", "5s", "time",
                          dynamic=True)
FD_PING_RETRIES = Setting("discovery.zen.fd.ping_retries", 3, "int",
                          min_value=1, dynamic=True)
PUBLISH_TIMEOUT = Setting("discovery.zen.publish_timeout", "30s", "time",
                          dynamic=True)
# the per-replica write fan-out deadline: a blackholed replica is failed
# (and rerouted by the master) instead of blocking the primary
REPLICATION_TIMEOUT = Setting("cluster.replication.timeout", "30s", "time",
                              dynamic=True)
RECOVERY_RETRY_DELAY_NETWORK = Setting(
    "indices.recovery.retry_delay_network", "500ms", "time", dynamic=True)
RECOVERY_MAX_RETRIES = Setting("indices.recovery.max_retries", 5, "int",
                               min_value=1, dynamic=True)
RECOVERY_ACTION_TIMEOUT = Setting(
    "indices.recovery.internal_action_timeout", "30s", "time", dynamic=True)
TRANSPORT_SETTINGS = [
    TRANSPORT_REQUEST_TIMEOUT, TRANSPORT_RETRY_MAX_ATTEMPTS,
    TRANSPORT_RETRY_INITIAL_BACKOFF, TRANSPORT_RETRY_BACKOFF_MULTIPLIER,
    TRANSPORT_RETRY_MAX_BACKOFF, TRANSPORT_HEALTH_FAILURE_THRESHOLD,
    TRANSPORT_HEALTH_QUARANTINE, FD_PING_TIMEOUT, FD_PING_RETRIES,
    PUBLISH_TIMEOUT, REPLICATION_TIMEOUT, RECOVERY_RETRY_DELAY_NETWORK,
    RECOVERY_MAX_RETRIES, RECOVERY_ACTION_TIMEOUT,
]
# admission control and the drain (search/admission.py); the search
# pool's queue follows search.queue.size too
SEARCH_BATCH_MAX_WINDOW_MS = Setting("search.batch.max_window_ms", 5.0,
                                     "float", min_value=0.0, dynamic=True)
SEARCH_QUEUE_SIZE = Setting("search.queue.size", 1000, "int", min_value=1,
                            dynamic=True)
ADMISSION_SETTINGS = [
    Setting("search.admission.enabled", True, "bool", dynamic=True),
    Setting("search.admission.max_concurrent", 0, "int", min_value=0,
            dynamic=True),
    Setting("search.admission.weights", "", "str", dynamic=True),
    Setting("search.admission.brownout.pruned_threshold", 0.25, "float",
            min_value=0.0, dynamic=True),
    Setting("search.admission.brownout.rescore_threshold", 0.5, "float",
            min_value=0.0, dynamic=True),
    Setting("search.admission.brownout.features_threshold", 0.75, "float",
            min_value=0.0, dynamic=True),
    Setting("search.drain.deadline", "30s", "time", dynamic=True),
]
# the TPU kernel's DMA buffering depth: the CUDA kernels have no such knob
SEARCH_PALLAS_TILES_PER_STEP = Setting("search.pallas.tiles_per_step", 1,
                                       "int", choices={1, 2, 4, 8})
# the variant registry's path and the warm replay at start
# (common/compile_cache.py, Node), and telemetry's kill switch
# (search/telemetry.py's registry)
SEARCH_COMPILE_CACHE_PATH = Setting("search.compile.cache_path", "", "str")
SEARCH_COMPILE_WARM_ON_START = Setting("search.compile.warm_on_start", True,
                                       "bool")
SEARCH_TELEMETRY_ENABLED = Setting("search.telemetry.enabled", True, "bool",
                                   dynamic=True)
# index scope: the scrubber (IndexService.scrub_now) and the search
# slowlog (search/service.emit_search_slowlog)
INDEX_SCRUB_INTERVAL = Setting("index.scrub.interval", None, "time",
                               scope=Scope.INDEX, dynamic=True)
INDEX_SEARCH_SLOWLOG_SETTINGS = [
    Setting("index.search.slowlog.threshold.query.warn", None, "time",
            scope=Scope.INDEX, dynamic=True),
    Setting("index.search.slowlog.threshold.query.info", None, "time",
            scope=Scope.INDEX, dynamic=True),
]
# index scope without a reader: the TPU posting block width, the default
# field and the field limit
INDEX_UNCONSUMED_SETTINGS = [
    Setting("index.tpu.posting_block_size", 128, "int", min_value=128,
            scope=Scope.INDEX),
    Setting("index.query.default_field", "_all", "str", scope=Scope.INDEX,
            dynamic=True),
    Setting("index.mapping.total_fields.limit", 1000, "int", min_value=1,
            scope=Scope.INDEX, dynamic=True),
]

NODE_SETTINGS = [
    CLUSTER_NAME, NODE_NAME, NODE_DATA, NODE_MASTER, NODE_INGEST, PATH_DATA,
    PATH_REPO, HTTP_PORT, HTTP_HOST, ACTION_AUTO_CREATE_INDEX,
    ACTION_DESTRUCTIVE_REQUIRES_NAME, SEARCH_DEFAULT_SIZE,
    SEARCH_MAX_BUCKETS, SEARCH_KEEPALIVE, SEARCH_DEFAULT_TIMEOUT,
    SEARCH_ALLOW_PARTIAL_RESULTS, BREAKER_TOTAL_LIMIT, BREAKER_REQUEST_LIMIT,
    BREAKER_FIELDDATA_LIMIT, *TRANSPORT_SETTINGS, SEARCH_BATCH_ENABLED,
    SEARCH_BATCH_WINDOW_MS, SEARCH_BATCH_MAX_QUERIES,
    SEARCH_BATCH_MAX_WINDOW_MS, SEARCH_QUEUE_SIZE, *ADMISSION_SETTINGS,
    SEARCH_PALLAS_TILES_PER_STEP, SEARCH_PALLAS_POSTINGS_CODEC,
    SEARCH_PALLAS_PRUNING_ENABLED, SEARCH_PALLAS_PRUNING_PROBE_TILES,
    SEARCH_KNN_ENABLED, SEARCH_KNN_TILE_SUB, SEARCH_AGGS_FUSED,
    SEARCH_MEMORY_HBM_BUDGET, SEARCH_STAGING_RETRY_MAX_ATTEMPTS,
    SEARCH_STAGING_RETRY_BACKOFF_MS, SEARCH_COMPILE_CACHE_PATH,
    SEARCH_COMPILE_WARM_ON_START, SEARCH_TELEMETRY_ENABLED,
]

INDEX_SETTINGS = [
    INDEX_SEARCH_MESH, INDEX_SEARCH_MESH_MAX_SLOTS, INDEX_SEARCH_MESH_PLANE,
    INDEX_SEARCH_PALLAS_POSTINGS_CODEC, INDEX_SEARCH_AGGS_FUSED,
    INDEX_SEARCH_PLANE_QUARANTINE_COOLDOWN, INDEX_STAGING_DELTA_ENABLED,
    INDEX_STAGING_COMPACT_THRESHOLD, INDEX_SCRUB_INTERVAL,
    *INDEX_SEARCH_SLOWLOG_SETTINGS, *INDEX_UNCONSUMED_SETTINGS,
    INDEX_NUMBER_OF_SHARDS, INDEX_NUMBER_OF_REPLICAS, INDEX_REFRESH_INTERVAL,
    INDEX_MAX_RESULT_WINDOW, INDEX_MAX_SLICES_PER_SCROLL,
    INDEX_TRANSLOG_DURABILITY, INDEX_TRANSLOG_FLUSH_THRESHOLD,
    INDEX_MAPPING_DENSE_VECTOR_MAX_DIMS,
]


class AbstractScopedSettings:
    """The registry of one scope's settings and the dispatch of dynamic
    updates (the JAX package's ``AbstractScopedSettings``): ``validate``
    parses every registered key, ``validate_dynamic_update`` refuses an
    unknown or non-dynamic key, and ``apply_settings`` fires each
    registered consumer whose setting changed."""

    def __init__(self, scope: str, registered: Iterable[Setting]):
        self.scope = scope
        self._settings: Dict[str, Setting] = {}
        self._listeners: list = []  # (setting, consumer)
        for s in registered:
            self.register(s)

    def register(self, setting: Setting) -> None:
        if setting.scope != self.scope:
            raise IllegalArgumentException(
                f"setting [{setting.key}] has scope [{setting.scope}], "
                f"expected [{self.scope}]")
        if setting.key in self._settings:
            raise IllegalArgumentException(
                f"setting [{setting.key}] already registered")
        self._settings[setting.key] = setting

    def get_setting(self, key: str) -> Optional[Setting]:
        return self._settings.get(key)

    def is_registered(self, key: str) -> bool:
        return key in self._settings

    def is_dynamic(self, key: str) -> bool:
        s = self._settings.get(key)
        return s is not None and s.dynamic

    def validate(self, settings: Settings, allow_unknown: bool = False) -> None:
        for key in settings.keys():
            s = self._settings.get(key)
            if s is None:
                if not allow_unknown:
                    raise IllegalArgumentException(f"unknown setting [{key}]")
                continue
            s.get(settings)  # parse and validate

    def validate_dynamic_update(self, settings: Settings) -> None:
        for key in settings.keys():
            s = self._settings.get(key)
            if s is None:
                raise IllegalArgumentException(f"unknown setting [{key}]")
            if not s.dynamic:
                raise IllegalArgumentException(
                    f"final or non-dynamic setting [{key}] cannot be updated")
            s.get(settings)

    def add_settings_update_consumer(self, setting: Setting, consumer) -> None:
        if setting.key not in self._settings:
            raise IllegalArgumentException(
                f"setting [{setting.key}] not registered")
        self._listeners.append((setting, consumer))

    def apply_settings(self, old: Settings, new: Settings) -> None:
        """Fire the consumers whose setting changed: by typed value, or
        by the raw value (an explicit update to the default still fires;
        consumers are idempotent setters)."""
        for setting, consumer in self._listeners:
            before, after = setting.get(old), setting.get(new)
            if before != after or old.get(setting.key) != new.get(
                    setting.key):
                consumer(after)


def cluster_settings() -> AbstractScopedSettings:
    return AbstractScopedSettings(Scope.NODE, NODE_SETTINGS)


def index_scoped_settings() -> AbstractScopedSettings:
    return AbstractScopedSettings(Scope.INDEX, INDEX_SETTINGS)
