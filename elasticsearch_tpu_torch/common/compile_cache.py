"""The program-variant registry and warming, pointed at the port's own
first-use costs.

Counterpart of ``elasticsearch_tpu/common/compile_cache.py``. The port
compiles no XLA program; what a process pays on first use is the kernel
library's build and load (``ops/cuda_kernels.py``: ``nvcc`` into
``build/``, skipped when the digest-stamped ``.so`` there is current) and
each mesh program variant's first run (an index's staging, the first
launch of each kernel at its geometry, the launch plans' occupancy
queries, the caching allocator's growth). This module makes a restart
pay them off the query path:

- **variant registry**: every mesh program variant records a stable key
  (``variant_key``) and, per index, the replayable bodies that ran it
  (``record_warm``), in a JSON file (``compile_variants.json`` under
  ``search.compile.cache_path``, else under the node's ``_state``), so
  the next process knows the variants before the first query arrives;
- **warming**: on node start the recorded bodies replay in the
  background under :func:`warming` (``Node._start_compile_warming``,
  ``search.compile.warm_on_start``), so their first runs land in
  ``programs_warmed_total``, never on the query path;
- **telemetry**: ``compile_cache_{hit,miss}_total``,
  ``programs_warmed_total``, ``query_path_first_compile_total`` and a
  log2-ms first-call stall histogram with its event ring: the
  ``compile`` block of ``_stats`` and ``_nodes/stats``.

A variant's first run in a process counts as a hit when a prior process
recorded its key and the cache path is set (``configure_compile_cache``),
else as a miss; the kernel library's family counts a hit when its
``.so`` in ``build/`` was current (no ``nvcc`` ran). Independently a
first run counts as warmed when it ran under :func:`warming`, else as a
query-path first call.
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

# log2-ish ms buckets of the first-call stall histogram
_STALL_BUCKETS_MS = (1.0, 8.0, 64.0, 512.0, 4096.0, 32768.0)
_EVENT_RING = 64
REGISTRY_FILE = "compile_variants.json"

# warming context: first runs under it are the warmer's, not the query
# path's (the contextvar survives same-thread nested calls)
_WARMING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "es_tpu_torch_compile_warming", default=False)

_CACHE_PATH: Optional[str] = None


def in_warming() -> bool:
    return _WARMING.get()


@contextmanager
def warming():
    """Mark first runs in this context as background warming (they count
    into ``programs_warmed_total``, never into
    ``query_path_first_compile_total``)."""
    token = _WARMING.set(True)
    try:
        yield
    finally:
        _WARMING.reset(token)


def configure_compile_cache(path: Optional[str]) -> bool:
    """Keep the variant registry under ``path``
    (``search.compile.cache_path``): the registry there is installed as
    the process's, so a restarted process counts the variants a prior one
    recorded as hits. The kernel library stays in ``build/``. An empty
    path turns the cache off (False)."""
    global _CACHE_PATH
    if not path:
        _CACHE_PATH = None
        return False
    os.makedirs(path, exist_ok=True)
    _CACHE_PATH = path
    set_variant_registry(VariantRegistry(os.path.join(path, REGISTRY_FILE)))
    return True


def compile_cache_enabled() -> bool:
    return _CACHE_PATH is not None


def variant_key(family: str, *parts) -> str:
    """Stable cross-process key for one program variant: the family plus
    a digest of its shape-defining parts."""
    digest = hashlib.sha1(
        "|".join(str(p) for p in parts).encode("utf-8")).hexdigest()[:16]
    return f"{family}:{digest}"


class VariantRegistry:
    """The persisted variant lattice: every variant's key, plus per-index
    replayable warm specs (the bodies that ran them). ``path=None`` keeps
    it in memory (tests, nodes without a data path)."""

    MAX_WARM_PER_INDEX = 64
    MAX_PROGRAMS = 1024

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self.programs: set = set()
        # warm specs: {index: {dedup_key: spec}}
        self.warm: Dict[str, Dict[str, dict]] = {}
        if path and os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                self.programs = set(data.get("programs") or [])
                self.warm = {
                    idx: dict(entries)
                    for idx, entries in (data.get("warm") or {}).items()}
            except (OSError, json.JSONDecodeError, TypeError):
                pass  # a corrupt registry warms nothing; it rebuilds
        # what a prior process had recorded: the hit/miss baseline
        self._preexisting = frozenset(self.programs)

    def program_known(self, key: str) -> bool:
        return key in self._preexisting

    def record_program(self, key: str) -> None:
        with self._lock:
            if key in self.programs:
                return
            if len(self.programs) >= self.MAX_PROGRAMS:
                return  # a runaway of variants: warming stays bounded
            self.programs.add(key)
            self._persist_locked()

    def has_warm(self, index: str, dedup_key: str) -> bool:
        """Lock-free probe for the query path: dict reads are atomic, and
        a rare stale False costs one ``record_warm`` that dedups under
        the lock."""
        entries = self.warm.get(index)
        return entries is not None and dedup_key in entries

    def record_warm(self, index: str, dedup_key: str, spec: dict) -> None:
        with self._lock:
            entries = self.warm.setdefault(index, {})
            if dedup_key in entries:
                return
            if len(entries) >= self.MAX_WARM_PER_INDEX:
                return
            entries[dedup_key] = spec
            self._persist_locked()

    def warm_entries(self, index: str) -> List[dict]:
        with self._lock:
            return [dict(s) for s in self.warm.get(index, {}).values()]

    def indices(self) -> List[str]:
        with self._lock:
            return sorted(self.warm)

    def forget_index(self, index: str) -> None:
        with self._lock:
            if self.warm.pop(index, None) is not None:
                self._persist_locked()

    def _persist_locked(self) -> None:
        if not self.path:
            return
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"programs": sorted(self.programs),
                           "warm": self.warm}, f)
            os.replace(tmp, self.path)
        except OSError:
            pass  # persistence is best effort; warming degrades


_REGISTRY = VariantRegistry(None)
_REGISTRY_LOCK = threading.Lock()


def variant_registry() -> VariantRegistry:
    return _REGISTRY


def set_variant_registry(registry: VariantRegistry) -> VariantRegistry:
    """Install a node's persisted registry (the last node constructed
    wins: one registry a process)."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = registry
    return registry


class CompileCacheStats:
    """Process-wide first-use telemetry: the ``compile`` block of
    ``_stats`` and ``_nodes/stats``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compile_cache_hit_total = 0
        self.compile_cache_miss_total = 0
        self.programs_warmed_total = 0
        self.query_path_first_compile_total = 0
        self._stall_hist = {f"le_{int(b)}": 0 for b in _STALL_BUCKETS_MS}
        self._stall_hist["le_inf"] = 0
        self._events: deque = deque(maxlen=_EVENT_RING)

    def record_first_call(self, family: str, variant: str, seconds: float,
                          warmed: bool, cache_hit: bool) -> None:
        ms = seconds * 1000.0
        with self._lock:
            if cache_hit:
                self.compile_cache_hit_total += 1
            else:
                self.compile_cache_miss_total += 1
            if warmed:
                self.programs_warmed_total += 1
            else:
                self.query_path_first_compile_total += 1
            for bound in _STALL_BUCKETS_MS:
                if ms <= bound:
                    self._stall_hist[f"le_{int(bound)}"] += 1
                    break
            else:
                self._stall_hist["le_inf"] += 1
            self._events.append({
                "family": family, "variant": variant,
                "stall_ms": round(ms, 3), "warmed": bool(warmed),
                "cache_hit": bool(cache_hit),
                "ts_ms": int(time.time() * 1000),
            })

    def stats(self) -> dict:
        with self._lock:
            return {
                "cache_enabled": compile_cache_enabled(),
                "cache_path": _CACHE_PATH,
                "variants_recorded": len(variant_registry().programs),
                "compile_cache_hit_total": self.compile_cache_hit_total,
                "compile_cache_miss_total": self.compile_cache_miss_total,
                "programs_warmed_total": self.programs_warmed_total,
                "query_path_first_compile_total":
                    self.query_path_first_compile_total,
                "first_compile_stall_ms": dict(self._stall_hist),
                "first_compile_events": list(self._events),
            }


_STATS = CompileCacheStats()


def compile_stats() -> CompileCacheStats:
    return _STATS


def instrument_program(run, family: str, key: str):
    """Wrap one program entry: its first invocation is timed, classified
    (hit or miss, warmed or query path) and its key recorded in the
    registry. Later calls go straight through (one flag check)."""
    state = {"done": False}
    lock = threading.Lock()

    def wrapped(*args, **kwargs):
        if state["done"]:
            return run(*args, **kwargs)
        with lock:  # racers wait for the one timed first run
            if state["done"]:
                return run(*args, **kwargs)
            t0 = time.perf_counter()
            out = run(*args, **kwargs)
            dt = time.perf_counter() - t0
            registry = variant_registry()
            known = registry.program_known(key)
            registry.record_program(key)
            _STATS.record_first_call(
                family, key, dt, warmed=in_warming(),
                cache_hit=known and compile_cache_enabled())
            state["done"] = True
            return out

    wrapped.__wrapped__ = run
    wrapped.variant_key = key
    return wrapped


_PROGRAMS: Dict[str, Callable] = {}
_PROGRAMS_LOCK = threading.Lock()


def run_variant(family: str, parts: tuple, fn: Callable):
    """``fn()`` as one run of the program variant ``(family, parts)``:
    the variant's instrumented entry (made once a process) times its
    first run. The port's mesh programs are Python over hand-written
    kernels, so a variant is its shape-defining parts, not a compiled
    object."""
    key = variant_key(family, *parts)
    program = _PROGRAMS.get(key)
    if program is None:
        with _PROGRAMS_LOCK:
            program = _PROGRAMS.get(key)
            if program is None:
                program = instrument_program(lambda f: f(), family, key)
                _PROGRAMS[key] = program
    return program(fn)


def body_skeleton(body: dict) -> str:
    """A query body's shape signature, the warm spec's dedup key: keys
    and shape values (numbers: size, from, k, window) survive, a string
    becomes its token count (a 2-term match plans another shape than a
    1-term one), so a hot query template records once, not once a
    term."""

    def walk(obj):
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in sorted(obj.items())}
        if isinstance(obj, list):
            return [len(obj)] + [walk(v) for v in obj[:4]]
        if isinstance(obj, bool):
            return "b"
        if isinstance(obj, (int, float)):
            return obj
        if isinstance(obj, str):
            return f"s{len(obj.split())}"
        return "x"

    return json.dumps(walk(body), separators=(",", ":"))
