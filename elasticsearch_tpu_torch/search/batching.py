"""Cross-query micro-batching for the tile-scoring plane.

Counterpart of ``elasticsearch_tpu/search/batching.py``. Every query that
reaches the tile kernel streams the same posting rows out of device
memory; queries in flight at the same time can share that pass. Pieces:

- ``MicroBatcher``: a bounded-window collector in front of the search
  path. A query arriving while no other search is in flight runs at once
  (no added latency). Under concurrency, the first arrival leads a group:
  it waits up to ``search.batch.window_ms`` for peers, bounded by
  ``search.batch.max_queries``, runs the batch, and hands each member its
  own result (a member's exception reaches that member alone).
- ``BatchStats``: the ``search.batch`` counters (batched_query_total,
  batch_size_histogram, batch_window_waits_total).
- ``knn_batch_spec``: which pure-kNN requests one batched kernel-3 launch
  can serve (``IndexService.search_batch`` splits them off onto the mesh
  plane's kNN rung); a hybrid request (``query`` + ``knn``) rides no
  batch as a whole.
- ``batched_segment_scores``: the host rung's batched launch: given the
  per-query kernel plans for one segment, it unions their lanes, walks
  the single-query geometry ladder, and runs one ``score_tiles`` call
  with ``q_batch=Q`` (kernel 1b), returning each query's dense (scores,
  matched) pair, which ``ShardSearcher.query`` takes through its
  ``score_cache``.

Nothing here catches a kernel fault: a launch that fails raises (shape
ineligibility returns None, as in the JAX package). A batch item is
whatever the caller passes (``IndexService`` passes each member's body,
deadline and tracer), so each member keeps its own deadline: one that
expired before the batch forms is served alone, its peers share the
launch. The mesh rung's
batched launch lives in ``parallel/plan_exec.IndexMeshSearch.query_batch``;
the rung selection lives in ``IndexService.search_batch``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# request-body keys the host batched path understands (the JAX package's
# set): batching only replaces the main query's scoring with a cached
# per-query score vector; everything else runs the normal per-query
# pipeline on top of it
_BATCHABLE_KEYS = frozenset({
    "query", "size", "from", "sort", "aggs", "aggregations", "post_filter",
    "min_score", "timeout", "allow_partial_search_results", "stats",
    "terminate_after", "rescore", "search_after", "track_scores",
    "_source", "docvalue_fields", "stored_fields", "script_fields",
    "highlight", "version", "profile",
})


# pure-kNN request shapes the batched kNN launch covers: the top-level
# ``knn`` section alone or the sole ``knn`` query clause
_KNN_BATCHABLE_KEYS = frozenset({
    "knn", "query", "size", "from", "timeout",
    "allow_partial_search_results", "stats", "_source", "profile",
})

# the knn spec parameters the parser accepts (query_dsl strict-parses the
# same set): anything else stays off the batched rung, so an unknown
# parameter gets the parser's 400 whichever rung would serve
_KNN_SPEC_KEYS = frozenset({
    "field", "query_vector", "k", "num_candidates", "filter", "boost",
    "_name",
})


def _knn_shaped(body: dict) -> Optional[dict]:
    """The knn spec of a knn-shaped request (the top-level section with no
    lexical query, or the sole knn query clause), eligible or not."""
    if isinstance(body.get("knn"), dict) and body.get("query") is None:
        return body["knn"]
    q = body.get("query")
    if (isinstance(q, dict) and set(q) == {"knn"}
            and isinstance(q["knn"], dict) and "knn" not in body):
        return q["knn"]
    return None


def knn_batch_spec(body: Optional[dict]) -> Optional[dict]:
    """The knn spec when this request is a pure top-k vector search that a
    batched kNN launch could serve (the shape the mesh kNN rung covers),
    else None."""
    body = body or {}
    if any(key not in _KNN_BATCHABLE_KEYS for key in body):
        return None
    spec = _knn_shaped(body)
    if spec is None or float(spec.get("boost", 1.0)) != 1.0:
        return None
    if spec.get("filter"):
        return None  # filtered kNN runs the host rung
    if any(key not in _KNN_SPEC_KEYS for key in spec):
        return None  # unknown parameter: the parser owns the 400
    return spec


def batchable_body(body: Optional[dict]) -> bool:
    """Cheap body-shape precheck at submit time: can this request ride a
    micro-batch at all? (Per-segment kernel eligibility is decided later,
    per query; an ineligible member executes serially inside the batch.)"""
    body = body or {}
    if _knn_shaped(body) is not None:
        # pure kNN: batchable only when the kNN launch covers it; a
        # filtered, boosted or malformed spec runs alone rather than
        # joining a lexical batch
        return knn_batch_spec(body) is not None
    if not isinstance(body.get("query"), dict):
        return False  # match_all / missing query: nothing to amortize
    if body.get("knn") is not None:
        return False  # hybrid: each side runs its own plane ladder
    return all(key in _BATCHABLE_KEYS for key in body)


class BatchStats:
    """The ``search.batch`` stats block (thread-safe counters)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.batched_query_total = 0
        self.batch_window_waits_total = 0
        self.batch_size_histogram: Dict[int, int] = {}
        # the collection window a leader last used, in ms: it widens with
        # admission-queue pressure and narrows back as the queue drains
        self.batch_window_effective_ms = 0.0

    def note_window_wait(self) -> None:
        with self._lock:
            self.batch_window_waits_total += 1

    def note_effective_window(self, window_s: float) -> None:
        with self._lock:
            self.batch_window_effective_ms = round(window_s * 1000.0, 4)

    def note_batch(self, size: int) -> None:
        """One batched dispatch of ``size`` members served via a shared
        launch."""
        with self._lock:
            self.batched_query_total += size
            self.batch_size_histogram[size] = (
                self.batch_size_histogram.get(size, 0) + 1)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "batched_query_total": self.batched_query_total,
                "batch_window_waits_total": self.batch_window_waits_total,
                "batch_window_effective_ms": self.batch_window_effective_ms,
                "batch_size_histogram": {
                    str(size): count for size, count
                    in sorted(self.batch_size_histogram.items())},
            }


def counts_safe_for_union(node) -> bool:
    """False when a with_counts (minimum_should_match / operator:and)
    member names the same posting run in two lanes: the union dedupes the
    run (summing weights, exact for scores), so that member's match count
    would see one lane where the serial kernel counts two. Such members
    execute serially."""
    if not node.with_counts:
        return True
    lanes = node._host_lanes
    return len({(ln.block_start, ln.block_count)
                for ln in lanes}) == len(lanes)


class _Group:
    __slots__ = ("items", "results", "done", "sealed", "opened_at")

    def __init__(self):
        self.items: List[Any] = []
        self.results: Optional[List[Any]] = None
        self.done = threading.Event()
        self.sealed = False
        # how long the leader held the group open (the window-wait span)
        self.opened_at = time.monotonic()


class MicroBatcher:
    """Bounded-window cross-query collector.

    ``run(key, item, single_fn, batch_fn)``:

    - no other search in flight -> ``single_fn(item)`` at once;
    - otherwise the item joins (or opens) the pending group for ``key``;
      the group's first member leads: it waits up to ``window_s`` (or
      until ``max_queries`` members arrived), then runs
      ``batch_fn(items) -> [result | Exception, ...]`` and publishes each
      member's entry. Exception entries re-raise in their own caller's
      thread.

    ``window_fn``, when set, sizes the leader's wait instead of
    ``window_s`` (``IndexService`` points it at admission's adaptive
    window); ``annotate(item, wait_s, batch_size, index)`` runs once a
    member before the leader dispatches (``IndexService`` stamps the
    window wait on each member's tracer). A lone query never waits.
    """

    # a follower whose leader never publishes (a wedged leader) runs alone
    FOLLOWER_TIMEOUT_S = 300.0

    def __init__(self, window_s: float = 0.0002, max_queries: int = 16,
                 enabled: bool = True,
                 stats: Optional[BatchStats] = None):
        self.window_s = float(window_s)
        self.max_queries = int(max_queries)
        self.enabled = bool(enabled)
        self.stats = stats or BatchStats()
        self._cv = threading.Condition()
        self._groups: Dict[Any, _Group] = {}
        self._inflight = 0
        self.window_fn: Optional[Callable[[], float]] = None
        self.annotate: Optional[Callable[[Any, float, int, int],
                                         None]] = None

    def run(self, key, item, single_fn: Callable[[Any], Any],
            batch_fn: Callable[[List[Any]], List[Any]]):
        if not self.enabled or self.max_queries < 2:
            return single_fn(item)
        with self._cv:
            group = self._groups.get(key)
            if group is None and self._inflight == 0:
                # the common unloaded case: no concurrency, no window
                self._inflight += 1
                direct, leader, my_idx = True, False, 0
            elif group is None:
                group = _Group()
                group.items.append(item)
                self._groups[key] = group
                self._inflight += 1
                direct, leader, my_idx = False, True, 0
            else:
                group.items.append(item)
                my_idx = len(group.items) - 1
                self._inflight += 1
                direct, leader = False, False
                if len(group.items) >= self.max_queries:
                    # full: seal so the leader dispatches now and new
                    # arrivals open a fresh group
                    group.sealed = True
                    self._groups.pop(key, None)
                    self._cv.notify_all()
        try:
            if direct:
                return single_fn(item)
            if leader:
                self.stats.note_window_wait()
                window_s = self.window_s
                if self.window_fn is not None:
                    try:
                        window_s = max(float(self.window_fn()), 0.0)
                    except Exception:  # noqa: BLE001 — sizing is advisory
                        pass
                self.stats.note_effective_window(window_s)
                deadline = time.monotonic() + window_s
                with self._cv:
                    while (not group.sealed
                           and len(group.items) < self.max_queries):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                    group.sealed = True
                    # a filling member may have sealed and removed this
                    # group already, and a newer one may be pending under
                    # the same key: remove only ours
                    if self._groups.get(key) is group:
                        self._groups.pop(key)
                    items = list(group.items)
                if self.annotate is not None:
                    wait_s = time.monotonic() - group.opened_at
                    for idx, it in enumerate(items):
                        try:
                            self.annotate(it, wait_s, len(items), idx)
                        except Exception:  # noqa: BLE001 — telemetry
                            pass  # never fails the query
                try:
                    if len(items) == 1:
                        try:
                            results = [single_fn(items[0])]
                        except Exception as e:  # noqa: BLE001 — delivered
                            results = [e]  # to its own caller below
                    else:
                        results = list(batch_fn(items))
                        if len(results) != len(items):
                            raise RuntimeError(
                                f"batch_fn returned {len(results)} results "
                                f"for {len(items)} members")
                except BaseException as e:  # noqa: BLE001 — followers must
                    # never hang on a leader fault; every member sees it
                    results = [e] * len(items)
                group.results = results
                group.done.set()
                out = results[my_idx]
                if isinstance(out, BaseException):
                    raise out
                return out
            # follower: the leader publishes our result
            if not group.done.wait(timeout=self.FOLLOWER_TIMEOUT_S):
                return single_fn(item)
            out = group.results[my_idx]
            if isinstance(out, BaseException):
                raise out
            return out
        finally:
            with self._cv:
                self._inflight -= 1


def batched_segment_scores(segment, nodes: Sequence) -> Optional[
        List[Tuple[torch.Tensor, torch.Tensor]]]:
    """One batched ``score_tiles`` launch for Q queries over one segment.

    ``nodes``: the per-query host-built ``PallasScoreTermsNode``s (each
    carries its ``_host_lanes``); the launch reads the segment's tables in
    its own postings codec, as the nodes do. Returns one (scores [nd1] f32, matched
    [nd1] bool) pair per query on the segment's device, exactly what the
    node's serial ``emit`` gives (scores bit for bit), or None when no
    shared geometry exists (callers then run each member serially)."""
    from elasticsearch_tpu_torch.ops import tile_scoring as tsc

    dev = segment.device_arrays()
    geom = segment.kernel_geom
    lane_sets = [list(n._host_lanes) for n in nodes]
    # pad the batch to a power of two with empty lane sets (the JAX
    # package's compiled-program bucket)
    q_pad = tsc.next_pow2(len(nodes))
    lane_sets.extend([] for _ in range(q_pad - len(nodes)))
    # the single-query geometry ladder, walked for the union
    sub = geom.tile_sub
    while True:
        g = geom if sub == geom.tile_sub else tsc.tile_geometry(
            geom.nd_pad, sub)
        try:
            row_lo, row_hi, weights, cb = tsc.build_tile_tables_batched(
                lane_sets, segment.kernel_bmin, segment.kernel_bmax, g)
            break
        except ValueError:
            if sub <= 32 or g.tile_sub < sub:
                return None
            sub //= 2
    live_key = ("k_live_t" if g.tile_sub == geom.tile_sub
                else segment.kernel_live_t_for(g.tile_sub))
    with_counts = any(n.with_counts for n in nodes)
    on = segment.device
    codec = segment.kernel_codec
    corpus = ((dev["k_packed"], None) if codec == "packed"
              else (dev["k_docs"], dev["k_frac"]))
    outs = tsc.score_tiles(
        corpus[0], corpus[1], dev[live_key],
        torch.from_numpy(row_lo).to(on), torch.from_numpy(row_hi).to(on),
        torch.from_numpy(weights).to(on),
        t_pad=row_lo.shape[1], cb=cb, sub=g.tile_sub, dense=True,
        with_counts=with_counts, q_batch=q_pad, codec=codec)
    nd = segment.nd_pad
    tail = torch.zeros(1, dtype=torch.float32, device=on)
    results = []
    for q, node in enumerate(nodes):
        scores = torch.cat([tsc.dense_to_flat(outs[0][q], g.tile_sub)[:nd],
                            tail])
        if node.with_counts:
            counts = torch.cat(
                [tsc.dense_to_flat(outs[1][q], g.tile_sub)[:nd], tail])
            matched = counts >= float(node.min_match)
        else:
            matched = scores > 0.0
        results.append((scores, matched))
    return results
