"""The recovery-progress registry that ``_cat/recovery`` renders.

Counterpart of the registry in ``elasticsearch_tpu/cluster/multinode.py``,
kept at the index layer so that a shard's cold recovery records its row
without the cluster module.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

# Target-side ClusterNodes record each peer recovery's live progress here
# (stage init -> index -> translog -> finalize -> done, file/bytes/ops
# counts, source -> target), keyed per copy; IndexShard records a "store"
# row for a cold recovery from its store. The REST layer renders the rows
# like the reference's RestCatRecoveryAction. Process-global (like the
# transport stats registry in transport/local.py) so in-one-process
# clusters and the single-node REST surface share one view; bounded by
# eviction of done rows beyond a cap.

_RECOVERY_PROGRESS: Dict[Tuple[str, int, str], dict] = {}
_RECOVERY_PROGRESS_LOCK = threading.Lock()
# total-row cap: finished rows retire first, then the OLDEST stale
# in-flight ones (a recovery that died mid-pull never reaches "done" —
# without aging those out the registry would grow per churned copy)
_RECOVERY_PROGRESS_MAX_ROWS = 128


def record_recovery_progress(index: str, shard: int, target: str,
                             **updates) -> None:
    """Create/update one copy's recovery-progress row; counters passed
    as ``add_<field>=n`` increment, plain fields assign."""
    key = (index, int(shard), target)
    with _RECOVERY_PROGRESS_LOCK:
        row = _RECOVERY_PROGRESS.get(key)
        if row is None:
            row = _RECOVERY_PROGRESS[key] = {
                "index": index, "shard": int(shard), "target": target,
                "source": None, "type": "peer", "stage": "init",
                "files_total": 0, "files_recovered": 0,
                "bytes_total": 0, "bytes_recovered": 0,
                "ops_total": 0, "ops_recovered": 0,
                "start_ms": int(time.time() * 1000), "stop_ms": None,
            }
            # bounded registry: evict finished rows first (oldest
            # stop_ms), then the oldest stale in-flight rows
            excess = len(_RECOVERY_PROGRESS) - _RECOVERY_PROGRESS_MAX_ROWS
            if excess > 0:
                victims = sorted(
                    (k for k in _RECOVERY_PROGRESS if k != key),
                    key=lambda k: (
                        _RECOVERY_PROGRESS[k]["stage"] != "done",
                        _RECOVERY_PROGRESS[k]["stop_ms"]
                        or _RECOVERY_PROGRESS[k]["start_ms"] or 0))
                for k in victims[:excess]:
                    _RECOVERY_PROGRESS.pop(k, None)
        for field, value in updates.items():
            if field.startswith("add_"):
                row[field[4:]] = row.get(field[4:], 0) + value
            else:
                row[field] = value


def recovery_progress_rows() -> List[dict]:
    """Snapshot of every tracked recovery, in-flight first then by
    recency — the _cat/recovery row source."""
    with _RECOVERY_PROGRESS_LOCK:
        rows = [dict(r) for r in _RECOVERY_PROGRESS.values()]
    rows.sort(key=lambda r: (r["stage"] == "done", -(r["start_ms"] or 0)))
    return rows


def clear_recovery_progress() -> None:
    with _RECOVERY_PROGRESS_LOCK:
        _RECOVERY_PROGRESS.clear()
