"""Device-staging fault model: classification and bounded retry.

Counterpart of ``elasticsearch_tpu/common/staging.py``. The fragile
boundary of the device plane is the staging (the host-to-device copies of
posting tables, live masks, embeddings and slot tables), so every
multi-tensor staging site runs its attempt through ``run_staged``:

- ``classify_staging_fault`` splits a fault into
  - transient: an allocator or transfer shape that a retry may clear
    once the pressure passes (``torch.cuda.OutOfMemoryError``, a message
    holding "CUDA out of memory" or "out of memory", a transfer or
    unavailable device, ``MemoryError``, and the injected
    :class:`TransientDeviceError`): retried with bounded exponential
    backoff (``search.staging.retry.*``);
  - deterministic: a shape, dtype or value error that recurs on every
    attempt: never retried; the caller demotes the plane ladder and
    quarantines the plane with reason ``staging_fault``.
- ``run_staged`` is the one retry loop. Every retry and terminal fault is
  recorded on the DeviceMemoryAccountant (``staging_retries_total``,
  ``staging_faults_*`` and the ``staging_fault_events`` ring of
  ``search_stats()["memory"]``).

A ``KernelError`` (a CUDA kernel that fails to build, load or launch) is
no staging fault: ``run_staged`` re-raises it untouched and unrecorded,
and it raises to the caller; no rung serves in a kernel's place.

The retry knobs are node settings: the node seeds the process-level
config at startup (``configure_staging_retry``), and ``PUT
_cluster/settings`` updates it (an explicit cluster value wins, clearing
it reverts to the node's). The JAX package's cancellation pass-through
waits for the port's task cancellation.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

DEFAULT_MAX_ATTEMPTS = 3
DEFAULT_BACKOFF_MS = 10.0

TRANSIENT = "transient"
DETERMINISTIC = "deterministic"


class StagingBail(Exception):
    """A structural (request- or mapping-shaped) inability found inside a
    staging attempt, not a device fault: ``run_staged`` re-raises it at
    once, with no retry and no fault accounting (the caller owns its
    meaning, e.g. "this segment set can never stage this field")."""


class TransientDeviceError(RuntimeError):
    """A transient device-plane fault (an out-of-memory or transfer error):
    the staging is expected to succeed on a retry. Raised by the fault
    injection schemes (``testing/disruption.StagingFailScheme``)."""


# message markers of allocator and transport faults: they recur only while
# the device is under pressure, so they retry
_TRANSIENT_MARKERS = (
    "cuda out of memory",
    "out of memory",
    "resource_exhausted",
    "resource exhausted",
    "unavailable",
    "transfer",
    "connection reset",
)


def classify_staging_fault(exc: BaseException) -> str:
    """``transient`` or ``deterministic`` (see the module docstring)."""
    try:
        import torch

        oom = getattr(torch.cuda, "OutOfMemoryError", None)
    except ImportError:  # pragma: no cover - torch is a dependency
        oom = None
    if oom is not None and isinstance(exc, oom):
        return TRANSIENT
    if isinstance(exc, (TransientDeviceError, MemoryError, OSError,
                        ConnectionError, TimeoutError)):
        return TRANSIENT
    if isinstance(exc, (ValueError, TypeError, KeyError, IndexError,
                        AssertionError, AttributeError)):
        return DETERMINISTIC
    msg = str(exc).lower()
    if any(marker in msg for marker in _TRANSIENT_MARKERS):
        return TRANSIENT
    return DETERMINISTIC


# ---------------------------------------------------------------------------
# Retry configuration (search.staging.retry.*)
# ---------------------------------------------------------------------------

_cfg_lock = threading.Lock()
_max_attempts = DEFAULT_MAX_ATTEMPTS
_backoff_ms = DEFAULT_BACKOFF_MS


def configure_staging_retry(max_attempts: Optional[int] = None,
                            backoff_ms: Optional[float] = None) -> None:
    """Set the process-level retry config (node startup). None leaves a
    knob unchanged."""
    global _max_attempts, _backoff_ms
    with _cfg_lock:
        if max_attempts is not None:
            _max_attempts = max(1, int(max_attempts))
        if backoff_ms is not None:
            _backoff_ms = max(0.0, float(backoff_ms))


def staging_retry_config() -> Tuple[int, float]:
    """(max_attempts, backoff_ms), the process-level config."""
    return _max_attempts, _backoff_ms


def run_staged(fn, *, index: str, kind: str, plane: str = "host"):
    """Run one staging attempt under the classified-recovery contract.

    ``fn`` performs the whole attempt (its fault-injection hook included,
    so a retry consults the schemes again). A transient fault retries up
    to ``max_attempts`` attempts in all with exponential backoff; a
    deterministic one raises at once. The terminal fault (either class) is
    recorded on the accountant and re-raised: the caller owns the rollback
    of anything it published and the ladder's decision."""
    from elasticsearch_tpu_torch.common.memory import memory_accountant
    from elasticsearch_tpu_torch.ops.cuda_kernels import KernelError

    max_attempts, backoff_ms = staging_retry_config()
    acct = memory_accountant()
    attempt = 0
    while True:
        try:
            return fn()
        except (StagingBail, KernelError):
            # a structural inability, or a kernel that cannot build or
            # launch: the caller's contract, never a staging fault
            raise
        except Exception as e:  # noqa: BLE001 — classified below;
            # BaseExceptions (KeyboardInterrupt) pass through
            cls = classify_staging_fault(e)
            if cls == TRANSIENT and attempt + 1 < max_attempts:
                attempt += 1
                acct.note_staging_retry(index, kind)
                if backoff_ms > 0:
                    time.sleep(backoff_ms * (2 ** (attempt - 1)) / 1000.0)
                continue
            acct.note_staging_fault(index, kind, transient=(cls == TRANSIENT),
                                    retries=attempt, plane=plane,
                                    error=f"{type(e).__name__}: {e}")
            raise
