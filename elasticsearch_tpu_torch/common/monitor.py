"""OS, process and filesystem probes for ``_nodes/stats``.

Counterpart of ``elasticsearch_tpu/common/monitor.py``, copied: the probes
read /proc directly (Linux) and degrade to -1 or an absent field
elsewhere; standard library only.
"""

from __future__ import annotations

import os
import time
from typing import Optional


def _read(path: str) -> Optional[str]:
    try:
        with open(path, encoding="ascii") as f:
            return f.read()
    except OSError:
        return None


def os_stats() -> dict:
    """OsProbe.osStats: load averages, cpu percent (best effort), memory
    and swap from /proc/meminfo."""
    out: dict = {"timestamp": int(time.time() * 1000)}
    try:
        la1, la5, la15 = os.getloadavg()
        out["cpu"] = {"load_average": {"1m": round(la1, 2),
                                       "5m": round(la5, 2),
                                       "15m": round(la15, 2)}}
    except OSError:
        out["cpu"] = {}
    mem = _read("/proc/meminfo")
    if mem:
        kv = {}
        for line in mem.splitlines():
            parts = line.split()
            if len(parts) >= 2 and parts[0].endswith(":"):
                kv[parts[0][:-1]] = int(parts[1]) * 1024
        total = kv.get("MemTotal", 0)
        free = kv.get("MemAvailable", kv.get("MemFree", 0))
        used = max(total - free, 0)
        out["mem"] = {
            "total_in_bytes": total,
            "free_in_bytes": free,
            "used_in_bytes": used,
            "free_percent": int(free * 100 / total) if total else 0,
            "used_percent": int(used * 100 / total) if total else 0,
        }
        out["swap"] = {
            "total_in_bytes": kv.get("SwapTotal", 0),
            "free_in_bytes": kv.get("SwapFree", 0),
            "used_in_bytes": max(kv.get("SwapTotal", 0)
                                 - kv.get("SwapFree", 0), 0),
        }
    return out


def process_stats() -> dict:
    """ProcessProbe: open fds, cpu time, virtual/resident memory of THIS
    process from /proc/self."""
    out: dict = {"timestamp": int(time.time() * 1000)}
    try:
        out["open_file_descriptors"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        out["open_file_descriptors"] = -1
    out["max_file_descriptors"] = -1
    try:
        import resource

        out["max_file_descriptors"] = resource.getrlimit(
            resource.RLIMIT_NOFILE)[0]
        ru = resource.getrusage(resource.RUSAGE_SELF)
        out["cpu"] = {
            "percent": -1,
            "total_in_millis": int((ru.ru_utime + ru.ru_stime) * 1000),
        }
        out["mem"] = {"total_virtual_in_bytes": -1,
                      "resident_in_bytes": ru.ru_maxrss * 1024}
    except ImportError:
        pass
    statm = _read("/proc/self/statm")
    if statm:
        pages = statm.split()
        page = os.sysconf("SC_PAGE_SIZE")
        out.setdefault("mem", {})
        out["mem"]["total_virtual_in_bytes"] = int(pages[0]) * page
        out["mem"]["resident_in_bytes"] = int(pages[1]) * page
    return out


def fs_stats(data_path: str = ".") -> dict:
    """FsProbe: totals of the data path's filesystem."""
    import shutil

    try:
        du = shutil.disk_usage(data_path or ".")
    except OSError:
        return {"timestamp": int(time.time() * 1000), "total": {}}
    return {
        "timestamp": int(time.time() * 1000),
        "total": {
            "total_in_bytes": du.total,
            "free_in_bytes": du.free,
            "available_in_bytes": du.free,
        },
        "data": [{"path": data_path,
                  "total_in_bytes": du.total,
                  "free_in_bytes": du.free,
                  "available_in_bytes": du.free}],
    }
