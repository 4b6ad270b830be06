"""Host and per-task resource statistics (ref client/stats/host.go and
drivers/shared/executor's pid stats collector).

The host collector samples /proc/stat, /proc/meminfo, /proc/uptime and
statvfs; CPU percentages come from deltas between consecutive samples, the
same ticker model the reference's HostStatsCollector uses. Task stats read
/proc/<pid>/stat for utime/stime/rss (cumulative CPU and current memory of
a live task process tree's root)."""

from __future__ import annotations

import os
import time
from typing import Optional

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _read_proc_stat() -> Optional[dict]:
    """Aggregate cpu line of /proc/stat: {user, system, idle, total} in
    ticks."""
    try:
        with open("/proc/stat") as f:
            for line in f:
                if line.startswith("cpu "):
                    parts = [int(x) for x in line.split()[1:]]
                    user, nice, system, idle = parts[0], parts[1], parts[2], parts[3]
                    iowait = parts[4] if len(parts) > 4 else 0
                    total = sum(parts)
                    return {
                        "user": user + nice,
                        "system": system,
                        "idle": idle + iowait,
                        "total": total,
                    }
    except OSError:
        pass
    return None


def _read_meminfo() -> dict:
    """{total, available, free, used} in bytes (ref stats/host.go Memory)."""
    fields = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                try:
                    fields[key] = int(rest.split()[0]) * 1024
                except (ValueError, IndexError):
                    continue
    except OSError:
        return {"total": 0, "available": 0, "free": 0, "used": 0}
    total = fields.get("MemTotal", 0)
    free = fields.get("MemFree", 0)
    available = fields.get("MemAvailable", free)
    return {
        "total": total,
        "available": available,
        "free": free,
        "used": total - available,
    }


def _read_uptime() -> float:
    try:
        with open("/proc/uptime") as f:
            return float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0


def disk_stats(path: str) -> dict:
    """{size, used, available, used_percent} for the filesystem holding
    ``path`` (ref stats/host.go DiskStats)."""
    try:
        st = os.statvfs(path)
    except OSError:
        return {"size": 0, "used": 0, "available": 0, "used_percent": 0.0}
    size = st.f_blocks * st.f_frsize
    available = st.f_bavail * st.f_frsize
    used = size - st.f_bfree * st.f_frsize
    return {
        "size": size,
        "used": used,
        "available": available,
        "used_percent": round(100.0 * used / size, 2) if size else 0.0,
    }


class HostStatsCollector:
    """Sampled host stats; CPU percent from /proc/stat deltas between
    calls (ref client/stats/cpu.go HostCpuStatsCalculator)."""

    _ZERO_CPU = {
        "total_percent": 0.0,
        "user_percent": 0.0,
        "system_percent": 0.0,
        "idle_percent": 0.0,
    }

    def __init__(self, data_dir: str = "/"):
        self.data_dir = data_dir
        self._prev = _read_proc_stat()
        self._prev_t = time.monotonic()
        # last computed percentages: re-served on a zero-tick delta (two
        # back-to-back collects inside one /proc/stat tick), where 0% CPU
        # would be a lie rather than a measurement
        self._last_cpu: Optional[dict] = None
        # one settle-and-resample per collector, not per call: a kernel
        # with no CPU accounting at all (sandboxed /proc/stat stuck at 0)
        # must not cost every collect() a sleep
        self._retry_spent = False

    def _cpu_percentages(self, retry: bool = True) -> dict:
        cur = _read_proc_stat()
        if cur is None or self._prev is None:
            if cur is not None:
                self._prev = cur
            return self._last_cpu or dict(self._ZERO_CPU)
        # iowait (folded into idle) is documented non-monotonic in
        # proc(5): clamp each delta so a decreasing counter can't push
        # a percentage below 0 / above 100
        cur = {k: max(v, self._prev[k]) for k, v in cur.items()}
        d_total = cur["total"] - self._prev["total"]
        if d_total <= 0:
            if self._last_cpu is not None:
                return self._last_cpu
            if retry and not self._retry_spent:
                # first-ever sample landed inside one tick: wait ~5 jiffies
                # and resample once instead of reporting 0%
                self._retry_spent = True
                time.sleep(0.05)
                return self._cpu_percentages(retry=False)
            return dict(self._ZERO_CPU)
        cpu = {
            "total_percent": round(
                100.0 * (d_total - (cur["idle"] - self._prev["idle"])) / d_total,
                2,
            ),
            "user_percent": round(
                100.0 * (cur["user"] - self._prev["user"]) / d_total, 2
            ),
            "system_percent": round(
                100.0 * (cur["system"] - self._prev["system"]) / d_total, 2
            ),
            "idle_percent": round(
                100.0 * (cur["idle"] - self._prev["idle"]) / d_total, 2
            ),
        }
        self._prev = cur
        self._prev_t = time.monotonic()
        self._last_cpu = cpu
        return cpu

    def collect(self) -> dict:
        return {
            "timestamp": time.time_ns(),
            "cpu": self._cpu_percentages(),
            "memory": _read_meminfo(),
            "disk": disk_stats(self.data_dir),
            "uptime_s": _read_uptime(),
        }


def pid_stats(pid: int) -> Optional[dict]:
    """Cumulative cpu time and current rss of ``pid`` from /proc/<pid>/stat
    (ref executor's pidCollector / ps lib)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            raw = f.read().decode("ascii", "replace")
    except OSError:
        return None
    # comm may contain spaces/parens: fields start after the closing paren
    rest = raw.rpartition(")")[2].split()
    if len(rest) < 22:
        return None
    utime, stime = int(rest[11]), int(rest[12])
    rss_pages = int(rest[21])
    return {
        "cpu_time_s": round((utime + stime) / _CLK_TCK, 3),
        "rss_bytes": rss_pages * _PAGE_SIZE,
    }


def task_resource_usage(handle) -> dict:
    """ResourceUsage doc for one task handle (ref
    drivers/shared/executor TaskStats → TaskResourceUsage). CPU percent
    comes from the delta against the previous sample cached on the handle
    — the reference's stats collector uses the same consecutive-sample
    ticker model."""
    usage = {
        "cpu_time_s": 0.0,
        "cpu_percent": 0.0,
        "rss_bytes": 0,
        "pids": 0,
        "timestamp": time.time_ns(),
    }
    pid = getattr(handle, "pid", 0)
    if not pid or handle._done.is_set():
        return usage
    # walk the task's process tree: the driver's child plus descendants
    pids = _descendants(pid)
    for p in pids:
        st = pid_stats(p)
        if st is not None:
            usage["cpu_time_s"] = round(usage["cpu_time_s"] + st["cpu_time_s"], 3)
            usage["rss_bytes"] += st["rss_bytes"]
            usage["pids"] += 1
    prev = getattr(handle, "_stats_prev", None)
    if prev is not None:
        dt = (usage["timestamp"] - prev[1]) / 1e9
        if dt < 1.0:
            # two samplers (host rollup + alloc endpoint) share this slot:
            # a sub-second delta is numerically worthless, so reuse the
            # last percent and KEEP the baseline — otherwise concurrent
            # pollers corrupt each other's deltas
            usage["cpu_percent"] = prev[2]
            return usage
        usage["cpu_percent"] = round(
            max(usage["cpu_time_s"] - prev[0], 0.0) / dt * 100.0, 2
        )
    handle._stats_prev = (
        usage["cpu_time_s"], usage["timestamp"], usage["cpu_percent"]
    )
    return usage


def _descendants(root: int) -> list[int]:
    """root + all transitive children, via /proc/<pid>/task/<tid>/children."""
    out, frontier = [], [root]
    seen = set()
    while frontier:
        pid = frontier.pop()
        if pid in seen:
            continue
        seen.add(pid)
        out.append(pid)
        try:
            for tid in os.listdir(f"/proc/{pid}/task"):
                try:
                    with open(f"/proc/{pid}/task/{tid}/children") as f:
                        frontier.extend(int(c) for c in f.read().split())
                except (OSError, ValueError):
                    continue
        except OSError:
            continue
    return out
