"""Process-wide counters, gauges and latency timers.

Counterpart of the part of ``paddle_tpu/monitor.py`` that the ported
paths call: ``stat_add``/``stat_get`` (counters), ``gauge_set``/
``gauge_get``, ``timer_observe``/``timer_get`` (latency histograms,
microseconds by convention, with p50/p95 over a ring of the last 1024
samples) and ``reset_all``. The instrument names are the reference's
(``STAT_generation_*``, ``GAUGE_*``, ``TIMER_*``), and ``labeled``
composes a labeled series name (``STAT_mesh_collective_bytes{axis="dp",
dtype="int8"}``) as the JAX package does. Time windows and exporters are
not ported yet (``ROADMAP.md`` A7).
"""
from __future__ import annotations

import threading
from typing import Dict, List

_LOCK = threading.Lock()
_STATS: Dict[str, float] = {}
_GAUGES: Dict[str, float] = {}
_TIMERS: Dict[str, "_Timer"] = {}
_TIMER_RING = 1024


class _Timer:
    """One latency histogram; mutated under _LOCK only."""

    __slots__ = ("count", "sum", "min", "max", "ring", "idx")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.ring: List[float] = []
        self.idx = 0

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.ring) < _TIMER_RING:
            self.ring.append(v)
        else:
            self.ring[self.idx] = v
            self.idx = (self.idx + 1) % _TIMER_RING

    def stats(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0}
        s = sorted(self.ring)
        n = len(s)

        def q(p: float) -> float:
            return s[min(n - 1, int(p * (n - 1) + 0.5))]
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "p50": q(0.50), "p95": q(0.95)}


def stat_add(name: str, value: float = 1.0) -> None:
    with _LOCK:
        _STATS[name] = _STATS.get(name, 0.0) + float(value)


def labeled(name: str, labels: Dict[str, str]) -> str:
    """``name{k="v",...}`` with the keys sorted and the values escaped
    (``paddle_tpu/monitor.py:labeled``)."""
    if not labels:
        return name
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\") \
            .replace('"', '\\"').replace("\n", "\\n")
        parts.append('%s="%s"' % (k, v))
    return "%s{%s}" % (name, ",".join(parts))


def stats_with_prefix(prefix: str) -> Dict[str, float]:
    """Every counter whose name starts with ``prefix``."""
    with _LOCK:
        return {k: v for k, v in _STATS.items() if k.startswith(prefix)}


def stat_get(name: str) -> float:
    with _LOCK:
        return _STATS.get(name, 0.0)


def gauge_set(name: str, value: float) -> None:
    with _LOCK:
        _GAUGES[name] = float(value)


def gauge_get(name: str, default: float = 0.0) -> float:
    with _LOCK:
        return _GAUGES.get(name, default)


def timer_observe(name: str, value: float) -> None:
    """Record one latency sample (microseconds by convention)."""
    with _LOCK:
        t = _TIMERS.get(name)
        if t is None:
            t = _TIMERS[name] = _Timer()
        t.observe(float(value))


def timer_get(name: str) -> Dict[str, float]:
    """count, sum, min, max, p50 and p95 of one timer (zeros when
    absent)."""
    with _LOCK:
        t = _TIMERS.get(name)
        return t.stats() if t is not None else _Timer().stats()


def reset_all() -> None:
    """Drop every counter, gauge and timer (between runs that each read
    their own numbers)."""
    with _LOCK:
        _STATS.clear()
        _GAUGES.clear()
        _TIMERS.clear()
