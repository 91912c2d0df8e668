"""Runtime counters and logging for the serving engine.

A dependency-free registry the engine updates every scheduler step, plus
the package logger. Host wall timings measure the scheduler loop; on the
card the engine synchronises before reading logits, so a step's timing
covers its device work.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

logger = logging.getLogger("sgl_kernel_tpu_torch")


class Timer:
    """count / total / min / max / EWMA(0.1) of observed durations."""

    __slots__ = ("count", "total", "min", "max", "ewma")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.ewma = 0.0

    def observe(self, seconds: float):
        self.count += 1
        self.total += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)
        self.ewma = seconds if self.count == 1 else 0.9 * self.ewma + 0.1 * seconds


class Metrics:
    """Flat registry: integer counters, float gauges, duration timers."""

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.timers: Dict[str, Timer] = {}
        self._t0 = time.perf_counter()

    def inc(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float):
        self.gauges[name] = value

    def observe(self, name: str, seconds: float):
        self.timers.setdefault(name, Timer()).observe(seconds)

    def time(self, name: str):
        """Context manager: with metrics.time("step"): ..."""
        return _TimeCtx(self, name)

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.counters)
        out.update(self.gauges)
        for name, t in self.timers.items():
            if t.count:
                out[f"{name}_count"] = t.count
                out[f"{name}_total_s"] = t.total
                out[f"{name}_mean_ms"] = 1e3 * t.total / t.count
                out[f"{name}_ewma_ms"] = 1e3 * t.ewma
                out[f"{name}_max_ms"] = 1e3 * t.max
        up = time.perf_counter() - self._t0
        out["uptime_s"] = up
        dec = self.counters.get("tokens_decoded", 0)
        if dec and up > 0:
            out["decode_tok_per_s"] = dec / up
        return out

    def log_line(self) -> str:
        s = self.snapshot()
        keys = (
            "scheduler_steps", "requests_finished", "tokens_prefilled",
            "tokens_decoded", "decode_tok_per_s", "free_pages", "step_ewma_ms",
        )
        parts = []
        for k in keys:
            if k in s:
                v = s[k]
                parts.append(f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}")
        return " ".join(parts)


class _TimeCtx:
    __slots__ = ("m", "name", "t0")

    def __init__(self, m: Metrics, name: str):
        self.m = m
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.m.observe(self.name, time.perf_counter() - self.t0)
        return False
