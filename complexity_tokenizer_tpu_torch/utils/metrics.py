"""Observability: a registry of counters and timers, and an optional
``torch.profiler`` trace.

The counters hold what the batch paths feed them: texts encoded and
decoded (``encode_batch_ragged``, ``decode_batch_ragged``) and the words
of the vocabulary warm start, each with its seconds, so that
``snapshot()`` reads texts per second and words per second.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

__all__ = ["Counters", "counters", "profile_trace", "Timer"]


class Counters:
    def __init__(self):
        self._counts: dict[str, float] = defaultdict(float)
        self._times: dict[str, float] = defaultdict(float)

    def add(self, name: str, value: float = 1.0) -> None:
        self._counts[name] += value

    def add_time(self, name: str, seconds: float) -> None:
        self._times[name] += seconds

    def rate(self, name: str) -> float:
        t = self._times.get(name, 0.0)
        return self._counts.get(name, 0.0) / t if t > 0 else 0.0

    def snapshot(self) -> dict:
        out = dict(self._counts)
        out.update({f"{k}_seconds": v for k, v in self._times.items()})
        for k in self._counts:
            if k in self._times and self._times[k] > 0:
                out[f"{k}_per_s"] = self._counts[k] / self._times[k]
        return out

    def reset(self) -> None:
        self._counts.clear()
        self._times.clear()


counters = Counters()


class Timer:
    """Context manager adding its wall time (and ``count``) to a counter."""

    def __init__(self, name: str, count: float = 0.0, registry: Counters = counters):
        self.name = name
        self.count = count
        self.registry = registry

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.registry.add_time(self.name, dt)
        if self.count:
            self.registry.add(self.name, self.count)
        return False


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block (CPU and, where there is a
    card, CUDA activity) written to ``log_dir`` for TensorBoard; nothing
    when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ):
        yield
