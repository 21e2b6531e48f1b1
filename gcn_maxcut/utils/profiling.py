"""Profiling and per-step metrics (SURVEY.md §5.1 build requirements).

The reference's only instrumentation is ``time.time()`` deltas and prints.
Here:
  * ``trace(logdir)`` — ``jax.profiler`` trace context (view in
    TensorBoard / Perfetto) around any region.
  * ``annotate(name)`` — named trace region (``TraceAnnotation``).
  * ``MetricsLogger`` — structured per-step JSONL metrics: loss, cut,
    edges/s, step wall time; consumed by the report generators.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a device profile into ``logdir`` for TensorBoard/Perfetto."""
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return jax.profiler.TraceAnnotation(name)


class MetricsLogger:
    """Append-only JSONL metrics stream + in-memory history."""

    def __init__(self, path: Optional[str | Path] = None):
        self.path = Path(path) if path else None
        self.history: list[Dict[str, Any]] = []
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t_last = time.perf_counter()

    def log(self, step: int, **metrics: Any) -> Dict[str, Any]:
        now = time.perf_counter()
        rec = {
            "step": step,
            "time": time.time(),
            "step_time_s": now - self._t_last,
            **{
                k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                for k, v in metrics.items()
            },
        }
        self._t_last = now
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def edges_per_s(self, n_edges: int) -> Optional[float]:
        if not self.history:
            return None
        dt = self.history[-1]["step_time_s"]
        return n_edges / dt if dt > 0 else None


def memory_stats(compiled) -> Dict[str, int]:
    """Device byte counts of a compiled executable
    (``jit(f).lower(...).compile()``): arguments, outputs, temporaries,
    aliased buffers and generated code, plus XLA's peak estimate."""
    m = compiled.memory_analysis()
    return {
        k: int(getattr(m, k))
        for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes", "peak_memory_in_bytes",
        )
    }
