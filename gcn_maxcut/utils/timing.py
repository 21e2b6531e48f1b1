"""Wall-clock timing helpers for phases and steps.

The reference scatters ``time.time()`` deltas through every module
(SURVEY.md §5.1); here they are one utility, with `jax.block_until_ready`
awareness so device work is actually measured.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import jax


class Timer:
    """Context manager measuring wall time; ``.elapsed`` in seconds."""

    def __init__(self, sync: Any = None):
        self._sync = sync
        self.elapsed = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            jax.block_until_ready(self._sync)
        self.elapsed = time.perf_counter() - self._start
        return False


class PhaseTimer:
    """Accumulates named phase durations (generation/processing/training...)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    def phase(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self._start = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.phases[name] = timer.phases.get(name, 0.0) + (
                    time.perf_counter() - self._start
                )
                return False

        return _Ctx()

    def summary(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k}: {v:.2f}s" for k, v in self.phases.items()]
        lines.append(f"total: {total:.2f}s")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Amortized in-jit timing: K chained applications of the op inside ONE jit
# (``lax.scan``), ended by a host scalar fetch that forces completion; the
# difference between a K_hi and a K_lo run cancels dispatch overhead.

import jax.numpy as jnp
from functools import partial


def scan_timeit(op, x0, k_hi: int = 50, k_lo: int = 10, reps: int = 3) -> float:
    """Trustworthy per-op seconds on any runtime.  ``op`` must map x -> x
    (same shape/dtype) so applications chain; give the op a data dependency
    on its input (e.g. ``x + 0.0 * result``) or XLA will CSE the copies."""

    @partial(jax.jit, static_argnames=("k",))
    def chain(x, k):
        y, _ = jax.lax.scan(lambda c, _: (op(c), None), x, None, length=k)
        return jnp.sum(y)

    float(chain(x0, k_hi))  # compile both signatures
    float(chain(x0, k_lo))
    best = {}
    for k in (k_hi, k_lo):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(chain(x0, k))
            ts.append(time.perf_counter() - t0)
        best[k] = min(ts)
    return max(1e-9, (best[k_hi] - best[k_lo]) / (k_hi - k_lo))


def scan_timeit_stats(
    op, x0, k_hi: int = 50, k_lo: int = 10, reps: int = 3, outer: int = 3
) -> Dict[str, float]:
    """Best-of-``outer`` :func:`scan_timeit` with spread, so that run
    variance is visible beside the best reading.

    Each outer sample is one full amortized measurement (inner
    best-of-``reps`` at both chunk lengths, differenced).  Non-positive
    differences (variance exceeded the signal) are dropped; if every
    sample is degenerate the result is NaN with ``n_valid = 0``.

    Returns ``{"best_s", "mean_s", "spread_s", "spread_frac", "n", "n_valid"}``.
    """
    import math

    @partial(jax.jit, static_argnames=("k",))
    def chain(x, k):
        y, _ = jax.lax.scan(lambda c, _: (op(c), None), x, None, length=k)
        return jnp.sum(y)

    float(chain(x0, k_hi))  # compile both signatures once
    float(chain(x0, k_lo))
    samples = []
    for _ in range(max(1, outer)):
        best = {}
        for k in (k_hi, k_lo):
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                float(chain(x0, k))
                ts.append(time.perf_counter() - t0)
            best[k] = min(ts)
        diff = best[k_hi] - best[k_lo]
        if diff > 0:
            samples.append(diff / (k_hi - k_lo))
    if not samples:
        return {
            "best_s": math.nan, "mean_s": math.nan, "spread_s": math.nan,
            "spread_frac": math.nan, "n": outer, "n_valid": 0,
        }
    best_s = min(samples)
    return {
        "best_s": best_s,
        "mean_s": sum(samples) / len(samples),
        "spread_s": max(samples) - best_s,
        "spread_frac": (max(samples) - best_s) / best_s,
        "n": outer,
        "n_valid": len(samples),
    }
