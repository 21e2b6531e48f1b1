"""Debug-mode helpers (SURVEY.md §5.2 build requirements).

The reference has no sanitizers (single-threaded Python).  Accelerator-native
equivalents:
  * ``debug_mode()`` — context enabling ``jax_debug_nans`` +
    ``jax_disable_jit``-free NaN surfacing for numerics hunts.
  * ``checked(fn)`` — ``checkify`` wrapper surfacing index-out-of-bounds /
    NaN / div-by-zero errors from inside jit (the moral analog of a
    sanitizer for traced code).
  * ``assert_finite(tree)`` — host-side pytree finiteness check for tests
    and step callbacks.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import jax
import numpy as np
from jax.experimental import checkify


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Enable NaN/Inf debugging inside the context (restores on exit)."""
    old_nan = jax.config.jax_debug_nans
    old_inf = jax.config.jax_debug_infs
    try:
        jax.config.update("jax_debug_nans", nans)
        jax.config.update("jax_debug_infs", infs)
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nan)
        jax.config.update("jax_debug_infs", old_inf)


def checked(fn: Callable, *, errors=checkify.all_checks) -> Callable:
    """Wrap ``fn`` with checkify; the wrapper raises on traced errors.

    Usage: ``safe_step = checked(jit_step); out = safe_step(...)``.
    """
    cfn = checkify.checkify(fn, errors=errors)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        err.throw()
        return out

    return wrapper


def assert_finite(tree: Any, name: str = "tree") -> None:
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in {name} at {jax.tree_util.keystr(path)}"
            )
