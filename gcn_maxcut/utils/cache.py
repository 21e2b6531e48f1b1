"""Persistent XLA compilation cache.

Enabling JAX's persistent compilation cache makes every compile after the
first process near-free: traced programs are keyed by HLO + compile
options and reloaded from disk.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says, when it is set
(JAX then reads it itself, and this module sets no other directory).
Otherwise it lives at the fixed path ``<checkout>/.jax_cache``: the path is
part of the cache's key, so a directory that moved would never hit.

Call :func:`enable_compilation_cache` once per process before the first jit
execution (bench.py, chip_smoke.py and the CLI driver do).  Tests do NOT
enable it — they exercise fresh-compile behavior on the CPU backend.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compilation_cache() -> str:
    """Configure JAX's on-disk compilation cache (idempotent); returns its
    directory.

    Caches every compilation regardless of compile time or artifact size —
    this framework's programs are few and large.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
