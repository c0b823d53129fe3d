"""Persistent XLA compilation cache (bench.py, app.py, chip_smoke.py and
__graft_entry__.py all enable it from here).

The big 1080p/4K frame programs take minutes to compile; with the on-disk
cache a warmed process pays a cache read instead. Plays the role of the
reference's offline-compiled SPIR-V pipeline blobs (its compile.sh +
src/context.rs:924-1013 pipeline creation).

The directory is `JAX_COMPILATION_CACHE_DIR` when that variable is set, and
otherwise the fixed `<checkout>/.jax_cache`: the cache only hits when the
path is stable, so it never contains a temporary directory, pid or time.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

log = logging.getLogger(__name__)

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> Path:
    """JAX_COMPILATION_CACHE_DIR if set, else <checkout>/.jax_cache."""
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache(cache_dir: str | os.PathLike | None = None) -> bool:
    """Point jax at a persistent on-disk compilation cache. Safe to call
    before or after other jax imports; returns True when enabled."""
    try:
        import jax

        cache = Path(cache_dir) if cache_dir else default_cache_dir()
        cache.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(cache))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        return True
    except Exception as e:  # noqa: BLE001 — cache is best-effort
        log.debug("compile cache not enabled: %r", e)
        return False
