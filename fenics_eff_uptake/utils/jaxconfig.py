"""JAX runtime configuration: float64 and the persistent compile cache.

Studies, bench.py, chip_smoke.py and the graft entry call ``setup()``
before their first jit dispatch.  The persistent compilation cache lives
where JAX_COMPILATION_CACHE_DIR says (JAX reads that variable itself, so
no other path is set in code); without it, at a fixed path inside the
checkout (<repo>/.jax_cache, listed in .gitignore).
"""

from __future__ import annotations

import os

__all__ = ["setup", "compile_cache_dir", "REPO_CACHE_DIR"]

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir():
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def setup(x64=True):
    import jax
    if x64:
        jax.config.update("jax_enable_x64", True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    # cache every compile, not only those above JAX's 1 s default: a
    # study issues dozens of sub-second assembly and metrics compiles
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return jax
