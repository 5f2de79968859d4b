"""Persistent host-side setup cache (content-addressed npz files).

The multigrid build's host work -- barycentric transfer construction
(point location of ~1e5 fine dofs in each coarser mesh) -- is pure in
the mesh/dof data, so like FEniCS's FFC JIT-kernel cache (the reference
relies on dolfin's dijitso cache for every form it compiles) we persist
it across processes: keyed by a sha256 of the defining arrays, stored
as .npz under FEU_CACHE_DIR (default <repo>/.feu_cache, listed in
.gitignore).

Disable with FEU_DISK_CACHE=0.  Writes are atomic (tmp + rename); a
corrupt/partial file is treated as a miss and rebuilt.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["cache_key_of", "load_arrays", "store_arrays", "cached_arrays"]

_SENTINEL_PREFIX = "__scalar_"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_REPO_CACHE = os.path.join(_REPO_ROOT, ".feu_cache")


def _cache_dir() -> Optional[str]:
    if os.environ.get("FEU_DISK_CACHE", "1") == "0":
        return None
    d = os.environ.get("FEU_CACHE_DIR", _REPO_CACHE)
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        return None
    return d


def cache_key_of(*parts) -> str:
    """sha256 over a mixed list of arrays / scalars / strings / None."""
    h = hashlib.sha256()
    for p in parts:
        if p is None:
            h.update(b"\x00none")
        elif isinstance(p, np.ndarray):
            a = np.ascontiguousarray(p)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"\x1f")
    return h.hexdigest()


def load_arrays(tag: str, key: str) -> Optional[Dict[str, np.ndarray]]:
    d = _cache_dir()
    if d is None:
        return None
    path = os.path.join(d, f"{tag}-{key}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            out = {}
            for k in z.files:
                v = z[k]
                if k.startswith(_SENTINEL_PREFIX):
                    out[k[len(_SENTINEL_PREFIX):]] = v.item()
                else:
                    out[k] = v
            return out
    except Exception:
        # corrupt/partial file: a miss, rebuilt by the caller
        try:
            os.remove(path)
        except OSError:
            pass
        return None


def store_arrays(tag: str, key: str, arrays: Dict[str, object]) -> None:
    d = _cache_dir()
    if d is None:
        return
    path = os.path.join(d, f"{tag}-{key}.npz")
    payload = {}
    for k, v in arrays.items():
        if isinstance(v, np.ndarray):
            payload[k] = v
        else:  # int/float scalar
            payload[_SENTINEL_PREFIX + k] = np.asarray(v)
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except OSError:
        if tmp is not None:
            try:
                os.remove(tmp)
            except Exception:
                pass


def cached_arrays(tag: str, key: str,
                  builder: Callable[[], Dict[str, object]]):
    """Load `tag`/`key` from the cache, or build + persist.  Returns
    (arrays, hit: bool)."""
    hit = load_arrays(tag, key)
    if hit is not None:
        return hit, True
    out = builder()
    store_arrays(tag, key, out)
    return out, False
