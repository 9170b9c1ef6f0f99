"""Build and load the repository's native C++ libraries and tools
(``native/``) for the port's tokenizer, HTTP server, key-value reader, HNSW
index and load generator (counterpart of lightningdot_tpu/native_build.py).

``load_native(name)`` runs ``make`` for ``native/build/lib<name>.so`` alone,
under an exclusive file lock (processes that start together never load a
half-linked file), and loads it; None where it cannot be built, so that the
callers take their pure-Python paths. ``build_native(target)`` builds any
other target of ``native/Makefile`` under the same lock and raises where it
cannot.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Dict, Optional

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_cache: Dict[str, Optional[ctypes.CDLL]] = {}


def _make(target: str) -> None:
    import fcntl

    (NATIVE_DIR / "build").mkdir(exist_ok=True)
    with open(NATIVE_DIR / "build" / ".port_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", str(NATIVE_DIR), target], check=True,
                       capture_output=True, timeout=180)


def build_native(target: str) -> Path:
    """``native/<target>`` (e.g. ``build/ldloadgen``), built first if
    missing or stale; a failed build raises ``RuntimeError`` with make's
    output."""
    try:
        _make(target)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"make {target} failed: {e.stdout!r} "
                           f"{e.stderr!r}") from e
    return NATIVE_DIR / target


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """``native/build/lib<name>.so``, built first if missing or stale."""
    if name in _cache:
        return _cache[name]
    target = f"build/lib{name}.so"
    so = NATIVE_DIR / target
    try:
        _make(target)
    except (OSError, subprocess.SubprocessError):
        if not so.exists():
            _cache[name] = None
            return None
    try:
        _cache[name] = ctypes.CDLL(str(so))
    except OSError:
        _cache[name] = None
    return _cache[name]
