"""ctypes binding and lazy build of the native hex scanner (``hexscan.c``).

The library is compiled once with the system C compiler (``$CC``, else
``cc``) at ``-O3 -march=native`` into

    build/slam_process_tpu_torch/hexscan-<hash>/libhexscan.so

next to the package's parent directory.  The hash covers the source, the
compiler command and the host CPU (``/proc/cpuinfo``'s model name, vendor,
family, model and feature flags), so a library built with
``-march=native`` on another machine (a ``build/`` copied along with the
checkout) is never loaded.  A failed build raises
``RuntimeError`` with the compiler's output and is not retried in the same
process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).with_name("hexscan.c")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "slam_process_tpu_torch"
LIB_NAME = "libhexscan.so"
CFLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _compiler() -> str:
    return os.environ.get("CC", "cc")


CPU_KEYS = ("model name", "vendor_id", "cpu family", "model", "flags", "Features", "CPU part")


def cpu_info() -> dict:
    """The host CPU's entries of ``/proc/cpuinfo`` that ``-march=native``
    compiles for (model name, vendor, family, model, feature flags; the
    first CPU's), empty where there is no such file."""
    info = {}
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return info
    for line in lines:
        key, _, value = line.partition(":")
        if key.strip() in CPU_KEYS:
            info.setdefault(key.strip(), value.strip())
    return info


def cpu_identity() -> str:
    """The host CPU as one string: ``cpu_info``'s entries, or
    ``platform.processor()`` where it has none."""
    info = cpu_info()
    return ("\n".join(f"{k}: {v}" for k, v in sorted(info.items()))
            or platform.processor() or platform.machine())


def library_path() -> Path:
    """Where the library for this source, compiler and CPU lives."""
    h = hashlib.sha256()
    for part in (SRC.read_bytes(), " ".join((_compiler(),) + CFLAGS).encode(),
                 cpu_identity().encode()):
        h.update(part)
        h.update(b"\0")
    return BUILD_ROOT / f"hexscan-{h.hexdigest()[:16]}" / LIB_NAME


def _compile(lib: Path) -> None:
    lib.parent.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=lib.parent.parent, prefix=".building-hexscan-"))
    try:
        proc = subprocess.run([_compiler(), *CFLAGS, str(SRC), "-o", str(tmp / LIB_NAME)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"hexscan build failed ({_compiler()} exit "
                               f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        try:
            os.rename(tmp, lib.parent)
        except OSError:       # another process finished the same build first
            if not lib.exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp)


def _load() -> ctypes.CDLL:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(f"hexscan build previously failed: {_build_error}")
        lib_path = library_path()
        if not lib_path.exists():
            try:
                _compile(lib_path)
            except Exception as e:  # missing toolchain, compiler error, timeout
                _build_error = str(e)
                raise RuntimeError(f"hexscan build failed: {e}") from e
        lib = ctypes.CDLL(str(lib_path))
        lib.hexscan_tokenize.restype = ctypes.c_size_t
        lib.hexscan_tokenize.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                                         ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def tokenize(data: bytes) -> np.ndarray:
    """Native tokenizer: raw log bytes -> uint8 byte values (the grammar of
    ``io/hexlog.tokenize_hex``)."""
    lib = _load()
    n = len(data)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    out = np.empty(n // 2 + 1, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    written = lib.hexscan_tokenize(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[:written]
