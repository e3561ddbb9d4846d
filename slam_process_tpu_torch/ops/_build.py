"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first CUDA use the sources are compiled with ``nvcc`` for ``sm_90a``,
one ``nvcc -c`` per source, all started together, then linked into one
shared library with a plain C interface:

    build/slam_process_tpu_torch/<source-hash>/libslam_kernels.so

next to the package's parent directory.  The hash covers the sources and
the flags, so an edited source builds anew.  The library is loaded with
``ctypes``; each kernel module declares its own function's ``argtypes``
(every pointer and the stream as ``c_void_p``).  A failed build raises
with nvcc's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "slam_process_tpu_torch"
LIB_NAME = "libslam_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({home}); the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed build directory (once)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".building-"))
    try:
        nvcc = _nvcc()
        jobs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(tmp / f"{src.stem}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources()]
        log, failed = [], []
        for src, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / f"{src.stem}.o") for src in sources())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "nvcc.log").write_text("\n".join(log))
        try:
            os.rename(tmp, out_dir)
        except OSError:       # another process finished the same build first
            if not lib.exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return ctypes.CDLL(str(build()))


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


_SCRATCH = {}   # (kernel, device index, stream) -> its int64 scratch words


def scratch(kernel: str, dev, stream: int, words: int, least: int):
    """A kernel's int64 scratch on ``dev`` for ``stream``: at least
    ``words`` words, zeroed when made (with at least ``least`` words) or
    grown.  Launches on one stream run in order, and each leaves the words
    ready for the next, so one scratch serves every call on the stream.

    Never made inside a CUDA graph capture: it would come from the graph's
    private pool and be shared with eager calls.  A graph's warm-up, on the
    capture stream, makes it first (``utils/graphs.py``), and a graph keeps
    the scratch it was captured with alive (``scratch_tensors``) where a
    later call grows it."""
    import torch

    key = (kernel, dev.index, stream)
    t = _SCRATCH.get(key)
    if t is None or t.numel() < words:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}: its scratch would be made inside a CUDA graph "
                               "capture; run the program once on the capture stream first")
        t = _SCRATCH[key] = torch.zeros(max(words, least), dtype=torch.int64, device=dev)
    return t


def scratch_tensors() -> list:
    """Every kernel scratch made so far in this process."""
    return list(_SCRATCH.values())
