"""K7 wrapper: batched Lawson-Hanson NNLS on Gram systems (``csrc/nnls.cu``).

Replaces no Pallas kernel: it is the port of the JAX package's on-device
NNLS loops (``slam_process_tpu/ops/nnls.py::nnls_gram``, its two bounded
``lax.while_loop``s), whose eager counterpart, ``ops/nnls.nnls_gram_plain``,
asks the host once a loop step whether every lane is done.  Same inputs
(G [S, K, K] f32, b [S, K] f32, ``max_outer``, ``solver``, the warm start
x0 [S, K] f32 / P0 [S, K] bool or None) and outputs (x [S, K] f32, P [S,
K] bool), with each lane's loops on the device: one launch of S blocks (one
warp at K <= 3, a warp per 32 elements of the [K, K+1] solve tile above),
no host read.  ``ops/nnls.nnls_gram`` dispatches here for CUDA
tensors; see the source note in ``csrc/nnls.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from slam_process_tpu_torch.ops import _build

LAUNCHES = 0   # kernel launches since the caller last set it to 0
LAUNCHES_BY_K = {}   # the same launches by K, since the caller last cleared it
MAX_K = 32
SOLVERS = {"auto": 0, "lu": 1}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().slam_nnls_gram
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _need(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"NNLS kernel needs {name} on {dev} (CUDA), got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"NNLS kernel needs contiguous {dtype} {list(shape)} {name}, got "
                         f"{t.dtype} {list(t.shape)}")


def nnls_gram_cuda(G: torch.Tensor, b: torch.Tensor, max_outer: int = 64, solver: str = "auto",
                   x0: Optional[torch.Tensor] = None, P0: Optional[torch.Tensor] = None):
    """(x [S, K] f32, P [S, K] bool) on the card: ``ops/nnls.nnls_gram``'s
    contract, 1 <= K <= 32."""
    global LAUNCHES
    dev = G.device
    if not G.is_cuda or G.dim() != 3:
        raise ValueError(f"NNLS kernel needs CUDA [S, K, K] Grams, got {G.device} "
                         f"{list(G.shape)}")
    s_n, k_n = G.shape[:2]
    if not 1 <= k_n <= MAX_K:
        raise ValueError(f"NNLS kernel takes 1..{MAX_K} atoms, got K={k_n}")
    if solver not in SOLVERS:
        raise ValueError(f"unknown NNLS solver {solver!r}")
    _need(G, "G", torch.float32, (s_n, k_n, k_n), dev)
    _need(b, "b", torch.float32, (s_n, k_n), dev)
    if x0 is not None:
        _need(x0, "x0", torch.float32, (s_n, k_n), dev)
    if P0 is not None:
        _need(P0, "P0", torch.bool, (s_n, k_n), dev)
    x = torch.empty((s_n, k_n), dtype=torch.float32, device=dev)
    P = torch.empty((s_n, k_n), dtype=torch.bool, device=dev)
    if s_n == 0:
        return x, P
    with torch.cuda.device(dev):
        err = _fn()(G.data_ptr(), b.data_ptr(), None if x0 is None else x0.data_ptr(),
                    None if P0 is None else P0.data_ptr(), s_n, k_n, int(max_outer),
                    SOLVERS[solver], x.data_ptr(), P.data_ptr(), _build.stream_of(G))
    _build.check(err, "NNLS kernel")
    LAUNCHES += 1
    LAUNCHES_BY_K[k_n] = LAUNCHES_BY_K.get(k_n, 0) + 1
    return x, P
