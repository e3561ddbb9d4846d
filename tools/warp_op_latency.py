#!/usr/bin/env python3
"""The latency, in SM clock cycles, of the warp operations on kernel K6's
chain (``csrc/tracker.cu``), measured on one NVIDIA GPU.

    python3 tools/warp_op_latency.py

One warp runs, for each operation, a chain of 4,096 dependent steps (each
step's input is the step before's result) between two ``clock64()`` reads,
and the script prints cycles per step, the median of 7 launches:

  redux_min    ``__reduce_min_sync`` (what a round runs twice);
  shfl         ``__shfl_sync`` with a computed source lane;
  ballot_ffs   ``__ballot_sync`` then ``__ffs``;
  any          ``__any_sync``;
  fns          ``__fns(mask, 0, r)`` (the r-th set bit);
  pop_clear    a loop of ``b &= b - 1`` to the r-th set bit, r <= 3;
  smem_load    a dependent shared-memory load;
  fadd_fmul    ``__fmul_rn`` then ``__fadd_rn`` (the cost's last two
               steps);
  iadd         an integer add (the floor of a dependent step).

Builds with nvcc into ``build/warp_op_latency/``; prints one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OPS = ("redux_min", "shfl", "ballot_ffs", "any", "fns", "pop_clear", "smem_load", "fadd_fmul",
       "iadd")
STEPS = 4096

SOURCE = r'''
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = STEPS;
constexpr unsigned kFull = 0xffffffffu;

template <int kOp>
__global__ void chain(unsigned seed, unsigned long long* cycles, unsigned* sink) {
  __shared__ unsigned s[1024];
  const unsigned lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) s[i] = (i * 7u + 3u) & 1023u;
  __syncwarp();
  unsigned v = seed + lane;
  float x = 1.0f + lane;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < kSteps; ++i) {
    if (kOp == 0) v = __reduce_min_sync(kFull, v + lane);
    if (kOp == 1) v = __shfl_sync(kFull, v, (v + lane) & 31u) + 1u;
    if (kOp == 2) v = static_cast<unsigned>(__ffs(__ballot_sync(kFull, ((v + lane) & 3u) == 0u))) + v;
    if (kOp == 3) v += static_cast<unsigned>(__any_sync(kFull, ((v + lane) & 7u) == 0u)) + 1u;
    if (kOp == 4) v += __fns(0x000F3A5Cu ^ (v & 0xFFu), 0, static_cast<int>(v & 3u) + 1) + 1u;
    if (kOp == 5) {
      unsigned b = 0x000F3A5Cu ^ (v & 0xFFu);
      for (unsigned r = v & 3u; r > 0; --r) b &= b - 1u;
      v += static_cast<unsigned>(__ffs(b)) + 1u;
    }
    if (kOp == 6) v = s[v & 1023u];
    if (kOp == 7) x = __fadd_rn(__fmul_rn(x, 0.999f), 1e-3f);
    if (kOp == 8) v += lane + 1u;
  }
  const long long t1 = clock64();
  if (lane == 0) *cycles = static_cast<unsigned long long>(t1 - t0);
  sink[lane] = v + __float_as_uint(x);
}

}  // namespace

extern "C" int warp_op_chain(int op, unsigned seed, void* cycles, void* sink) {
  unsigned long long* c = static_cast<unsigned long long*>(cycles);
  unsigned* k = static_cast<unsigned*>(sink);
  switch (op) {
    case 0: chain<0><<<1, 32>>>(seed, c, k); break;
    case 1: chain<1><<<1, 32>>>(seed, c, k); break;
    case 2: chain<2><<<1, 32>>>(seed, c, k); break;
    case 3: chain<3><<<1, 32>>>(seed, c, k); break;
    case 4: chain<4><<<1, 32>>>(seed, c, k); break;
    case 5: chain<5><<<1, 32>>>(seed, c, k); break;
    case 6: chain<6><<<1, 32>>>(seed, c, k); break;
    case 7: chain<7><<<1, 32>>>(seed, c, k); break;
    default: chain<8><<<1, 32>>>(seed, c, k);
  }
  return static_cast<int>(cudaGetLastError());
}
'''


def main() -> None:
    import torch

    from slam_process_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("warp_op_latency: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    out_dir = REPO / "build" / "warp_op_latency"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chain.cu").write_text(SOURCE.replace("STEPS", str(STEPS)))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / "chain.so"),
                    str(out_dir / "chain.cu")], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out_dir / "chain.so")).warp_op_chain
    fn.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, dtype=torch.int32, device="cuda")
    out = {}
    for op, name in enumerate(OPS):
        runs = []
        for seed in range(8):
            _build.check(fn(op, seed, cycles.data_ptr(), sink.data_ptr()), name)
            torch.cuda.synchronize()
            if seed:                       # the first launch warms the code up
                runs.append(int(cycles) / STEPS)
        out[name] = statistics.median(runs)
    print(json.dumps({"nvidia_smi": smi, "cycles_per_step": out}), flush=True)


if __name__ == "__main__":
    main()
