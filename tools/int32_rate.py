#!/usr/bin/env python3
"""The 32-bit integer issue rate of one NVIDIA GPU, measured: the peak behind
the "operations" term of ``chip_smoke.py``'s integer bounds.

    python3 tools/int32_rate.py

Builds with nvcc (``ops/_build.py``'s flags) one kernel per instruction mix,
each thread running eight independent dependency chains in registers, four
256-thread blocks per SM, and times each with CUDA events (the median of 5
launches of a few ms, after one warm-up launch):

  alu    x = x + y; y = y ^ x         adds and xors (nvcc emits LOP3, and
                                     IMAD or IADD3 for the adds);
  imad   x = x * x + y; y = y * y + x  IMAD, integer multiply-add;
  mixed  the alu pair on even chains, the imad pair on odd ones;
  k2     ``csrc/correct.cu``'s ``score_of`` on one (row, baseline)
         candidate and a step of the baseline's residue, counted as the 8
         operations ``chip_smoke.k2_ops`` gives a candidate.

alu, imad and mixed count one operation per source statement above.
Prints the card (nvidia-smi name, power limit, max SM clock), then one JSON
line: per mix the operations per second, per SM per clock at the max SM
clock, and the static SASS opcode counts of its kernel (cuobjdump), which
show what each mix ran as.  Needs a GPU.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

MIXES = ("alu", "imad", "mixed", "k2")
OPS_PER_STEP = {"alu": 16, "imad": 16, "mixed": 16, "k2": 64}   # per thread, 8 chains
ITERS = 1 << 16
BLOCKS_PER_SM = 4

SOURCE = r'''
#include "correct.cu"

namespace {

constexpr int kChains = 8;

template <int kMix>
__global__ void __launch_bounds__(256) mix_kernel(int iters, int seed, int* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned x[kChains], y[kChains];   // unsigned: wrapping is defined
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    x[j] = t * 7u + j * 13u + seed;
    y[j] = (t ^ (j * 977u)) + seed;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (kMix == 0 || (kMix == 2 && j % 2 == 0)) {
        x[j] = x[j] + y[j];
        y[j] = y[j] ^ x[j];
      } else if (kMix == 1 || kMix == 2) {
        x[j] = x[j] * x[j] + y[j];
        y[j] = y[j] * y[j] + x[j];
      } else {
        // Row j's residue fixed, the baseline's walking; the best score
        // carried as in the kernel.
        y[j] += 977;
        x[j] = score_of(30000 + 1000 * j, static_cast<int>(y[j] & 0xFFFFu), j,
                        static_cast<int>(y[j] & 63u), 61000, 500, 256, static_cast<int>(x[j]));
      }
    }
  }
  unsigned acc = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) acc ^= x[j] ^ y[j];
  out[t] = static_cast<int>(acc);
}

}  // namespace

extern "C" int int32_mix(int mix, int blocks, int iters, int seed, void* out) {
  int* o = static_cast<int*>(out);
  switch (mix) {
    case 0: mix_kernel<0><<<blocks, 256>>>(iters, seed, o); break;
    case 1: mix_kernel<1><<<blocks, 256>>>(iters, seed, o); break;
    case 2: mix_kernel<2><<<blocks, 256>>>(iters, seed, o); break;
    default: mix_kernel<3><<<blocks, 256>>>(iters, seed, o);
  }
  return static_cast<int>(cudaGetLastError());
}
'''


def sass_opcodes(lib: Path) -> dict:
    """{mix: {opcode: static count}} of each mix kernel, from cuobjdump."""
    out = subprocess.run([str(Path(_nvcc_dir()) / "cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=120)
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        m = re.match(r"\S*mix_kernelILi(\d)E", part)
        if not m:
            continue
        ops = collections.Counter(
            op.split(".")[0] for op in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part))
        counts[MIXES[int(m.group(1))]] = dict(ops.most_common(12))
    return counts


def _nvcc_dir() -> str:
    from slam_process_tpu_torch.ops import _build

    return str(Path(_build._nvcc()).parent)


def main() -> None:
    import torch

    from slam_process_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("int32_rate: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    max_sm_hz = float(smi.split(",")[-1]) * 1e6
    out_dir = REPO / "build" / "int32_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mix.cu").write_text(SOURCE)
    lib_path = out_dir / "int32_rate.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                    "-o", str(lib_path), str(out_dir / "mix.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).int32_mix
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    res = {"sms": sms, "max_sm_clock_hz": max_sm_hz, "threads": blocks * 256,
           "iters": ITERS}
    for k, mix in enumerate(MIXES):
        _build.check(fn(k, blocks, ITERS, 1, out.data_ptr()), f"int32 mix {mix}")
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _build.check(fn(k, blocks, ITERS, 1, out.data_ptr()), f"int32 mix {mix}")
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        sec = statistics.median(times)
        ops = blocks * 256 * ITERS * OPS_PER_STEP[mix]
        res[mix] = {"ms": sec * 1e3, "ops_per_s": ops / sec,
                    "ops_per_sm_per_clock": ops / sec / sms / max_sm_hz}
    try:
        for mix, ops in sass_opcodes(lib_path).items():
            res[mix]["sass_opcodes"] = ops
    except (OSError, subprocess.SubprocessError) as exc:
        res["sass_opcodes_error"] = repr(exc)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
