#!/usr/bin/env python3
"""Where kernel K5's time goes: the kernel of ``csrc/compact.cu`` cut after
each of its phases, timed on one NVIDIA GPU at the open-group carry of the
dataset replay's second 1 MiB window (``chip_smoke.py``'s K5 input).

    python3 tools/diag_torch_k5_phases.py

Builds, with nvcc, variants of the repository's own kernel source, each one
ending after a phase, on the same grid of blocks:

  empty        an empty kernel: the launch;
  ticket       + the atomic ticket that hands out the tiles;
  count        + the mask load, the block's count and its status word
               (each tile publishes its own count as inclusive: no look-back);
  look_back    + the decoupled look-back;
  scatter      + the masked rows' payload and stores (no tail blocks);
  full         + the tail blocks that zero the rest of the carry buffer.

Times are CUDA-event medians (``tools/torch_kernel_ab.py``'s ``cuda_ms``),
three passes over the variants; prints one JSON line per pass and the
medians.  The variants are made by editing the source text; the script
stops if the kernel's text no longer has the places it edits.
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
sys.path.insert(0, str(REPO / "tools"))

PHASES = ("empty", "ticket", "count", "look_back", "scatter", "full")
GCAP = 8192


def variant_source(src: str) -> str:
    """The kernel templated on the phase it ends after (1 ticket, 2 count,
    3 look-back, 4 scatter and tail), plus an empty kernel, and one C entry
    ``k5_phase(phase, ...)``."""
    edits = [
        ("__global__ void __launch_bounds__(kBlock) compact_kernel(",
         "template <int kPhase>\n__global__ void __launch_bounds__(kBlock) compact_kernel("),
        ("  const unsigned tag = s_tag;\n  int* outs[kMaxDests];\n",
         "  const unsigned tag = s_tag;\n  if (kPhase == 1) return;\n  int* outs[kMaxDests];\n"),
        ("      if (tile > 0) {\n        if (lane == 0) store_status(status + tile, tag, false, count);",
         "      if (kPhase == 2) {\n      } else if (tile > 0) {\n"
         "        if (lane == 0) store_status(status + tile, tag, false, count);"),
        ("    __syncthreads();\n    if (m) {",
         "    __syncthreads();\n    if (kPhase <= 3) return;\n    if (m) {"),
        ("  compact_kernel<<<", "  compact_kernel<4><<<"),
        ('extern "C" int slam_compact_rows(', 'extern "C" int k5_full('),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"diag_torch_k5_phases: the kernel source changed near {old!r}")
        src = src.replace(old, new)
    return src + TAIL


TAIL = r'''
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int k5_phase(int phase, const void* rows, const void* mask, long long f, int width,
                        void* scratch, void* out, long long capacity, int n_tail, void* total,
                        void* stream) {
  Dests dests;
  dests.n = 1;
  dests.d[0] = Dest{static_cast<int*>(out), nullptr, capacity, 0, n_tail > 0};
  dests.d[1] = Dest{nullptr, nullptr, 0, 0, 0};
  const int n_tiles = static_cast<int>((f + kBlock - 1) / kBlock);
  const int n_grid = n_tiles + n_tail;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  const int* r = static_cast<const int*>(rows);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* t = static_cast<int*>(total);
  switch (phase) {
    case 0: empty_kernel<<<n_grid, kBlock, 0, s>>>(); break;
    case 1: compact_kernel<1><<<n_grid, kBlock, 0, s>>>(r, m, f, width, n_tiles, n_grid, dests, words, words + 1, t); break;
    case 2: compact_kernel<2><<<n_grid, kBlock, 0, s>>>(r, m, f, width, n_tiles, n_grid, dests, words, words + 1, t); break;
    case 3: compact_kernel<3><<<n_grid, kBlock, 0, s>>>(r, m, f, width, n_tiles, n_grid, dests, words, words + 1, t); break;
    default: compact_kernel<4><<<n_grid, kBlock, 0, s>>>(r, m, f, width, n_tiles, n_grid, dests, words, words + 1, t);
  }
  return static_cast<int>(cudaGetLastError());
}
'''


def main() -> None:
    import torch

    from slam_process_tpu_torch.ops import _build, cuda_compact
    from torch_kernel_ab import cuda_ms, k5_window

    if not torch.cuda.is_available():
        raise SystemExit("diag_torch_k5_phases: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = REPO / "build" / "diag_torch_k5_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "phases.cu").write_text(variant_source((_build.CSRC / "compact.cu").read_text()))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / "phases.so"),
                    str(out_dir / "phases.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out_dir / "phases.so"))
    fn = lib.k5_phase
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    w = k5_window(dev)[0]
    rows, mask = w.combined, w.open_mask
    f, width = rows.shape
    n_tail = min(cuda_compact._MAX_TAIL, -(-GCAP * width // cuda_compact._TAIL_ELEMS))
    scratch = torch.zeros(1 + 4096, dtype=torch.int64, device=dev)
    out = torch.empty((GCAP, width), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    stream = _build.stream_of(rows)

    def call(phase):
        tail = n_tail if phase == 5 else 0
        err = fn(min(phase, 4), rows.data_ptr(), mask.data_ptr(), f, width, scratch.data_ptr(),
                 out.data_ptr(), GCAP, tail, total.data_ptr(), stream)
        _build.check(err, f"K5 phase {PHASES[phase]}")

    call(5)
    want, n = cuda_compact.compact_rows_cuda(rows, mask, GCAP)
    torch.cuda.synchronize()
    if not torch.equal(out, want) or int(total) != int(n):
        raise SystemExit("diag_torch_k5_phases: the full variant differs from the kernel")
    passes = []
    for _ in range(3):
        passes.append({name: cuda_ms(lambda p=p: call(p)) for p, name in enumerate(PHASES)})
        print(json.dumps({"ms": passes[-1]}), flush=True)
    med = {name: statistics.median(p[name] for p in passes) for name in PHASES}
    print(json.dumps({"nvidia_smi": smi, "rows": f, "masked": int(n), "tail_blocks": n_tail,
                      "median_ms": med,
                      "added_ms": {name: med[name] - med[PHASES[i - 1]] if i else med[name]
                                   for i, name in enumerate(PHASES)}}), flush=True)


if __name__ == "__main__":
    main()
