#!/usr/bin/env python3
"""Where kernel K3's time goes: the kernel of ``csrc/raster.cu`` cut after
each of its phases, timed on one NVIDIA GPU at the full session's 64 x 64
tile (S = 1) and at 58 seeded tiles (``tools/torch_kernel_ab.py``'s K3
inputs), sigma 1, log norm.

    python3 tools/diag_torch_k3_phases.py

Builds, with nvcc, variants of the repository's own kernel source, each on
the same grid of 8-block clusters:

  empty        an empty kernel with the same cluster shape: the launch;
  staged       + the band's values, mask and taps staged in shared memory;
  blurred      + the blur and its stores;
  ranged       + the block min / max and the two cluster barriers around
               the exchange of the eight pairs;
  full         + the norm, the colormap and their stores: the kernel as
               shipped.

Times are CUDA-event medians (``tools/torch_kernel_ab.py``'s ``cuda_ms``),
three passes over the variants; prints one JSON line per pass and the
medians.  The full variant must equal the shipped kernel's outputs.  The
variants are made by editing the source text; the script stops if the
kernel's text no longer has the places it edits.
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

PHASES = ("empty", "staged", "blurred", "ranged", "full")


def variant_source(src: str) -> str:
    """The kernel templated also on the phase it ends after (1 staged, 2
    blurred, 3 ranged, 4 full: the default, which the shipped launcher
    takes), an empty cluster kernel, and one C entry ``k3_phase(phase,
    ...)`` for 7 x 7 taps (sigma 1)."""
    edits = [
        ("template <int KW>\n__global__ void __cluster_dims__(kRanks, 1, 1) "
         "__launch_bounds__(kBlock)\n    raster_kernel(",
         "template <int KW, int kPhase = 4>\n__global__ void __cluster_dims__(kRanks, 1, 1) "
         "__launch_bounds__(kBlock)\n    raster_kernel("),
        ("  for (int i = threadIdx.x; i < kh * kw; i += kBlock) s_taps[i] = taps[i];\n"
         "  __syncthreads();\n",
         "  for (int i = threadIdx.x; i < kh * kw; i += kBlock) s_taps[i] = taps[i];\n"
         "  __syncthreads();\n"
         "  if (kPhase == 1) {\n"
         "    if (pad_v[threadIdx.x] == -1.0f && s_taps[0] == -1.0f) blurred[tile] = 0.0f;\n"
         "    return;\n  }\n"),
        ("  // The block's min / max, then the tile's through distributed shared memory.\n",
         "  if (kPhase == 2) return;\n"
         "  // The block's min / max, then the tile's through distributed shared memory.\n"),
        ("  const float log_lo = logf(1e-6f);\n",
         "  if (kPhase == 3) {\n    if (mn == -1.0f && mx == -1.0f) norm_t[tile] = 0.0f;\n"
         "    return;\n  }\n  const float log_lo = logf(1e-6f);\n"),
        ('extern "C" int slam_raster(', 'extern "C" int k3_full('),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"diag_torch_k3_phases: the kernel source changed near {old!r}")
        src = src.replace(old, new)
    return src + r'''
namespace {
__global__ void __cluster_dims__(kRanks, 1, 1) empty_kernel() {}
}  // namespace

extern "C" int k3_phase(int phase, const void* mats, int s, int h, int w, const void* lut,
                        int n_lut, const void* taps, int kh, int kw, int use_log, void* rgba,
                        void* norm_t, void* blurred, void* stream) {
  const size_t smem = static_cast<size_t>(smem_bytes(h, w, n_lut, kh, kw));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mats);
  const float* l = static_cast<const float*>(lut);
  const float* t = static_cast<const float*>(taps);
  float* o = static_cast<float*>(rgba);
  float* nt = static_cast<float*>(norm_t);
  float* b = static_cast<float*>(blurred);
  switch (phase) {
    case 0: empty_kernel<<<s * kRanks, kBlock, 0, st>>>(); break;
    case 1: raster_kernel<7, 1><<<s * kRanks, kBlock, smem, st>>>(m, h, w, l, n_lut, t, kh, kw, use_log, 0, 0.0f, 0, 0.0f, o, nt, b); break;
    case 2: raster_kernel<7, 2><<<s * kRanks, kBlock, smem, st>>>(m, h, w, l, n_lut, t, kh, kw, use_log, 0, 0.0f, 0, 0.0f, o, nt, b); break;
    case 3: raster_kernel<7, 3><<<s * kRanks, kBlock, smem, st>>>(m, h, w, l, n_lut, t, kh, kw, use_log, 0, 0.0f, 0, 0.0f, o, nt, b); break;
    default: raster_kernel<7, 4><<<s * kRanks, kBlock, smem, st>>>(m, h, w, l, n_lut, t, kh, kw, use_log, 0, 0.0f, 0, 0.0f, o, nt, b);
  }
  return static_cast<int>(cudaGetLastError());
}
'''


def main() -> None:
    import torch

    from slam_process_tpu_torch.ops import _build, cuda_raster
    from torch_kernel_ab import cuda_ms, k2_full_session, k3_tiles

    if not torch.cuda.is_available():
        raise SystemExit("diag_torch_k3_phases: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = REPO / "build" / "diag_torch_k3_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "phases.cu").write_text(variant_source((_build.CSRC / "raster.cu").read_text()))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / "k3.so"),
                    str(out_dir / "phases.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out_dir / "k3.so"))
    fn = lib.k3_phase
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    tile, tiles, lut, taps = k3_tiles(dev, k2_full_session(dev)[2])
    summary = {}
    for name, mats in (("S1", tile), ("S58", tiles)):
        s, h, w = mats.shape
        outs = (torch.empty((s, h, w, 4), device=dev), torch.empty((s, h, w), device=dev),
                torch.empty((s, h, w), device=dev))
        args = (mats.data_ptr(), s, h, w, lut.data_ptr(), lut.shape[0], taps.data_ptr(),
                taps.shape[0], taps.shape[1], 1, *(t.data_ptr() for t in outs),
                _build.stream_of(mats))

        def call(phase, args=args):
            _build.check(fn(PHASES.index(phase), *args), f"K3 phase {phase}")

        call("full")
        want = cuda_raster.raster_tiles_cuda(mats, lut, taps, True)
        torch.cuda.synchronize()
        if not all(torch.equal(o.nan_to_num(-7.0), x.nan_to_num(-7.0))
                   for o, x in zip(outs, want)):
            raise SystemExit(f"diag_torch_k3_phases: the full variant differs at {name}")
        passes = []
        for _ in range(3):
            passes.append({ph: cuda_ms(lambda ph=ph: call(ph)) for ph in PHASES})
            print(json.dumps({"input": name, "ms": passes[-1]}), flush=True)
        med = {ph: statistics.median(p[ph] for p in passes) for ph in PHASES}
        summary[name] = {"median_ms": med,
                         "added_ms": {ph: med[ph] - med[PHASES[i - 1]] if i else med[ph]
                                      for i, ph in enumerate(PHASES)}}
    print(json.dumps({"nvidia_smi": smi, **summary}), flush=True)


if __name__ == "__main__":
    main()
