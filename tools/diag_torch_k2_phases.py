#!/usr/bin/env python3
"""Where kernel K2's time goes: the kernel of ``csrc/correct.cu`` cut after
each of its phases, timed on one NVIDIA GPU at the full session's shape and
at the live feed's 64 KiB window (``tools/torch_kernel_ab.py``'s K2 inputs).

    python3 tools/diag_torch_k2_phases.py [BASE_CHECKOUT]

Builds, with nvcc, variants of the repository's own kernel source, each on
the same grid of blocks:

  empty        an empty kernel: the launch;
  loaded       + the rows' gid / clk loads and the block's groups staged
               as int32 in shared memory;
  counted      + the residue buckets' counts;
  scanned      + their prefix sums;
  staged       + the scatter into bucket order: the counting sort done;
  loop         + every row's search (the verdict kept, not stored);
  full         + the stores: the kernel as shipped;
  scan_all     the staging, then every staged column scanned from shared
               memory in place of the sort and the search (the staging
               alone; the barriers stay).

With BASE_CHECKOUT (another checkout, e.g. ``git archive <commit> | tar -x
-C build/ab_base``), its ``correct.cu`` is built beside them as ``base``,
so the kernel it replaced is timed in the same process.  Times are
CUDA-event medians (``tools/torch_kernel_ab.py``'s ``cuda_ms``), three
passes over the variants; prints one JSON line per pass and the medians.
Every full variant must equal the shipped kernel's outputs.  The variants
are made by editing the source text; the script stops if the kernel's text
no longer has the places it edits.
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

PHASES = ("empty", "loaded", "counted", "scanned", "staged", "loop", "full", "scan_all")
ENTRY = 'extern "C" int slam_correct_verdicts('


def variant_source(src: str) -> str:
    """The kernel templated on the phase it ends after (1 loaded, 2
    counted, 3 scanned, 4 staged, 5 loop, 6 full, 7 full with every column
    scanned), an empty kernel, and one C entry ``k2_phase(phase, ...)``."""
    edits = [
        ("__global__ void __launch_bounds__(kBlock) correct_verdicts_kernel(",
         "template <int kPhase>\n__global__ void __launch_bounds__(kBlock) "
         "correct_verdicts_kernel("),
        ("    if (s < n_staged && tid < n_live[s]) {\n",
         "    if (kPhase != 7 && s < n_staged && tid < n_live[s]) {\n"),
        ("  __syncthreads();\n  if (warp < n_staged) {\n",
         "  __syncthreads();\n"
         "  if (kPhase == 2) {\n"
         "    if (row && s_pos[0][tid] == INT_MIN) has[i] = 1;\n"
         "    return;\n  }\n  if (kPhase != 7 && warp < n_staged) {\n"),
        ("  // Scatter into bucket order.\n",
         "  if (kPhase == 3) {\n"
         "    if (row && s_pos[0][tid] == INT_MIN) has[i] = 1;\n"
         "    return;\n  }\n  // Scatter into bucket order.\n"),
        ("  // Counting sort of each staged group's live columns",
         "  if (kPhase == 1) {\n"
         "    if (row && s_tab[0][tid].x == INT_MIN) has[i] = 1;\n"
         "    return;\n  }\n  // Counting sort of each staged group's live columns"),
        ("  if (!row) return;\n",
         "  if (kPhase == 4) {\n"
         "    if (row && (s_tab[0][tid].x == INT_MIN || s_cand[0][tid].y == INT_MIN)) has[i] = 1;\n"
         "    return;\n  }\n  if (!row) return;\n"),
        ("  if (s >= 0 && s < n_staged && s_n[s] >= 0) {\n",
         "  if (kPhase == 7 && s >= 0 && s < n_staged && s_n[s] >= 0) {\n"
         "    for (int col = 0; col < s_n[s]; ++col) {\n"
         "      const int2 w = s_tab[s][col];\n"
         "      best = score_of(r_f, w.x, col, w.y, cycle, tol, bmax, best);\n"
         "    }\n"
         "  } else if (s >= 0 && s < n_staged && s_n[s] >= 0) {\n"),
        ("  has[i] = best < kSentinel;\n",
         "  if (kPhase == 5) {\n    if (best == -1) has[i] = 1;\n    return;\n  }\n"
         "  has[i] = best < kSentinel;\n"),
        ("  correct_verdicts_kernel<<<", "  correct_verdicts_kernel<6><<<"),
        (ENTRY, 'extern "C" int k2_full('),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"diag_torch_k2_phases: the kernel source changed near {old!r}")
        src = src.replace(old, new)
    return "#include <climits>\n" + src + r'''
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int k2_phase(int phase, const void* gid, const void* clk, long long f,
                        const void* packed, int g_rows, int width, int bmax, int cycle, int tol,
                        void* has, void* k_best, void* bs_best, void* stream) {
  const unsigned blocks = static_cast<unsigned>((f + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gid);
  const int* c = static_cast<const int*>(clk);
  const float* p = static_cast<const float*>(packed);
  uint8_t* h = static_cast<uint8_t*>(has);
  int* k = static_cast<int*>(k_best);
  int* b = static_cast<int*>(bs_best);
  switch (phase) {
    case 0: empty_kernel<<<blocks, kBlock, 0, s>>>(); break;
    case 1: correct_verdicts_kernel<1><<<blocks, kBlock, 0, s>>>(g, c, f, p, g_rows, width, bmax, cycle, tol, h, k, b); break;
    case 2: correct_verdicts_kernel<2><<<blocks, kBlock, 0, s>>>(g, c, f, p, g_rows, width, bmax, cycle, tol, h, k, b); break;
    case 3: correct_verdicts_kernel<3><<<blocks, kBlock, 0, s>>>(g, c, f, p, g_rows, width, bmax, cycle, tol, h, k, b); break;
    case 4: correct_verdicts_kernel<4><<<blocks, kBlock, 0, s>>>(g, c, f, p, g_rows, width, bmax, cycle, tol, h, k, b); break;
    case 5: correct_verdicts_kernel<5><<<blocks, kBlock, 0, s>>>(g, c, f, p, g_rows, width, bmax, cycle, tol, h, k, b); break;
    case 6: correct_verdicts_kernel<6><<<blocks, kBlock, 0, s>>>(g, c, f, p, g_rows, width, bmax, cycle, tol, h, k, b); break;
    default: correct_verdicts_kernel<7><<<blocks, kBlock, 0, s>>>(g, c, f, p, g_rows, width, bmax, cycle, tol, h, k, b);
  }
  return static_cast<int>(cudaGetLastError());
}
'''


def main() -> None:
    import torch

    from slam_process_tpu_torch.ops import _build, cuda_correct
    from torch_kernel_ab import cuda_ms, k2_full_session, k2_live_window

    if not torch.cuda.is_available():
        raise SystemExit("diag_torch_k2_phases: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = REPO / "build" / "diag_torch_k2_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = [out_dir / "phases.cu"]
    srcs[0].write_text(variant_source((_build.CSRC / "correct.cu").read_text()))
    phases = list(PHASES)
    if len(sys.argv) > 1:
        base = (Path(sys.argv[1]) / "slam_process_tpu_torch" / "csrc" / "correct.cu").read_text()
        if base.count(ENTRY) != 1:
            raise SystemExit("diag_torch_k2_phases: the base kernel has no slam_correct_verdicts")
        srcs.append(out_dir / "base.cu")
        srcs[1].write_text(base.replace(ENTRY, 'extern "C" int k2_base('))
        phases.append("base")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / "k2.so"),
                    *map(str, srcs)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out_dir / "k2.so"))
    argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn = lib.k2_phase
    fn.argtypes = [ctypes.c_int] + argtypes
    fn.restype = ctypes.c_int
    base_fn = getattr(lib, "k2_base", None) if len(phases) > len(PHASES) else None
    if base_fn is not None:
        base_fn.argtypes = argtypes
        base_fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    inputs = {"full_session": k2_full_session(dev)[:2], "live_64KiB": k2_live_window(dev)}
    summary = {}
    for name, ((gid, clk, packed), kw) in inputs.items():
        f = gid.numel()
        outs = (torch.empty(f, dtype=torch.bool, device=dev),
                torch.empty(f, dtype=torch.int32, device=dev),
                torch.empty(f, dtype=torch.int32, device=dev))
        args = (gid.data_ptr(), clk.data_ptr(), f, packed.data_ptr(), packed.shape[0],
                packed.shape[1], kw["bmax"], kw["cycle"], kw["tol"],
                *(t.data_ptr() for t in outs), _build.stream_of(gid))

        def call(phase, args=args):
            err = base_fn(*args) if phase == "base" else fn(PHASES.index(phase), *args)
            _build.check(err, f"K2 phase {phase}")

        want = cuda_correct.correct_verdicts_cuda(gid, clk, packed, **kw)
        for phase in ("full", "scan_all") + (("base",) if base_fn is not None else ()):
            call(phase)
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise SystemExit(f"diag_torch_k2_phases: {phase} differs from the kernel "
                                 f"at {name}")
        passes = []
        for _ in range(3):
            passes.append({ph: cuda_ms(lambda ph=ph: call(ph)) for ph in phases})
            print(json.dumps({"input": name, "ms": passes[-1]}), flush=True)
        med = {ph: statistics.median(p[ph] for p in passes) for ph in phases}
        summary[name] = {"rows": f, "median_ms": med,
                         "added_ms": {ph: med[ph] - med[PHASES[i - 1]] if i else med[ph]
                                      for i, ph in enumerate(PHASES[:7])}}
    print(json.dumps({"nvidia_smi": smi, **summary}), flush=True)


if __name__ == "__main__":
    main()
