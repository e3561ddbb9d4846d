#!/usr/bin/env python3
"""Where kernel K4's time goes: the kernel of ``csrc/sweep_sums.cu`` cut by
phase, timed on one NVIDIA GPU at the full session's filtered rows (S =
58), the live feed's and the dataset replay's second full window with paths
(S = 9 and 65) and an unsorted stream over 65 sweeps
(``tools/torch_kernel_ab.py``'s K4 inputs).

    python3 tools/diag_torch_k4_phases.py [BASE_CHECKOUT [--base-only]]

Builds, with nvcc, variants of the repository's own kernel source.  For
the kernel whose blocks own the output cells (one cooperative launch):

  empty        an empty cooperative launch on the same grid;
  summary      + the epoch ticket and the tile summaries (each tile's p
               range, published);
  owners       + every owner's reads of the summaries (waiting for their
               tag), its zeroing and its stores, but not the rows;
  full         + the rows' loads and shared-memory sums: as shipped;
  plain_launch the full kernel launched with <<<>>> instead of
               cudaLaunchCooperativeKernel (the same grid).

For the first form (one thread per row, global atomics into a zeroed
scratch grid, a conversion kernel):

  empty        an empty kernel on the scatter's grid;
  scatter      the scatter kernel alone;
  convert      the conversion kernel alone;
  full         both (the entry as shipped then);

with ``fills``, the two ``torch.zeros`` of its scratch grid, timed beside.
Also ``wrapper``: this repository's ``sweep_sums_cuda``.  With
BASE_CHECKOUT (another checkout, e.g. ``git archive <commit> | tar -x -C
build/ab_base``), its ``sweep_sums.cu`` is cut the same way, as
``base_<variant>``, in the same process; ``--base-only`` times only those
(and the fills).  Times are CUDA-event medians
(``tools/torch_kernel_ab.py``'s ``cuda_ms``), three passes over the
variants; prints one JSON line per pass and the medians.  Every full variant
must equal the plain version.  The variants are made by editing the source
text; the script stops if the kernel's text no longer has the places it
edits.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

ENTRY = 'extern "C" int slam_sweep_sums('
ARGS = ("const void* p, const void* bs, const void* val, long long f, int n_sweeps, "
        "int n_beams, void* scratch, void* sums, void* counts, void* out_sums, "
        "void* out_counts, void* stream")

# The first form: a scatter into a zeroed int64 / uint32 grid, a conversion.
SCATTER = ("one thread per row, by integer atomics", ("empty", "scatter", "convert", "full"), [
    (ENTRY, 'extern "C" int TAG_full('),
], r'''
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int TAG_phase(int phase, ARGS) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long width = static_cast<long long>(n_sweeps) * n_beams;
  const long long cells = width * n_beams;
  const unsigned rows_grid = static_cast<unsigned>((f + kBlock - 1) / kBlock);
  const unsigned cells_grid = static_cast<unsigned>((cells + kBlock - 1) / kBlock);
  switch (phase) {
    case 0: empty_kernel<<<rows_grid, kBlock, 0, s>>>(); break;
    case 1:
      sweep_sums_scatter<<<rows_grid, kBlock, 0, s>>>(
          static_cast<const int*>(p), static_cast<const int*>(bs), static_cast<const int*>(val),
          f, width, n_beams, static_cast<unsigned long long*>(sums),
          static_cast<unsigned int*>(counts));
      break;
    case 2:
      sweep_sums_to_f32<<<cells_grid, kBlock, 0, s>>>(
          static_cast<const unsigned long long*>(sums), static_cast<const unsigned int*>(counts),
          cells, static_cast<float*>(out_sums), static_cast<float*>(out_counts));
      break;
    default:
      return TAG_full(p, bs, val, f, n_sweeps, n_beams, sums, counts, out_sums, out_counts,
                      stream);
  }
  return static_cast<int>(cudaGetLastError());
}
''')

# Blocks that own the output cells, in one cooperative launch.
OWNERS = ("cooperative launch whose blocks own the output cells",
          ("empty", "summary", "owners", "full", "plain_launch"), [
    ("__global__ void __launch_bounds__(kThreads, 2) sweep_sums_kernel(",
     "template <int kPhase>\n__global__ void __launch_bounds__(kThreads, 2) sweep_sums_kernel("),
    ("  const unsigned tag = s_tag;\n",
     "  if (kPhase == 1) return;\n  const unsigned tag = s_tag;\n"),
    ("      const bool eager = n_hit <= kEager;\n",
     "      const bool eager = n_hit <= kEager;\n"
     "      if (kPhase == 2) {\n        __syncthreads();\n        continue;\n      }\n"),
    ("sweep_sums_kernel, kThreads, 0)", "sweep_sums_kernel<3>, kThreads, 0)"),
    ("reinterpret_cast<const void*>(sweep_sums_kernel)",
     "reinterpret_cast<const void*>(sweep_sums_kernel<3>)"),
    (ENTRY, 'extern "C" int TAG_full_unused('),
], r'''
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int TAG_phase(int phase, ARGS) {
  int device = 0;
  cudaGetDevice(&device);
  const int cap = max_grid(device);
  long long width = static_cast<long long>(n_sweeps) * n_beams;
  long long n_cells = width * n_beams;
  int n_rows = static_cast<int>(f);
  int n_tiles = (n_rows + kTile - 1) / kTile;
  const long long n_units = (n_cells + kCells - 1) / kCells;
  const long long want = n_units > n_tiles ? n_units : n_tiles;
  const int grid = static_cast<int>(want < cap ? want : cap);
  unsigned long long* ticket = static_cast<unsigned long long*>(scratch);
  unsigned long long* summary = ticket + 1;
  const int* pp = static_cast<const int*>(p);
  const int* bp = static_cast<const int*>(bs);
  const int* vp = static_cast<const int*>(val);
  float* sp = static_cast<float*>(out_sums);
  float* cp = static_cast<float*>(out_counts);
  void* args[] = {&pp, &bp, &vp, &n_rows, &width, &n_beams, &n_cells, &n_tiles, &ticket,
                  &summary, &sp, &cp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  switch (phase) {
    case 0:
      err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(empty_kernel), dim3(grid),
                                        dim3(kThreads), nullptr, 0, s);
      break;
    case 1:
      err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sweep_sums_kernel<1>),
                                        dim3(grid), dim3(kThreads), args, 0, s);
      break;
    case 2:
      err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sweep_sums_kernel<2>),
                                        dim3(grid), dim3(kThreads), args, 0, s);
      break;
    case 3:
      err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sweep_sums_kernel<3>),
                                        dim3(grid), dim3(kThreads), args, 0, s);
      break;
    default:
      sweep_sums_kernel<3><<<grid, kThreads, 0, s>>>(pp, bp, vp, n_rows, width, n_beams, n_cells,
                                                     n_tiles, ticket, summary, sp, cp);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
''')


def edited(src: str, tag: str):
    """(``src`` cut by the recipe its text matches, with the C entry
    ``<tag>_phase(phase, ...)``, the recipe's variant names)."""
    for marker, phases, edits, tail in (SCATTER, OWNERS):
        if marker in src:
            break
    else:
        raise SystemExit("diag_torch_k4_phases: not a kernel whose phases this script knows")
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"diag_torch_k4_phases: the kernel source changed near {old!r}")
        src = src.replace(old, new.replace("TAG", tag))
    return src + tail.replace("TAG", tag).replace("ARGS", ARGS), phases


def main() -> None:
    import torch

    from slam_process_tpu_torch.ops import _build, cuda_sweep_sums, scene
    from slam_process_tpu_torch.utils.synthetic import write_angle_table
    from torch_kernel_ab import cuda_ms, k1_k4_inputs

    if not torch.cuda.is_available():
        raise SystemExit("diag_torch_k4_phases: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = REPO / "build" / "diag_torch_k4_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    base_only = "--base-only" in sys.argv
    argv = [a for a in sys.argv[1:] if a != "--base-only"]
    units = ({} if base_only else
             {"this": edited((_build.CSRC / "sweep_sums.cu").read_text(), "this")})
    if argv:
        base = Path(argv[0]) / "slam_process_tpu_torch" / "csrc" / "sweep_sums.cu"
        units["base"] = edited(base.read_text(), "base")
    for tag, (src, _) in units.items():
        (out_dir / f"{tag}.cu").write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / "k4.so"),
                    *(str(out_dir / f"{tag}.cu") for tag in units)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out_dir / "k4.so"))
    fns = {}
    for tag in units:
        fns[tag] = getattr(lib, f"{tag}_phase")
        fns[tag].argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
        fns[tag].restype = ctypes.c_int

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        inputs = k1_k4_inputs(dev, write_angle_table(Path(tmp) / "beam_angle.xlsx"))[1]
    summary = {}
    for name, (p, bs, val, s_n, nb) in inputs.items():
        f = p.numel()
        shape = (s_n, nb, nb)
        sums_i = torch.zeros(shape, dtype=torch.int64, device=dev)
        counts_i = torch.zeros(shape, dtype=torch.int32, device=dev)
        outs = (torch.empty(shape, dtype=torch.float32, device=dev),
                torch.empty(shape, dtype=torch.float32, device=dev))
        stream = _build.stream_of(p)
        scratch = cuda_sweep_sums.scratch_for(dev, stream, f)

        def call(tag, phase, p=p, bs=bs, val=val, f=f, s_n=s_n, nb=nb, sums_i=sums_i,
                 counts_i=counts_i, outs=outs, scratch=scratch):
            err = fns[tag](units[tag][1].index(phase), p.data_ptr(), bs.data_ptr(),
                           val.data_ptr(), f, s_n, nb, scratch.data_ptr(), sums_i.data_ptr(),
                           counts_i.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), stream)
            _build.check(err, f"K4 {tag} {phase}")

        want = scene.sweep_sums_plain(p, bs, val, s_n, nb)
        for tag in units:
            sums_i.zero_()
            counts_i.zero_()
            call(tag, "full")
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise SystemExit(f"diag_torch_k4_phases: {tag} differs from the plain version "
                                 f"at {name}")

        def fills(shape=shape):
            torch.zeros(shape, dtype=torch.int64, device=dev)
            torch.zeros(shape, dtype=torch.int32, device=dev)

        passes = []
        for _ in range(3):
            ms = {f"{tag}_{ph}": cuda_ms(lambda tag=tag, ph=ph: call(tag, ph))
                  for tag, (_, phases) in units.items() for ph in phases}
            ms["fills"] = cuda_ms(fills)
            if not base_only:
                ms["wrapper"] = cuda_ms(
                    lambda: cuda_sweep_sums.sweep_sums_cuda(p, bs, val, s_n, nb))
            passes.append(ms)
            print(json.dumps({"input": name, "rows": f, "sweeps": s_n, "ms": ms}), flush=True)
        summary[name] = {"rows": f, "sweeps": s_n,
                         "median_ms": {k: statistics.median(ps[k] for ps in passes)
                                       for k in passes[0]}}
    print(json.dumps({"nvidia_smi": smi, **summary}), flush=True)


if __name__ == "__main__":
    main()
