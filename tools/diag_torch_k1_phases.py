#!/usr/bin/env python3
"""Where kernel K1's time goes: the kernel of ``csrc/decode.cu`` cut after
each of its phases, timed on one NVIDIA GPU at the full session's padded
bytes and at the second full window of the straddle (16 KiB), the live feed
(64 KiB) and the dataset replay (1 MiB) (``tools/torch_kernel_ab.py``'s K1
inputs), and through the stream-axis entry at the 19 streams' first 1 MiB
round ([19, 1,048,576] with their limits) and the batch's largest bucket
group (``run_dataset``'s 19 dataset sessions at 786,432 bytes):
``chip_smoke.k1s_calls``.

    python3 tools/diag_torch_k1_phases.py [BASE_CHECKOUT [--base-only]] [--streams-only]

Builds, with nvcc, variants of the repository's own kernel source, each on
the same grid of blocks:

  empty        an empty kernel: the launch;
  staged       + the block's bytes staged in shared memory;
  tested       + every row's tests (nothing stored);
  stored       + the rows, valid and the count's block sums stored, but
               not the atomic that makes the call's count;
  full         + that atomic: the kernel as shipped;

and, for this repository's kernel, ``rows<R>``: the full kernel with R =
128, 256, 512 or 1,024 rows per block in place of its own.  Beside them:
``fills``, the three ``torch.zeros`` that a kernel needing zeroed outputs
(rows, valid, count) costs its caller, and ``wrapper``, this repository's
``decode_rows_cuda`` (what a caller pays).  With BASE_CHECKOUT (another
checkout, e.g. ``git archive <commit> | tar -x -C build/ab_base``), its
``decode.cu`` is cut the same way, as ``base_<phase>``, in the same process;
``--base-only`` times only those (and the fills).
The cuts follow the kernel's text: a kernel with one thread per byte
position (the first form) or one thread per output row (at the
stream-axis entry each block is cut alike, so ``staged`` and ``tested``
leave out a block past its stream's limit where the kernel skips one).  The
first form has no stream-axis entry.  ``--streams-only`` times only the
stream-axis inputs.  Times are
CUDA-event medians (``tools/torch_kernel_ab.py``'s ``cuda_ms``), three
passes over the variants; prints one JSON line per pass and the medians.
Every full variant must equal the plain version.  The variants are made by
editing the source text; the script stops if the kernel's text no longer
has the places it edits.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

PHASES = ("empty", "staged", "tested", "stored", "full")
ENTRY = 'extern "C" int slam_decode_rows('

# The first form: one thread per byte, zeroed outputs, an atomic per block.
PER_BYTE = ("one thread per byte position", [
    ("__global__ void decode_rows_kernel(",
     "template <int kPhase>\n__global__ void decode_rows_kernel("),
    ("  __syncthreads();\n\n  const long long p = base + threadIdx.x;\n",
     "  __syncthreads();\n  if (kPhase == 1) {\n"
     "    if (tile[threadIdx.x] == flag_true + 256) *count = -1;\n    return;\n  }\n\n"
     "  const long long p = base + threadIdx.x;\n"),
    ("    if (ok) {\n",
     "    if (kPhase == 2) {\n      if (ok && flag_true > 255) *count = -1;\n"
     "    } else if (ok) {\n"),
    ("  const int block_count = __syncthreads_count(ok);\n",
     "  if (kPhase == 2) return;\n  const int block_count = __syncthreads_count(ok);\n"
     "  if (kPhase == 3) {\n    if (block_count < 0) *count = -1;\n    return;\n  }\n"),
    ("  decode_rows_kernel<<<", "  decode_rows_kernel<4><<<"),
    (ENTRY, 'extern "C" int TAG_full_unused('),
], r'''
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int k1_phase(int phase, const void* b, long long n, long long limit, int ft, int ff,
                        void* rows, void* valid, void* count, void* ticket, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* bb = static_cast<const uint8_t*>(b);
  int* r = static_cast<int*>(rows);
  uint8_t* v = static_cast<uint8_t*>(valid);
  int* c = static_cast<int*>(count);
  limit = limit < n ? limit : n;
  switch (phase) {
    case 0: empty_kernel<<<blocks, kBlock, 0, s>>>(); break;
    case 1: decode_rows_kernel<1><<<blocks, kBlock, 0, s>>>(bb, n, limit, ft, ff, r, v, c); break;
    case 2: decode_rows_kernel<2><<<blocks, kBlock, 0, s>>>(bb, n, limit, ft, ff, r, v, c); break;
    case 3: decode_rows_kernel<3><<<blocks, kBlock, 0, s>>>(bb, n, limit, ft, ff, r, v, c); break;
    default: decode_rows_kernel<4><<<blocks, kBlock, 0, s>>>(bb, n, limit, ft, ff, r, v, c);
  }
  return static_cast<int>(cudaGetLastError());
}
''')

# One thread per output row, every row written, a ticket.
PER_ROW = ("one thread per output row", [
    ("__global__ void __launch_bounds__(kRows) decode_rows_kernel(",
     "template <int kPhase>\n__global__ void __launch_bounds__(kRows) decode_rows_kernel("),
    ("    s_vec[i] = v;\n  }\n  __syncthreads();\n",
     "    s_vec[i] = v;\n  }\n  __syncthreads();\n  if (kPhase == 1) {\n"
     "    if (reinterpret_cast<const unsigned*>(s_vec)[tid] == "
     "static_cast<unsigned>(flag_true) + 256u) *count = -1;\n    return;\n  }\n"),
    ("#pragma unroll\n  for (int c = 0; c < 5; ++c) s_rows[5 * tid + c]",
     "  if (kPhase == 2) {\n"
     "    if (found > 0 && f[0] + f[1] + f[2] + f[3] + f[4] == 0xFFFFFFFFu) *count = -1;\n"
     "    return;\n  }\n#pragma unroll\n  for (int c = 0; c < 5; ++c) s_rows[5 * tid + c]"),
    ("    old = atomicAdd(ticket, (1ull << 32) + block_count);",
     "    if (kPhase == 4) old = atomicAdd(ticket, (1ull << 32) + block_count);"),
    ("  decode_rows_kernel<<<", "  decode_rows_kernel<4><<<"),
    (ENTRY, 'extern "C" int TAG_full_unused('),
], r'''
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int k1_phase(int phase, const void* b, long long n, long long limit, int ft, int ff,
                        void* rows, void* valid, void* count, void* ticket, void* stream) {
  const long long n_rows = (n + kFrame - 1) / kFrame;
  const unsigned blocks = static_cast<unsigned>(n_rows > 0 ? (n_rows + kRows - 1) / kRows : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* bb = static_cast<const uint8_t*>(b);
  int* r = static_cast<int*>(rows);
  uint8_t* v = static_cast<uint8_t*>(valid);
  int* c = static_cast<int*>(count);
  unsigned long long* t = static_cast<unsigned long long*>(ticket);
  limit = limit < n ? limit : n;
  switch (phase) {
    case 0: empty_kernel<<<blocks, kRows, 0, s>>>(); break;
    case 1: decode_rows_kernel<1><<<blocks, kRows, 0, s>>>(bb, n, limit, LIMITSft, ff, n_rows, r, v, c, t); break;
    case 2: decode_rows_kernel<2><<<blocks, kRows, 0, s>>>(bb, n, limit, LIMITSft, ff, n_rows, r, v, c, t); break;
    case 3: decode_rows_kernel<3><<<blocks, kRows, 0, s>>>(bb, n, limit, LIMITSft, ff, n_rows, r, v, c, t); break;
    default: decode_rows_kernel<4><<<blocks, kRows, 0, s>>>(bb, n, limit, LIMITSft, ff, n_rows, r, v, c, t);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k1_streams_phase(int phase, const void* b, long long s_n, long long n,
                                const void* limits, int ft, int ff, void* rows, void* valid,
                                void* count, void* tickets, void* stream) {
  const long long n_rows = (n + kFrame - 1) / kFrame;
  const dim3 grid(static_cast<unsigned>(n_rows > 0 ? (n_rows + kRows - 1) / kRows : 1),
                  static_cast<unsigned>(s_n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* bb = static_cast<const uint8_t*>(b);
  const long long* l = static_cast<const long long*>(limits);
  int* r = static_cast<int*>(rows);
  uint8_t* v = static_cast<uint8_t*>(valid);
  int* c = static_cast<int*>(count);
  unsigned long long* t = static_cast<unsigned long long*>(tickets);
  switch (phase) {
    case 0: empty_kernel<<<grid, kRows, 0, s>>>(); break;
    case 1: decode_rows_kernel<1><<<grid, kRows, 0, s>>>(bb, n, n, l, ft, ff, n_rows, r, v, c, t); break;
    case 2: decode_rows_kernel<2><<<grid, kRows, 0, s>>>(bb, n, n, l, ft, ff, n_rows, r, v, c, t); break;
    case 3: decode_rows_kernel<3><<<grid, kRows, 0, s>>>(bb, n, n, l, ft, ff, n_rows, r, v, c, t); break;
    default: decode_rows_kernel<4><<<grid, kRows, 0, s>>>(bb, n, n, l, ft, ff, n_rows, r, v, c, t);
  }
  return static_cast<int>(cudaGetLastError());
}
''')

STREAMS_ENTRY = 'extern "C" int slam_decode_rows_streams('


def own_entries(src: str, tag: str) -> str:
    """``src`` with its stream-axis C entry (where the kernel has one, with
    its per-stream ``limits``) renamed, so units link side by side."""
    return src.replace(STREAMS_ENTRY, f'extern "C" int {tag}_streams_unused(')


def edited(src: str, recipe, tag: str) -> str:
    """``src`` cut by ``recipe``, its C entry ``k1_phase`` renamed to
    ``<tag>_phase``."""
    _, edits, tail = recipe
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"diag_torch_k1_phases: the kernel source changed near {old!r}")
        src = src.replace(old, new.replace("TAG", tag))
    tail = tail.replace("LIMITS", "nullptr, " if STREAMS_ENTRY in src else "")
    tail = tail.replace("k1_phase(", f"{tag}_phase(").replace("k1_streams_phase(",
                                                               f"{tag}_streams_phase(")
    return "#include <climits>\n" + own_entries(src, tag) + tail


def recipe_of(src: str):
    for recipe in (PER_BYTE, PER_ROW):
        if recipe[0] in src:
            return recipe
    raise SystemExit("diag_torch_k1_phases: not a kernel whose phases this script knows")


def stream_inputs(torch, dev, root: Path) -> dict:
    """{name: (b [S, N], limits or None)}: the stream-axis calls of the 19
    streams' first 1 MiB round and of the batch's largest bucket group, made
    by this repository's ``chip_smoke.k1s_calls``."""
    import tempfile

    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import write_angle_table
    from torch_kernel_ab import smoke

    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        angles = write_angle_table(Path(tmp) / "beam_angle.xlsx")
        calls = smoke().k1s_calls(torch, sd, dev, angles)
    return {k: v for k, v in calls.items() if k.startswith(("streams_19_1MiB", "batch_"))}


def main() -> None:
    import torch

    from slam_process_tpu_torch.ops import _build, cuda_decode, decode
    from slam_process_tpu_torch.utils.synthetic import write_angle_table
    from torch_kernel_ab import cuda_ms, k1_k4_inputs

    if not torch.cuda.is_available():
        raise SystemExit("diag_torch_k1_phases: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = REPO / "build" / "diag_torch_k1_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    mine = (_build.CSRC / "decode.cu").read_text()
    base_only = "--base-only" in sys.argv
    streams_only = "--streams-only" in sys.argv
    argv = [a for a in sys.argv[1:] if a not in ("--base-only", "--streams-only")]
    units = {} if base_only else {"this": edited(mine, recipe_of(mine), "this")}
    recipes = {} if base_only else {"this": recipe_of(mine)}
    sizes = {}
    if recipe_of(mine) is PER_ROW and not base_only and not streams_only:
        own = re.search(r"constexpr int kRows = (\d+);", mine)
        if own is None:
            raise SystemExit("diag_torch_k1_phases: no kRows in the kernel")
        for rows in (128, 256, 512, 1024):
            if rows != int(own.group(1)):
                src = mine.replace(own.group(0), f"constexpr int kRows = {rows};")
                units[f"rows{rows}"] = own_entries(src.replace(
                    ENTRY, f'extern "C" int k1_rows{rows}('), f"k1_rows{rows}")
                sizes[f"rows{rows}"] = f"k1_rows{rows}"
    if argv:
        base = (Path(argv[0]) / "slam_process_tpu_torch" / "csrc" / "decode.cu").read_text()
        units["base"] = edited(base, recipe_of(base), "base")
        recipes["base"] = recipe_of(base)
    for name, src in units.items():
        (out_dir / f"{name}.cu").write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / "k1.so"),
                    *(str(out_dir / f"{name}.cu") for name in units)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out_dir / "k1.so"))
    argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
    streams_argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fns, streams_fns = {}, {}
    for tag in units.keys() & {"this", "base"}:
        fns[tag] = getattr(lib, f"{tag}_phase")
        fns[tag].argtypes = [ctypes.c_int] + argtypes
        fns[tag].restype = ctypes.c_int
        if recipes[tag] is not PER_BYTE:
            streams_fns[tag] = getattr(lib, f"{tag}_streams_phase")
            streams_fns[tag].argtypes = streams_argtypes
            streams_fns[tag].restype = ctypes.c_int
    for name, entry in sizes.items():
        fns[name] = getattr(lib, entry)
        fns[name].argtypes = argtypes
        fns[name].restype = ctypes.c_int

    dev = torch.device("cuda")
    (REPO / "build").mkdir(exist_ok=True)
    inputs = {}
    if not streams_only:
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            inputs = k1_k4_inputs(dev, write_angle_table(Path(tmp) / "beam_angle.xlsx"))[0]
    variants = [f"this_{ph}" for ph in PHASES if "this" in units] + list(sizes)
    if "base" in units:
        variants += [f"base_{ph}" for ph in PHASES]
    summary = {}

    def medians(name, n, passes, tags):
        med = {v: statistics.median(p[v] for p in passes) for v in passes[0]}
        added = {}
        for tag in tags:
            for i, ph in enumerate(PHASES):
                prev = med[f"{tag}_{PHASES[i - 1]}"] if i else 0.0
                added[f"{tag}_{ph}"] = med[f"{tag}_{ph}"] - prev
        summary[name] = {"bytes": n, "median_ms": med, "added_ms": added}

    for name, (b, limit) in inputs.items():
        n = b.numel()
        r = -(-n // 11)
        outs = (torch.zeros((r, 5), dtype=torch.int32, device=dev),
                torch.zeros(r, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
        stream = _build.stream_of(b)
        args = (b.data_ptr(), n, limit, 0xCC, 0x33, *(t.data_ptr() for t in outs),
                cuda_decode.ticket_for(dev, stream).data_ptr(), stream)

        def call(v, args=args):
            tag, _, phase = v.partition("_")
            err = (fns[v](*args) if v in sizes
                   else fns[tag](PHASES.index(phase), *args))
            _build.check(err, f"K1 variant {v}")

        want = decode.decode_rows_plain(b, n_valid=limit)
        for v in [f"{t}_full" for t in ("this", "base") if t in units] + list(sizes):
            for t in outs:
                t.zero_()
            call(v)
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise SystemExit(f"diag_torch_k1_phases: {v} differs from the plain version "
                                 f"at {name}")

        def fills(r=r):
            torch.zeros((r, 5), dtype=torch.int32, device=dev)
            torch.zeros(r, dtype=torch.bool, device=dev)
            torch.zeros((), dtype=torch.int32, device=dev)

        passes = []
        for _ in range(3):
            ms = {v: cuda_ms(lambda v=v: call(v)) for v in variants}
            ms["fills"] = cuda_ms(fills)
            if not base_only:
                ms["wrapper"] = cuda_ms(
                    lambda: cuda_decode.decode_rows_cuda(b, limit, 0xCC, 0x33))
            passes.append(ms)
            print(json.dumps({"input": name, "bytes": n, "ms": ms}), flush=True)
        medians(name, n, passes, [t for t in ("this", "base") if t in units])

    # The stream-axis entry: each cut of each checkout's kernel on the
    # multi-wave calls, the full cut held to the plain version first.
    s_variants = [f"{t}_{ph}" for t in ("this", "base") if t in streams_fns for ph in PHASES]
    for name, (b, lim) in stream_inputs(torch, dev, REPO).items():
        s_n, n = b.shape
        r = -(-n // 11)
        outs = (torch.zeros((s_n, r, 5), dtype=torch.int32, device=dev),
                torch.zeros((s_n, r), dtype=torch.bool, device=dev),
                torch.zeros(s_n, dtype=torch.int32, device=dev))
        stream = _build.stream_of(b)
        args = (b.data_ptr(), s_n, n, None if lim is None else lim.data_ptr(), 0xCC, 0x33,
                *(t.data_ptr() for t in outs),
                cuda_decode.tickets_for(dev, stream, s_n).data_ptr(), stream)

        def s_call(v, args=args):
            tag, _, phase = v.partition("_")
            _build.check(streams_fns[tag](PHASES.index(phase), *args), f"K1 variant {v}")

        want = decode.decode_rows_streams_plain(b, n_valid=lim)
        for tag in streams_fns:
            for t in outs:
                t.zero_()
            s_call(f"{tag}_full")
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise SystemExit(f"diag_torch_k1_phases: {tag}_full differs from the plain "
                                 f"version at {name}")
        passes = []
        for _ in range(3):
            ms = {v: cuda_ms(lambda v=v: s_call(v)) for v in s_variants}
            if not base_only:
                ms["wrapper"] = cuda_ms(
                    lambda: cuda_decode.decode_rows_streams_cuda(b, lim, 0xCC, 0x33))
            passes.append(ms)
            print(json.dumps({"input": name, "streams_bytes": [s_n, n], "ms": ms}), flush=True)
        medians(name, [s_n, n], passes, [t for t in ("this", "base") if t in streams_fns])
    print(json.dumps({"nvidia_smi": smi, **summary}), flush=True)


if __name__ == "__main__":
    main()
