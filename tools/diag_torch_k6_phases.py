#!/usr/bin/env python3
"""Where kernel K6's time goes: the chain of ``csrc/tracker.cu`` with one
part at a time cut out, timed on one NVIDIA GPU through the stream-axis
entry at the 19 streams' first 1 MiB round (19 trackers of 65 lanes,
``chip_smoke.multi_round_inputs``) and at S = 1 with 65 lanes, 33 live
(``chip_smoke.k6_cases``' ``main_65_lanes``, what a single stream's paths
window calls).

    python3 tools/diag_torch_k6_phases.py [BASE_CHECKOUT [--base-only]]

Builds, with nvcc, variants of the repository's own kernel source (and,
with BASE_CHECKOUT, of that checkout's ``tracker.cu``, as ``base_<cut>``),
each on the same grid of one block per stream:

  empty          an empty kernel: the launch;
  full           the kernel as shipped;
  no_rounds      without the assignment rounds (the warp reductions);
  no_carry_reads without the reads of the tracks' positions that each pair's
                 cost needs: the two shuffles per pair (the form that
                 shuffles the owner's position), or each round's loads of
                 the moved track's new position (the form whose pairs keep
                 their own copies);
  no_leftovers   without the leftover paths opening tracks;
  no_stores      without the column stores (and the owner's update);
  no_staging     without staging the lanes in shared memory (the chain
                 reads what the buffers hold).

A cut changes what the chain computes, so a cut's time is what the chain
costs without that part, not an exact share.  Prints each stream's live
lanes, the microseconds per live lane of the slowest stream, one JSON line
per pass (three passes of CUDA-event medians, ``tools/torch_kernel_ab.py``'s
``cuda_ms``) and the medians.  The full variant must equal the plain
version.  The variants are made by editing the source text; the script
stops if the kernel's text no longer has the places it edits.
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

CUTS = ("empty", "full", "no_rounds", "no_carry_reads", "no_leftovers", "no_stores",
        "no_staging")

# Each cut: (old, new) pairs, where an old text may differ by the kernel's
# form; the first pair of a list whose old text the source holds once is
# applied.  CUT stands for the cut's index.
EDITS = {
    "no_rounds": [[("while (free_t != 0u && free_k != 0u) {",
                    "while (CUT != 2 && free_t != 0u && free_k != 0u) {")]],
    "no_carry_reads": [[
        ("          const float pa = __shfl_sync(kFull, my_a, pt[j] < 0 ? 0 : pt[j]);\n"
         "          const float pd = __shfl_sync(kFull, my_d, pt[j] < 0 ? 0 : pt[j]);\n",
         "          const float pa = CUT == 3 ? my_a : __shfl_sync(kFull, my_a, pt[j] < 0 ? 0 : pt[j]);\n"
         "          const float pd = CUT == 3 ? my_d : __shfl_sync(kFull, my_d, pt[j] < 0 ? 0 : pt[j]);\n"),
        ("            if (pt[j] == bt) {\n", "            if (CUT != 3 && pt[j] == bt) {\n")]],
    "no_leftovers": [[("        if (n_new > 0) {\n", "        if (CUT != 4 && n_new > 0) {\n")]],
    "no_stores": [[
        ("        if (lane < t_n) {\n          const long long o = static_cast<long long>(i) * t_n + lane;\n",
         "        if (CUT != 5 && lane < t_n) {\n          const long long o = static_cast<long long>(i) * t_n + lane;\n"),
        ("        if (lane < t_n) {\n          float my_p = 0.0f;\n",
         "        if (CUT != 5 && lane < t_n) {\n          float my_p = 0.0f;\n")]],
    "no_staging": [[("  if (n_tiles > 0) stage(st, 0,", "  if (CUT != 6 && n_tiles > 0) stage(st, 0,")],
                   [("      stage(st, buf ^ 1,", "      if (CUT != 6) stage(st, buf ^ 1,")]],
}

TAIL = r'''
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int TAG_empty(int n_streams, void* stream) {
  empty_kernel<<<n_streams, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
'''


def variant(src: str, cut: int, tag: str) -> str:
    """``src`` with cut ``cut`` applied (``CUTS`` index, 1: none) and its C
    entries renamed: the stream-axis entry to ``<tag>_streams``."""
    for name, groups in EDITS.items():
        for group in groups:
            for old, new in group:
                if src.count(old) == 1:
                    src = src.replace(old, new.replace("CUT", str(cut)))
                    break
            else:
                raise SystemExit(f"diag_torch_k6_phases: the kernel source changed near "
                                 f"{group[0][0]!r} ({name})")
    src = src.replace('extern "C" int slam_track_block_streams(', f'extern "C" int {tag}_streams(')
    src = src.replace('extern "C" int slam_track_block(', f'extern "C" int {tag}_single_unused(')
    return src + (TAIL.replace("TAG", tag) if cut == 1 else "")


def inputs(torch, dev) -> dict:
    """{name: args of ``track_block_streams_cuda``}: the 19 streams' round
    and the single stream's 65 lanes (33 live) as S = 1."""
    import numpy as np

    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table
    from torch_kernel_ab import smoke

    cs = smoke()
    raws = [synthetic_session_bytes(**c) for c in cs.DATASET]
    ecap = -(-(max(len(r) for r in raws) // 11 + 1) // (1 << 16)) * (1 << 16)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        spec = sd.make_paths_spec(write_angle_table(Path(tmp) / "beam_angle.xlsx"), s_step=64)
        multi = cs.multi_round_inputs(sd, raws, dev, spec, ecap)
    args6, kw6 = multi["K6s"][0]
    one, gate = cs.k6_cases(np, torch, dev)["main_65_lanes"]
    return {"streams_19_65_lanes": (*args6, *kw6.values()),
            "S1_65_lanes_33_live": (*(x[None] for x in one[:8]), gate)}


def main() -> None:
    import numpy as np
    import torch

    from slam_process_tpu_torch.ops import _build, cuda_tracker, tracker
    from torch_kernel_ab import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("diag_torch_k6_phases: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = REPO / "build" / "diag_torch_k6_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    argv = [a for a in sys.argv[1:] if a != "--base-only"]
    sources = {} if "--base-only" in sys.argv else {
        "this": (_build.CSRC / "tracker.cu").read_text()}
    if argv:
        sources["base"] = (Path(argv[0]) / "slam_process_tpu_torch" / "csrc" /
                           "tracker.cu").read_text()
    units = []
    for tag, src in sources.items():
        for cut in range(1, len(CUTS)):
            units.append(out_dir / f"{tag}_{CUTS[cut]}.cu")
            units[-1].write_text(variant(src, cut, f"{tag}_{CUTS[cut]}"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / "k6.so"),
                    *map(str, units)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out_dir / "k6.so"))
    fns = {}
    for tag in sources:
        for cut in CUTS[1:]:
            fn = getattr(lib, f"{tag}_{cut}_streams")
            fn.argtypes = cuda_tracker._fn_streams().argtypes
            fn.restype = ctypes.c_int
            fns[f"{tag}_{cut}"] = fn
        fn = getattr(lib, f"{tag}_full_empty")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[f"{tag}_empty"] = fn

    dev = torch.device("cuda")
    summary = {}
    for name, args in inputs(torch, dev).items():
        aoa, aod, pw, val, m_eff, pos, created, count, gate = args
        s_n, s1, k_n = aoa.shape
        t_n = pos.shape[1]
        live = [max(0, min(int(m), s1)) for m in m_eff.tolist()]
        outs = [torch.empty((s_n, s1, t_n), dtype=torch.float32, device=dev) for _ in range(3)]
        outs += [torch.empty((s_n, s1, t_n), dtype=torch.bool, device=dev),
                 torch.empty_like(pos), torch.empty_like(created), torch.empty_like(count)]
        gate2 = float(np.float32(gate) * np.float32(gate))
        stream = _build.stream_of(aoa)
        c_args = (s_n, *(t.data_ptr() for t in (aoa, aod, pw, val, m_eff, pos, created, count)),
                  s1, k_n, t_n, gate2, *(t.data_ptr() for t in outs), stream)

        def call(v, c_args=c_args, s_n=s_n, stream=stream):
            err = fns[v](s_n, stream) if v.endswith("_empty") else fns[v](*c_args)
            _build.check(err, f"K6 variant {v}")

        want = tracker.track_block_streams_plain(*args)
        for tag in sources:
            call(f"{tag}_full")
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise SystemExit(f"diag_torch_k6_phases: {tag}_full differs from the plain "
                                 f"version at {name}")
        variants = [f"{tag}_{cut}" for tag in sources for cut in CUTS]
        passes = []
        for _ in range(3):
            passes.append({v: cuda_ms(lambda v=v: call(v)) for v in variants})
            print(json.dumps({"input": name, "ms": passes[-1]}), flush=True)
        med = {v: statistics.median(p[v] for p in passes) for v in variants}
        summary[name] = {
            "streams_lanes_paths_tracks": [s_n, s1, k_n, t_n], "live_lanes_per_stream": live,
            "median_ms": med,
            "saved_ms": {v: med[f"{v.split('_')[0]}_full"] - med[v] for v in variants
                         if not v.endswith(("_full", "_empty"))},
            "us_per_live_lane_of_slowest_stream": {
                tag: med[f"{tag}_full"] * 1e3 / max(1, max(live)) for tag in sources}}
    print(json.dumps({"nvidia_smi": smi, **summary}), flush=True)


if __name__ == "__main__":
    main()
