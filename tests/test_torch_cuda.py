"""Kernels K1-K7 against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where ``torch.cuda.is_available()`` is False
(the condition is evaluated when each test is set up).  On a machine with
a card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.  These add to
what ``chip_smoke.py`` checks; they do not replace it.  K1 and K2 must equal
their plain versions element for element; K3 holds blurred bit-equal,
norm_t within 1e-4 absolute, the same NaN pattern, LUT-bin flips
under 0.1 % and premultiplied rgba within 1e-3 (the card's logf and the
CPU's log may differ in the last bit).  K4 must equal its plain version
element for element, ``Session.from_log`` on logs past the corrector's
default bounds must rerun K2 on the card and equal its CPU run, and
``Session.sweep_paths`` on the card must equal its CPU run (power within
rtol 2e-4).  K5 (compaction: one destination, two, no rows, 4 M rows
repeated 200 times) and K6 (tracker block: T * K just above one warp, the
T = 16, K = 20 limits, 600 lanes, m_eff = s1 - 1 and m_eff > s1) must equal
their plain versions element for element, and a short device stream on the
card, launching K1, K2, K4, K5 and K6, must equal the same stream with
``device="cpu"`` (power within rtol 2e-4).  ``Session.path_tracks`` with
its defaults must launch K6 and equal the numpy association.  K2 must also
equal its plain version on the full session's shape and on every input of
``utils/synthetic.verdict_edge_cases``; K3 is also held for S = 1, 4 and
66 tiles of 64 x 64, 48 x 100 and 5 x 7 (fewer rows than the cluster's
eight bands) at sigma 0, 0.5, 1, 2.3 and 3, with all-NaN and one-cell
tiles, log and linear.  K1 and K4 are also held, one launch a call, on
every input of ``utils/synthetic.decode_edge_cases`` (all-flag bytes,
back-to-back frames at each offset mod 11, a frame ending at n_valid and one
byte past it, N at the row blocks' edges) and ``sweep_sums_edge_cases`` (one
cell over many tiles, sorted p with -1 runs and a -1 tail, S = 1, a cell at
2^24 - 1, n_beams 32, 100 and 1,500), on byte views at every 16-byte
misalignment, on calls repeated on one stream (the count scratch resets) and
on interleaved K4 calls of different S.  The tenth slice's paths on the
card: the stride-3 tokenizer equal to its CPU run, the text path equal to
the byte path field for field (shipped and CRLF layouts), the pre-log
session within one float32 ulp of the CPU and rtol 1e-6 of the float64
oracle (a stream and its checkpoint resume too), SM-SIC on the card equal
to the host engine and the CPU, ``sweep_paths_dataset`` equal to each
session's ``sweep_paths``, and an SM-SIC stream equal to the offline paths.
The eleventh slice's estimator families (svd, omp_dense, lasso_refine,
peak_picking, fusion, nn_omp_v13, geometric) on a session decoded and
corrected on the card: each table equal in rows, labels and cells to its
``device="cpu"`` and host-engine runs, values within the family's bound
(svd 1e-9, omp_dense 1e-6, fusion's NLoS metric 1e-9 and its NN-OMP LoS
2e-4, nn_omp_v13 2e-4, lasso_refine 1e-9 against the CPU and JAX's bounds
against the tol-stopped host), geometric's warning.  The twelfth slice:
K1, K5 and K6 with the stream axis against their plain versions (S streams
in one launch), the flattened K2 and K4 calls against S separate kernel
calls, ``run_dataset`` in both forms against each session's
``run_session_on_device`` (exact, rasters bit-equal) and the CPU, and a
``MultiStreamingSession`` of three streams against three single streams on
the card (exact) and against its CPU run (power within rtol 2e-4).  The
thirteenth slice: a (2, 2) mesh whose positions repeat cuda:0 equal to
``mesh=None`` for the batch, the multi-stream session and
``sweep_paths_dataset``; a shard on cuda:1 where there are two cards.
The fourteenth slice: ``measure_device_time`` on a product (each index
called once, every run's device seconds from its own activities, the kept
trace read back by ``module_device_times``); ``_batched_nn_omp`` "vmap" and
"gram" and ``nn_omp_sessions_device`` on one packed input equal to "vmap"
and to their CPU runs; ``nn_omp_batch`` over a session's sweeps equal to
``nn_omp_gram_batch`` and to the CPU; ``detect_scene_changes`` on the card's
K6 tracks bit-equal to ``detect_scene_changes_np``.  The sixteenth slice:
K7 (batched NNLS) against its plain version on
``utils/synthetic.nnls_edge_cases`` at K = 1, 2, 3, 20 and 32 under both
solvers (bit-equal for "auto" at K >= 3, else equal passive sets and x
within rtol 1e-6), no host sync; the paths window as one CUDA graph
bit-equal to its eager round after every feed; a paths stream that syncs
nothing in ``feed``, equal to its CPU run and to the offline
``Session.sweep_paths`` / ``path_tracks`` on the card.  The seventeenth
slice: K7's element path (K > 3) against its plain version at every K
from 4 to 32, at 1, 21, 65 and 300 lanes, both solvers, warm and cold
starts, NaN lanes and the 0/0 lane; K5's stream axis at S = 1, 2, 19 and
64 (capacity overflow, nonzero offsets, a zero tail) equal to its plain
version.  The eighteenth slice: K1's stream axis, whose blocks past a
stream's limit read nothing, on ``utils/synthetic.decode_stream_cases``
(ragged limits of 0, mid-frame, exactly n and past n; n a multiple of
neither 11 nor 16; one 19.9 MB stream), the batch's 19 sessions at their
786,432-byte bucket,
a view at an odd byte offset, and a multi-wave call captured in a CUDA
graph and replayed twice with its ticket words left zero; K6's stream axis
on ``track_stream_cases`` (chains over several staging tiles, T = 16 with K
= 20, m_eff 0 and past s1, planted ties, a NaN cost), bit for bit.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.ops import (
    compact, correct, cuda_compact, cuda_correct, cuda_decode, cuda_raster, cuda_sweep_sums,
    cuda_tracker, decode, raster, scene, tracker)
from slam_process_tpu_torch.pipeline.device import run_session_on_device
from slam_process_tpu_torch.utils.synthetic import (
    decode_edge_cases, sweep_sums_edge_cases, synthetic_session_bytes, verdict_edge_cases)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import eager_rounds  # noqa: E402  (the multi-stream graphs' comparator)

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU (CUDA kernels have no CPU mode)")]


def session(seed=0, **kw):
    args = dict(n_groups=6, frames_per_beam=3, baselines_per_group=9, junk_frac=0.3,
                big_group=4200, seed=seed)
    args.update(kw)
    return synthetic_session_bytes(**args)


@pytest.mark.parametrize("cut", [0, 37])
def test_decode_kernel_matches_plain(cut):
    b = torch.from_numpy(session()).cuda()
    limit = b.numel() - cut
    got = cuda_decode.decode_rows_cuda(b, limit, 0xCC, 0x33)
    want = decode.decode_rows_plain(b, n_valid=limit)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2]) > 0


K1_EDGES = decode_edge_cases()


@pytest.mark.parametrize("name", sorted(K1_EDGES))
def test_decode_kernel_edge_cases_match_plain(name):
    raw, n_valid = K1_EDGES[name]
    b = torch.from_numpy(raw)
    limit = len(raw) if n_valid is None else n_valid
    cuda_decode.LAUNCHES = 0
    got = cuda_decode.decode_rows_cuda(b.cuda(), limit, 0xCC, 0x33)
    assert cuda_decode.LAUNCHES == 1
    for g, w in zip(got, decode.decode_rows_plain(b, n_valid=n_valid)):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_decode_kernel_misaligned_views_and_repeated_calls():
    """Views of a session's bytes at every offset mod 16 (the kernel's
    16-byte staging loads apply only where b is aligned), each called twice
    on one stream: the count's scratch word is back at 0 after every call."""
    raw = torch.from_numpy(session(3))
    dev_raw = raw.cuda()
    for off in range(16):
        want = decode.decode_rows_plain(raw[off:], n_valid=len(raw) - off - 5)
        for _ in range(2):
            got = cuda_decode.decode_rows_cuda(dev_raw[off:], len(raw) - off - 5, 0xCC, 0x33)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
        assert int(want[2]) > 0


K4_EDGES = sweep_sums_edge_cases()


@pytest.mark.parametrize("name", sorted(K4_EDGES))
def test_sweep_sums_kernel_edge_cases_match_plain(name):
    p, bs, val, s, nb = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                         for x in K4_EDGES[name])
    cuda_sweep_sums.LAUNCHES = 0
    got = cuda_sweep_sums.sweep_sums_cuda(p.cuda(), bs.cuda(), val.cuda(), s, nb)
    assert cuda_sweep_sums.LAUNCHES == 1
    for g, w in zip(got, scene.sweep_sums_plain(p, bs, val, s, nb)):
        assert torch.equal(g.cpu(), w)


def test_sweep_sums_kernel_interleaved_shapes_and_orders():
    """Calls of S = 9 and S = 65 interleaved on one stream, and an unsorted
    stream over 65 sweeps repeated: every result equals the plain version
    bit for bit (integer sums, whatever the order of the adds)."""
    rng = np.random.default_rng(9)
    cases = []
    for s, f, sort in ((9, 14_000, True), (65, 100_000, True), (65, 200_000, False)):
        p = rng.integers(-1, s * 64, f)
        p = np.sort(p) if sort else p
        cases.append(tuple(torch.from_numpy(x.astype(np.int32)) for x in (
            p, rng.integers(0, 64, f), rng.integers(0, 1 << 18, f))) + (s,))
    want = [scene.sweep_sums_plain(*c) for c in cases]
    on_card = [tuple(t.cuda() for t in c[:3]) + (c[3],) for c in cases]
    for k in (0, 1, 0, 2, 1, 2, 2, 0):
        got = cuda_sweep_sums.sweep_sums_cuda(*on_card[k])
        for g, w in zip(got, want[k]):
            assert torch.equal(g.cpu(), w)


def test_correct_kernel_matches_plain():
    b = torch.from_numpy(session(1)).cuda()
    rows, valid, _ = decode.decode_rows(b)
    gid, packed, overflow = correct.baseline_table(rows, valid, 256, 256)
    clk = rows[:, 4].contiguous()
    args = dict(bmax=256, cycle=61_000, tol=500)
    got = cuda_correct.correct_verdicts_cuda(gid, clk, packed, **args)
    want = correct.baseline_plane_verdicts(gid, clk, packed, **args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(overflow) and got[0].any()


def test_correct_kernel_full_session_matches_plain():
    """The main path's shape: 58 groups x 64 beams x 43 frames with a
    4,400-frame group 0, every decoded row (padding rows included)."""
    b = torch.from_numpy(synthetic_session_bytes(
        n_groups=58, frames_per_beam=43, baselines_per_group=93, junk_frac=0.02,
        big_group=4400, seed=0)).cuda()
    rows, valid, _ = decode.decode_rows(b)
    gid, packed, overflow = correct.baseline_table(rows, valid, 256, 256)
    clk = rows[:, 4].contiguous()
    args = dict(bmax=256, cycle=61_000, tol=500)
    got = cuda_correct.correct_verdicts_cuda(gid, clk, packed, **args)
    want = correct.baseline_plane_verdicts(gid, clk, packed, **args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(overflow) and int(got[0].sum()) > 150_000


K2_EDGES = verdict_edge_cases()


@pytest.mark.parametrize("name", sorted(K2_EDGES))
def test_correct_kernel_edge_cases_match_plain(name):
    gid, clk, packed = (torch.from_numpy(x) for x in K2_EDGES[name][:3])
    kw = K2_EDGES[name][3]
    cuda_correct.LAUNCHES = 0
    got = cuda_correct.correct_verdicts_cuda(gid.cuda(), clk.cuda(), packed.cuda(), **kw)
    assert cuda_correct.LAUNCHES == 1
    want = correct.baseline_plane_verdicts(gid, clk, packed, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(want[0].any())


@pytest.mark.parametrize("use_log", [True, False])
def test_raster_kernel_matches_plain(use_log):
    gen = torch.Generator().manual_seed(5)
    mats = torch.rand((4, 64, 64), generator=gen) * (1 << 18)
    mats[torch.rand((4, 64, 64), generator=gen) < 0.05] = float("nan")
    mats[2] = float("nan")
    mats[3] = float("nan")
    mats[3, 10, 20] = 77.0
    mats = mats.cuda()
    lut = torch.from_numpy(raster.colormap_lut()).cuda()
    taps = raster.blur_taps(1.0, "cuda")
    assert_raster_matches(cuda_raster.raster_tiles_cuda(mats, lut, taps, use_log),
                          raster.raster_tiles_plain(mats, lut, taps, use_log))


def assert_raster_matches(got, want):
    """blurred bit-equal (NaN where the plain version has NaN), norm_t within
    1e-4 with the same NaNs, LUT-bin flips under 0.1 %, premultiplied rgba
    within 1e-3."""
    (rgba, t, b), (rgba_p, t_p, b_p) = got, want
    assert torch.equal(torch.isnan(b), torch.isnan(b_p))
    assert torch.equal(torch.nan_to_num(b, nan=0.0), torch.nan_to_num(b_p, nan=0.0))
    assert torch.equal(torch.isnan(t), torch.isnan(t_p))
    fin = ~torch.isnan(t)
    if fin.any():
        assert float((t[fin] - t_p[fin]).abs().max()) <= 1e-4
    bins = (t.nan_to_num() * 256).long().clamp(0, 255)
    bins_p = (t_p.nan_to_num() * 256).long().clamp(0, 255)
    assert float((bins != bins_p).float().mean()) < 1e-3
    assert float((rgba * rgba[..., 3:] - rgba_p * rgba_p[..., 3:]).abs().max()) <= 1e-3


@pytest.mark.parametrize("shape", [(64, 64), (48, 100), (5, 7)])
@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 2.3, 3.0])
def test_raster_kernel_cluster_bands_match_plain(shape, sigma):
    """One cluster of eight row bands per tile: S = 1, 4 and 66 tiles (tile
    0 all NaN and tile 1 one finite cell where S > 1), log and linear; taps
    1 x 1 to 19 x 19 (sigma 0 to 3): 7 x 7 through the kernel built for that
    width, the others through the one that reads the width at run time."""
    lut = torch.from_numpy(raster.colormap_lut()).cuda()
    taps = raster.blur_taps(sigma, "cuda")
    for s in (1, 4, 66):
        gen = torch.Generator().manual_seed(s * 1000 + shape[1])
        mats = torch.rand((s, *shape), generator=gen) * (1 << 18)
        mats[torch.rand((s, *shape), generator=gen) < 0.05] = float("nan")
        if s > 1:
            mats[:2] = float("nan")
            mats[1, shape[0] // 2, shape[1] // 3] = 1234.0
        mats = mats.cuda()
        for use_log in (True, False):
            cuda_raster.LAUNCHES = 0
            got = cuda_raster.raster_tiles_cuda(mats, lut, taps, use_log)
            assert cuda_raster.LAUNCHES == 1
            assert_raster_matches(got, raster.raster_tiles_plain(mats, lut, taps, use_log))


def test_pipeline_on_card_matches_cpu_and_counts_launches():
    raw = session(2)
    for m in (cuda_decode, cuda_correct, cuda_raster):
        m.LAUNCHES = 0
    got = run_session_on_device(raw)
    assert (cuda_decode.LAUNCHES, cuda_correct.LAUNCHES, cuda_raster.LAUNCHES) == (1, 1, 1)
    want = run_session_on_device(raw, device="cpu")
    for field in ("frames", "frame_valid", "n_frames", "corrected_bs", "keep",
                  "correct_overflow", "n_kept", "counts"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
    np.testing.assert_array_equal(got.mean_grid.cpu().numpy(), want.mean_grid.numpy())
    fin = torch.isfinite(want.norm_t)
    assert torch.equal(torch.isfinite(got.norm_t.cpu()), fin)
    assert float((got.norm_t.cpu()[fin] - want.norm_t[fin]).abs().max()) <= 1e-4


@pytest.mark.parametrize("s", [3, 66])
def test_sweep_sums_kernel_matches_plain(s):
    rng = np.random.default_rng(s)
    f = 50_000
    p = torch.from_numpy(rng.integers(-3, s * 64 + 3, f).astype(np.int32))
    bs = torch.from_numpy(rng.integers(-1, 65, f).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 1 << 18, f).astype(np.int32))
    cuda_sweep_sums.LAUNCHES = 0
    got = cuda_sweep_sums.sweep_sums_cuda(p.cuda(), bs.cuda(), val.cuda(), s)
    want = scene.sweep_sums_plain(p, bs, val, s)
    assert cuda_sweep_sums.LAUNCHES == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert float(got[1].sum()) > 0


def test_sweep_paths_on_card_matches_cpu(tmp_path):
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import to_hex_text, write_angle_table

    path = tmp_path / "s.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=5, frames_per_beam=43, baselines_per_group=9, junk_frac=0.02, seed=4,
        n_paths=3)))
    angles = write_angle_table(tmp_path / "angles.xlsx")
    s = Session.from_log(path)
    cuda_sweep_sums.LAUNCHES = 0
    paths, valid = s.sweep_paths(angles)
    assert cuda_sweep_sums.LAUNCHES == 1
    ref, ref_valid = s.sweep_paths(angles, device="cpu")
    np.testing.assert_array_equal(valid, ref_valid)
    for field in paths._fields:
        if field == "power":
            np.testing.assert_allclose(paths.power, ref.power, rtol=2e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(paths, field), getattr(ref, field),
                                          err_msg=field)


@pytest.mark.parametrize("kw", [dict(n_groups=257, frames_per_beam=1, baselines_per_group=1),
                                dict(n_groups=2, frames_per_beam=10, baselines_per_group=300)])
def test_session_overflow_reruns_on_card(tmp_path, kw):
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import to_hex_text

    path = tmp_path / "overflow.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(junk_frac=0.02, seed=6, **kw)))
    cuda_correct.LAUNCHES = 0
    got = Session.from_log(path)
    assert cuda_correct.LAUNCHES == 2
    want = Session.from_log(path, device="cpu")
    for field in ("frames", "corrected_bs", "filtered"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert len(got.filtered) > 0


@pytest.mark.parametrize("f,cap,dens", [(103_518, 8192, 0.05), (20_000, 512, 0.9),
                                        (5_000, 6_000, 0.0), (1, 4, 1.0)])
def test_compact_kernel_matches_plain(f, cap, dens):
    rng = np.random.default_rng(f)
    rows = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (f, 5)).astype(np.int32))
    mask = torch.from_numpy(rng.random(f) < dens)
    cuda_compact.LAUNCHES = 0
    got, n = cuda_compact.compact_rows_cuda(rows.cuda(), mask.cuda(), cap)
    want, n_want = compact.compact_rows_plain(rows, mask, cap)
    assert cuda_compact.LAUNCHES == 1
    assert torch.equal(got.cpu(), want) and int(n) == int(n_want)
    ring = torch.from_numpy(rng.integers(-9, 9, (cap + 7, 5)).astype(np.int32))
    for off in (0, cap // 3, cap):
        offset = torch.tensor(off, dtype=torch.int32)
        got, _ = cuda_compact.compact_rows_cuda(rows.cuda(), mask.cuda(), cap,
                                                out=ring.cuda(), offset=offset.cuda())
        want, _ = compact.compact_rows_plain(rows, mask, cap, out=ring.clone(), offset=offset)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m_eff", [65, 15, 1, 0])
def test_tracker_kernel_matches_plain(m_eff):
    rng = np.random.default_rng(m_eff)
    s1, k_n, t_n = 65, 3, 8
    lanes = [torch.from_numpy(rng.uniform(-45, 45, (s1, k_n)).astype(np.float32))
             for _ in range(2)]
    lanes.append(torch.from_numpy(rng.uniform(0, 1, (s1, k_n)).astype(np.float32)))
    val = torch.from_numpy(rng.random((s1, k_n)) < 0.6)
    pos = torch.from_numpy(rng.uniform(-45, 45, (t_n, 2)).astype(np.float32))
    created = torch.from_numpy(np.arange(t_n) < 3)
    args = (torch.tensor(m_eff, dtype=torch.int32), pos, created,
            torch.tensor(3, dtype=torch.int32))
    cuda_tracker.LAUNCHES = 0
    got = cuda_tracker.track_block_cuda(*(x.cuda() for x in (*lanes, val, *args)), 30.0)
    want = tracker.track_block_plain(*lanes, val, *args, 30.0)
    assert cuda_tracker.LAUNCHES == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("s1,k_n,t_n,m_eff,grid", [
    (65, 5, 8, 65, False),      # T * K = 40: just above one warp's 32 pairs
    (40, 20, 16, 40, False),    # the limits: 320 pairs, ten per thread
    (40, 20, 16, 40, True),     # the limits on an integer grid: exact ties across threads
    (600, 3, 8, 600, False),    # offline length: two staging tiles
    (600, 20, 16, 600, True),   # eight staging tiles
    (65, 3, 8, 64, False),      # m_eff = s1 - 1
    (65, 3, 8, 80, False),      # m_eff > s1
])
def test_tracker_kernel_shapes_match_plain(s1, k_n, t_n, m_eff, grid):
    rng = np.random.default_rng(s1 + k_n + t_n + m_eff + grid)
    if grid:
        lanes = [torch.from_numpy(rng.integers(-4, 5, (s1, k_n)).astype(np.float32))
                 for _ in range(2)]
    else:
        lanes = [torch.from_numpy(rng.uniform(-45, 45, (s1, k_n)).astype(np.float32))
                 for _ in range(2)]
    lanes.append(torch.from_numpy(rng.uniform(0, 1, (s1, k_n)).astype(np.float32)))
    val = torch.from_numpy(rng.random((s1, k_n)) < 0.6)
    args = (torch.tensor(m_eff, dtype=torch.int32), torch.zeros((t_n, 2)),
            torch.zeros(t_n, dtype=torch.bool), torch.tensor(0, dtype=torch.int32))
    gate = 6.0 if grid else 15.0
    cuda_tracker.LAUNCHES = 0
    got = cuda_tracker.track_block_cuda(*(x.cuda() for x in (*lanes, val, *args)), gate)
    want = tracker.track_block_plain(*lanes, val, *args, gate)
    assert cuda_tracker.LAUNCHES == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[6]) == t_n and bool(want[3].any())


def test_compact_kernel_no_rows():
    rows = torch.zeros((0, 5), dtype=torch.int32, device="cuda")
    mask = torch.zeros(0, dtype=torch.bool, device="cuda")
    ring = torch.full((9, 5), 7, dtype=torch.int32, device="cuda")
    (fresh, appended), n = cuda_compact.compact_rows_multi_cuda(
        rows, mask, [(16, None, None), (9, ring, torch.tensor(3, dtype=torch.int32,
                                                               device="cuda"))])
    assert int(n) == 0 and not fresh.any() and fresh.shape == (16, 5)
    assert appended is ring and bool((ring == 7).all())


def test_compact_kernel_repeats_exactly_at_4m_rows():
    """The race test of the look-back: 4,194,304 rows (4,096 tiles, more
    than the card holds at once) at 50 % density, 200 times, every result
    equal to the first and the first to the plain version."""
    f = 4_194_304
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.randint(-(1 << 30), 1 << 30, (f, 5), generator=gen, dtype=torch.int32,
                         device="cuda")
    mask = torch.rand(f, generator=gen, device="cuda") < 0.5
    cap = (1 << 21) + 5_000          # about the masked count: rows drop or the tail is zeroed
    ring = torch.zeros((f, 5), dtype=torch.int32, device="cuda")
    offset = torch.tensor(12_345, dtype=torch.int32, device="cuda")
    dests = [(cap, None, None), (f, ring, offset)]
    (first, first_ring), n = cuda_compact.compact_rows_multi_cuda(rows, mask, dests)
    (want, want_ring), n_want = compact.compact_rows_multi_plain(
        rows, mask, [(cap, None, None), (f, torch.zeros_like(ring), offset)])
    assert torch.equal(first, want) and torch.equal(first_ring, want_ring)
    assert int(n) == int(n_want)
    first_ring = first_ring.clone()
    for _ in range(200):
        (got, got_ring), n_got = cuda_compact.compact_rows_multi_cuda(rows, mask, dests)
        assert torch.equal(got, first) and torch.equal(got_ring, first_ring)
        assert int(n_got) == int(n)


@pytest.mark.parametrize("offset,cap", [(8192, 8192), (0, 1000), (7000, 8192)])
def test_compact_kernel_two_destinations_match_plain(offset, cap):
    """The stream's fused call on a 1 MiB window's shape (103,518 rows):
    the emit-ring append at ``offset`` (at the capacity: nothing lands;
    a capacity below the masked count: rows drop) and the paths' fresh
    buffer, against two plain calls."""
    rng = np.random.default_rng(offset + cap)
    f = 103_518
    rows = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (f, 4)).astype(np.int32))
    mask = torch.from_numpy(rng.random(f) < 0.9)
    ring = torch.from_numpy(rng.integers(-9, 9, (cap + 3, 4)).astype(np.int32))
    off = torch.tensor(offset, dtype=torch.int32)
    cuda_compact.LAUNCHES = 0
    (got_ring, got_fresh), n = cuda_compact.compact_rows_multi_cuda(
        rows.cuda(), mask.cuda(), [(cap, ring.cuda(), off.cuda()), (f, None, None)])
    assert cuda_compact.LAUNCHES == 1
    want_ring, n_want = compact.compact_rows_plain(rows, mask, cap, out=ring.clone(), offset=off)
    want_fresh, _ = compact.compact_rows_plain(rows, mask, f)
    assert torch.equal(got_ring.cpu(), want_ring) and torch.equal(got_fresh.cpu(), want_fresh)
    assert int(n) == int(n_want)


def test_stream_on_card_matches_cpu(tmp_path):
    from slam_process_tpu_torch.parallel.streaming_device import (
        make_paths_spec, replay_log_device)
    from slam_process_tpu_torch.utils.synthetic import write_angle_table

    raw = synthetic_session_bytes(n_groups=5, frames_per_beam=8, baselines_per_group=9,
                                  junk_frac=0.05, seed=3, n_paths=3)
    spec = make_paths_spec(write_angle_table(tmp_path / "angles.xlsx"), s_step=8, grid_res=0.5)
    kernels = (cuda_decode, cuda_correct, cuda_sweep_sums, cuda_compact, cuda_tracker)
    for m in kernels:
        m.LAUNCHES = 0
    kw = dict(chunk_bytes=1 << 13, collect_filtered=True, collect_paths=spec)
    got = replay_log_device(raw, **kw)
    assert min(m.LAUNCHES for m in kernels) > 0
    want = replay_log_device(raw, device="cpu", **kw)
    for name in ("n_frames", "n_kept", "n_groups", "n_sweeps_closed", "overflow"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.filtered, want.filtered)
    np.testing.assert_array_equal(got.intensity().mean, want.intensity().mean)
    (paths, valid), (ref, ref_valid) = got.sweep_paths(), want.sweep_paths()
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_array_equal(got.sweep_times(), want.sweep_times())
    for field in paths._fields:
        if field == "power":
            np.testing.assert_allclose(paths.power, ref.power, rtol=2e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(paths, field), getattr(ref, field),
                                          err_msg=field)
    tracks, tracks_ref = got.path_tracks()[0], want.path_tracks()[0]
    for name in ("pos_aoa", "pos_aod", "observed", "created"):
        np.testing.assert_array_equal(getattr(tracks, name), getattr(tracks_ref, name))
    assert tracks.n_tracks == tracks_ref.n_tracks > 0


def test_path_tracks_default_launches_the_tracker_kernel(tmp_path):
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import to_hex_text, write_angle_table

    path = tmp_path / "multipath.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=5, frames_per_beam=8, baselines_per_group=9, junk_frac=0.05, seed=3,
        n_paths=3)))
    angles = write_angle_table(tmp_path / "angles.xlsx")
    s = Session.from_log(path)
    cuda_tracker.LAUNCHES = 0
    tracks, times, _ = s.path_tracks(angles, grid_res=0.5)
    assert cuda_tracker.LAUNCHES == 1
    want, want_times, _ = s.path_tracks(angles, engine="host", grid_res=0.5)
    np.testing.assert_array_equal(times, want_times)
    for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
        np.testing.assert_array_equal(getattr(tracks, name), getattr(want, name), err_msg=name)
    assert tracks.n_tracks == want.n_tracks > 0


K3_BOUNDS = {"vmin_vmax": (40_000.0, 200_000.0), "vmin_only": (90_000.0, None),
             "vmax_only": (None, 120_000.0), "vmin_below_min": (-5.0, None),
             "vmax_below_min": (None, -5.0)}


@pytest.mark.parametrize("bounds", sorted(K3_BOUNDS))
@pytest.mark.parametrize("shape", [(64, 64), (59, 61)])
def test_raster_kernel_bounds_match_plain(shape, bounds):
    """K3 with explicit vmin / vmax (``cli heatmap --vmin/--vmax``) against
    its plain version at S = 1 and 4, square and non-square, log and
    linear; a vmax below the data's minimum makes every log t NaN in both."""
    vmin, vmax = K3_BOUNDS[bounds]
    lut = torch.from_numpy(raster.colormap_lut()).cuda()
    taps = raster.blur_taps(1.0, "cuda")
    for s in (1, 4):
        gen = torch.Generator().manual_seed(s * 7 + shape[1])
        mats = torch.rand((s, *shape), generator=gen) * (1 << 18)
        mats[torch.rand((s, *shape), generator=gen) < 0.05] = float("nan")
        mats = mats.cuda()
        for use_log in (True, False):
            cuda_raster.LAUNCHES = 0
            got = cuda_raster.raster_tiles_cuda(mats, lut, taps, use_log, vmin, vmax)
            assert cuda_raster.LAUNCHES == 1
            assert_raster_matches(got, raster.raster_tiles_plain(mats, lut, taps, use_log,
                                                                 vmin, vmax))
            if bounds == "vmax_below_min" and use_log:
                assert bool(torch.isnan(got[1]).all())


def test_correct_from_parsed_xlsx_on_card(tmp_path):
    """``Session.correct()`` on the frames of a Parsed xlsx runs K2 on the
    card (twice past the default bounds) and equals the host engine on every
    row."""
    from slam_process_tpu_torch.io.schemas import write_parsed_table
    from slam_process_tpu_torch.ops.decode import decode_frames_np
    from slam_process_tpu_torch.pipeline.session import Session

    for kw, launches in ((dict(n_groups=4, frames_per_beam=3, baselines_per_group=9), 1),
                         (dict(n_groups=257, frames_per_beam=1, baselines_per_group=1), 2)):
        frames = decode_frames_np(synthetic_session_bytes(junk_frac=0.1, seed=4, **kw)).frames
        write_parsed_table(tmp_path / "parsed.xlsx", frames)
        s = Session.from_parsed_xlsx(tmp_path / "parsed.xlsx")
        cuda_correct.LAUNCHES = 0
        s.correct()
        assert cuda_correct.LAUNCHES == launches
        want = correct.correct_frames_np(s.frames)
        np.testing.assert_array_equal(s.corrected_bs, want.corrected_bs)
        np.testing.assert_array_equal(s.filtered, want.filtered)


def test_self_test_on_card():
    cuda_correct.LAUNCHES = 0
    assert correct.self_test(verbose=False, device="cuda")
    assert cuda_correct.LAUNCHES >= 5


def test_render_heatmap_on_card_matches_cpu(tmp_path):
    """``render_heatmap`` on the card (K3) against ``device="cpu"``: norm_t
    within 1e-4, LUT-bin flips under 0.1 %, on a non-square tile, with and
    without bounds; and the discard count equals the host decoder's."""
    from slam_process_tpu_torch.config import RenderConfig
    from slam_process_tpu_torch.ops.decode import decode_frames_np
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import (
        to_hex_text, with_flag_junk, write_angle_table)

    raw = with_flag_junk(session(3), n_bursts=30, cut=6, seed=3)
    path = tmp_path / "heat.txt"
    path.write_bytes(to_hex_text(raw))
    angles = write_angle_table(tmp_path / "angles.xlsx", unmapped=(1, 2, 60))
    s = Session.from_log(path, count_discards=True)
    assert s.n_discarded == decode_frames_np(raw).discarded > 0
    for cfg in (RenderConfig(), RenderConfig(use_log=False, vmin=50_000.0, vmax=150_000.0)):
        cuda_raster.LAUNCHES = 0
        got = s.render_heatmap(angles, render_cfg=cfg)
        assert cuda_raster.LAUNCHES == 1
        want = s.render_heatmap(angles, render_cfg=cfg, device="cpu")
        assert got.norm_t.shape == want.norm_t.shape == (61, 61)
        assert (np.isnan(got.norm_t) == np.isnan(want.norm_t)).all()
        fin = ~np.isnan(want.norm_t)
        assert np.abs(got.norm_t[fin] - want.norm_t[fin]).max() <= 1e-4
        flips = (np.clip((np.nan_to_num(got.norm_t) * 256).astype(int), 0, 255)
                 != np.clip((np.nan_to_num(want.norm_t) * 256).astype(int), 0, 255)).mean()
        assert flips < 1e-3
        np.testing.assert_allclose(got.blurred, want.blurred, rtol=1e-5, equal_nan=True)


@pytest.fixture(scope="module")
def estimator_session(tmp_path_factory):
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import to_hex_text, write_angle_table

    d = tmp_path_factory.mktemp("estimate")
    path = d / "mp.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=6, frames_per_beam=2, baselines_per_group=9, seed=1, n_paths=3)))
    return Session.from_log(path), write_angle_table(d / "angles.xlsx")


@pytest.mark.parametrize("name", ["nn_omp", "nn_omp_v1", "nn_omp_v14", "nn_omp_v15",
                                  "nn_omp_v16"])
def test_run_estimator_on_card_matches_cpu(estimator_session, name):
    """Each flavor at the full 886 x 886 grid on the card against
    ``device="cpu"``: the same paths (angles exact, power within rtol
    2e-4) and the same labels, and the NN-OMP fields lane for lane."""
    from slam_process_tpu_torch.models import registry
    from slam_process_tpu_torch.models.batch_estimation import flavor_config
    from slam_process_tpu_torch.models.dictionary import make_dictionary
    from slam_process_tpu_torch.models.nn_omp import run_nn_omp

    s, angles = estimator_session
    got = registry.run_estimator(name, s, angles)
    want = registry.run_estimator(name, s, angles, device="cpu")
    assert len(got) == len(want) > 0
    for c in ("AoA", "AoD"):
        np.testing.assert_array_equal(got[c], want[c])
    np.testing.assert_allclose(got["Power"], want["Power"], rtol=2e-4)
    assert got["PathType"] == want["PathType"]
    if name in ("nn_omp", "nn_omp_v1"):
        dict_cfg, cfg, log_t, keep_rule, stop_np = flavor_config(
            "v1-7" if name == "nn_omp" else "v1")
        matrix, ue, bs = registry.build_scene(s, angles, log_t)
        d = make_dictionary(ue, bs, dict_cfg)
        a, b = (run_nn_omp(d, matrix, cfg, keep_rule, stop_np, device=dev)
                for dev in ("cuda", "cpu"))
        for field in ("aoa_idx", "aod_idx", "n_iters", "valid", "aoa", "aod"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        np.testing.assert_allclose(a.power, b.power, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("flavor", ["v1-7", "v1"])
def test_estimate_sessions_on_card_matches_per_session_runs(estimator_session, tmp_path, flavor):
    from slam_process_tpu_torch.models import registry
    from slam_process_tpu_torch.models.batch_estimation import estimate_sessions, flavor_config
    from slam_process_tpu_torch.models.dictionary import make_dictionary
    from slam_process_tpu_torch.models.nn_omp import run_nn_omp
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import to_hex_text

    s, angles = estimator_session
    others = []
    for i, kw in enumerate([dict(n_groups=3, seed=11), dict(n_groups=9, seed=12)]):
        path = tmp_path / f"s{i}.txt"
        path.write_bytes(to_hex_text(synthetic_session_bytes(
            frames_per_beam=1, baselines_per_group=4, n_paths=3, **kw)))
        o = Session.from_log(path)
        f = o.filtered
        o.filtered = f[f[:, 0] >= 8 * (i + 1)]   # scenes of different shapes
        others.append(o)
    sessions = [s] + others
    got = estimate_sessions(sessions, angles, flavor)
    dict_cfg, cfg, log_t, keep_rule, stop_np = flavor_config(flavor)
    for g, sess in zip(got, sessions):
        matrix, ue, bs = registry.build_scene(sess, angles, log_t)
        want = run_nn_omp(make_dictionary(ue, bs, dict_cfg), matrix, cfg, keep_rule, stop_np)
        keep = want.valid if flavor == "v1" else slice(None)
        np.testing.assert_array_equal(g.valid, want.valid)
        for field in ("aoa_idx", "aod_idx"):
            np.testing.assert_array_equal(getattr(g, field)[keep], getattr(want, field)[keep])
        np.testing.assert_allclose(g.power[want.valid], want.power[want.valid], rtol=2e-4)


def test_rbf_background_on_card_matches_numpy(estimator_session):
    """The full 64 x 64 scene's 4,096-centre float64 solve on the card
    against numpy's, within 1e-6 of the heat's range."""
    from slam_process_tpu_torch.models import registry
    from slam_process_tpu_torch.ops.interp import rbf_interpolate_grid
    from slam_process_tpu_torch.render.estimation import rbf_background

    s, angles = estimator_session
    matrix, ue, bs = registry.build_scene(s, angles, True)
    assert matrix.shape == (64, 64)
    gx, gy, heat = rbf_background(matrix, ue, bs, smooth=0.1)
    want = rbf_interpolate_grid(bs, ue, matrix, gx, gy, smooth=0.1)
    assert np.abs(heat - want).max() <= 1e-6 * np.ptp(want)


def assert_rendered_close(got, want):
    """Two ``RenderedHeatmap`` of one grid, card against CPU: blurred
    bit-equal, norm_t within 1e-4, LUT-bin flips under 0.1 %."""
    assert got.norm_t.shape == want.norm_t.shape
    assert (np.isnan(got.blurred) == np.isnan(want.blurred)).all()
    np.testing.assert_array_equal(np.nan_to_num(got.blurred), np.nan_to_num(want.blurred))
    assert (np.isnan(got.norm_t) == np.isnan(want.norm_t)).all()
    fin = ~np.isnan(want.norm_t)
    assert fin.any() and np.abs(got.norm_t[fin] - want.norm_t[fin]).max() <= 1e-4
    flips = (np.clip((np.nan_to_num(got.norm_t) * 256).astype(int), 0, 255)
             != np.clip((np.nan_to_num(want.norm_t) * 256).astype(int), 0, 255)).mean()
    assert flips < 1e-3
    np.testing.assert_array_equal(got.aod_angles, want.aod_angles)


def stream_files(tmp_path):
    from slam_process_tpu_torch.utils.synthetic import to_hex_text, write_angle_table

    log = tmp_path / "live.txt"
    log.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=5, frames_per_beam=8, baselines_per_group=9, junk_frac=0.05, seed=3,
        n_paths=3)))
    return log, write_angle_table(tmp_path / "angles.xlsx")


def test_stream_render_on_card_matches_cpu(tmp_path):
    """``DeviceStreamingSession.render()`` launches K3 once on the card and
    equals the CPU stream's render; the host engine's render equals the
    CPU's."""
    from slam_process_tpu_torch.io import read_hex_log
    from slam_process_tpu_torch.io.angles import load_angle_lut
    from slam_process_tpu_torch.parallel.streaming import replay_log
    from slam_process_tpu_torch.parallel.streaming_device import replay_log_device

    log, angles = stream_files(tmp_path)
    raw, lut = read_hex_log(log), load_angle_lut(angles)
    s = replay_log_device(raw, chunk_bytes=1 << 13, collect_filtered=True)
    cuda_raster.LAUNCHES = 0
    got = s.render(lut)
    assert cuda_raster.LAUNCHES == 1
    want = replay_log_device(raw, chunk_bytes=1 << 13, device="cpu").render(lut)
    assert_rendered_close(got, want)
    host = replay_log(raw, chunk_bytes=1 << 13).render(lut)
    np.testing.assert_array_equal(host.norm_t, want.norm_t)


def test_replay_steps_on_card_match_cpu(tmp_path):
    """``replay``'s steps (the stream, ``render()``, the exports) on the card
    against ``--device cpu`` and the host engine: the xlsx sheet XML byte for
    byte, the stats equal; K1, K2, K3, K4, K5 and K6 launch."""
    import zipfile

    from slam_process_tpu_torch.io.angles import load_angle_lut
    from slam_process_tpu_torch.pipeline import cli

    log, angles = stream_files(tmp_path)
    kernels = (cuda_decode, cuda_correct, cuda_raster, cuda_sweep_sums, cuda_compact,
               cuda_tracker)
    out = {}
    for tag, extra in (("cuda", []), ("cpu", ["--device", "cpu"]),
                       ("host", ["--engine", "host"])):
        args = cli.build_parser().parse_args(
            ["replay", "--logs", str(log), "--mapping", str(angles), "--outdir",
             str(tmp_path / tag), "--paths", "--changes", "--chunk-bytes", "4096", *extra])
        args.outdir.mkdir()
        for m in kernels:
            m.LAUNCHES = 0
        name, s, seconds = cli.replay_stream(args, log)
        rendered = s.render(load_angle_lut(angles))
        stats = cli.replay_exports(args, s, name, seconds)
        stats.pop("frames_per_sec")
        if tag == "cuda":
            assert min(m.LAUNCHES for m in kernels) > 0, [m.LAUNCHES for m in kernels]
        out[tag] = (stats, rendered)
    for tag in ("cpu", "host"):
        assert out[tag][0] == out["cuda"][0]
        assert_rendered_close(out["cuda"][1], out[tag][1])
        with zipfile.ZipFile(tmp_path / "cuda" / "live_filtered.xlsx") as a, \
                zipfile.ZipFile(tmp_path / tag / "live_filtered.xlsx") as b:
            assert a.read("xl/worksheets/sheet1.xml") == b.read("xl/worksheets/sheet1.xml")


def test_watch_with_checkpoint_resume_on_card(tmp_path):
    """A ``watch`` on the card over a file that stops halfway, then a second
    watch resumed from its checkpoint after the file is finished (the
    first run's checkpoint is finalized, so the resume runs from a copy
    saved mid-stream): tables and events equal an uninterrupted watch of
    the finished file on the card and with ``--device cpu``."""
    import json
    import shutil

    from slam_process_tpu_torch.pipeline import cli

    log, angles = stream_files(tmp_path)
    text = log.read_bytes()

    def watch(tag, path, *extra):
        args = cli.build_parser().parse_args(
            ["watch", "--log", str(path), "--mapping", str(angles), "--outdir",
             str(tmp_path / tag), "--paths", "--changes", "--min-persist", "1", "--min-gone",
             "1", "--events", str(tmp_path / f"{tag}.jsonl"), "--poll-interval", "0.01",
             "--idle-timeout", "0.2", *extra])
        cli.check_watch_flags(args)
        w = cli.Watch(args)
        return w, args

    # Half the file, then a checkpoint taken before the finalize.
    (tmp_path / "half").mkdir()
    half = tmp_path / "half" / "live.txt"
    half.write_bytes(text[:len(text) // 2])
    w, args = watch("first", half, "--checkpoint", str(tmp_path / "first.ckpt"))
    finalize = w.session.finalize
    w.session.finalize = lambda: (w.save_checkpoint(), shutil.copy(
        tmp_path / "first.ckpt", tmp_path / "mid.ckpt"), shutil.copy(
        tmp_path / "first.jsonl", tmp_path / "resumed.jsonl"), finalize())
    w.run()
    shutil.copy(log, half)
    r, _ = watch("resumed", half, "--checkpoint", str(tmp_path / "mid.ckpt"))
    r.run()
    r.export()
    u, _ = watch("whole", log)
    u.run()
    u.export()
    c, _ = watch("cpu", log, "--device", "cpu")
    c.run()
    c.export()
    ev = {tag: [json.loads(ln) for ln in (tmp_path / f"{tag}.jsonl").read_text().splitlines()]
          for tag in ("resumed", "whole", "cpu")}
    assert ev["resumed"] == ev["whole"] and len(ev["whole"]) > 0
    assert [{k: v for k, v in e.items() if k != "power"} for e in ev["cpu"]] == [
        {k: v for k, v in e.items() if k != "power"} for e in ev["whole"]]
    np.testing.assert_allclose([e["power"] for e in ev["cpu"]],
                               [e["power"] for e in ev["whole"]], rtol=2e-4)
    for tag in ("resumed", "cpu"):
        assert r.session.n_frames == u.session.n_frames == c.session.n_frames
        np.testing.assert_array_equal(getattr(r if tag == "resumed" else c, "session").filtered,
                                      u.session.filtered)


# -- text ingest, pre-log scenes, SM-SIC and the dataset's per-sweep paths ------------


def fields_equal(a, b, fields=None):
    """Pipeline outputs equal field for field (floats bit for bit, NaN
    patterns equal)."""
    for name in fields or b._fields:
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            assert x is None, name
            continue
        x, y = x.cpu(), y.cpu()
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.is_floating_point():
            assert torch.equal(torch.isnan(x), torch.isnan(y)), name
            x, y = x.nan_to_num(0.0), y.nan_to_num(0.0)
        assert torch.equal(x, y), name


@pytest.mark.parametrize("layout", ["shipped", "crlf"])
def test_text_path_on_card_equals_byte_path_and_cpu(layout):
    from slam_process_tpu_torch.ops.tokenize import (
        prepare_text, stride3_offset, text_bucket, tokenize_stride3)
    from slam_process_tpu_torch.pipeline.device import run_session_from_text
    from slam_process_tpu_torch.utils.synthetic import to_hex_text

    raw = session(seed=8)
    text = to_hex_text(raw, layout)
    p = stride3_offset(text)
    body, n_text = prepare_text(text, p, text_bucket(len(text) - p))
    got = tokenize_stride3(torch.from_numpy(body).cuda(), n_text)
    want = tokenize_stride3(torch.from_numpy(body), n_text)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(got[2]) == (layout == "shipped")
    res = run_session_from_text(text)
    assert bool(res.tokenize_regular) == (layout == "shipped")
    assert int(res.n_tokens) == len(raw)
    fields_equal(res.out, run_session_on_device(raw))
    cpu = run_session_from_text(text, device="cpu")
    fields_equal(res.out, cpu.out, ("frames", "frame_valid", "n_frames", "corrected_bs", "keep",
                                    "n_kept", "counts", "mean_grid"))


def test_prelog_session_and_stream_on_card(tmp_path):
    from slam_process_tpu_torch.config import PipelineConfig, SceneConfig
    from slam_process_tpu_torch.ops.correct import correct_frames_np
    from slam_process_tpu_torch.ops.decode import decode_frames_np
    from slam_process_tpu_torch.ops.scene import intensity_grid_np
    from slam_process_tpu_torch.parallel.streaming_device import (
        DeviceStreamingSession, replay_log_device)

    log = SceneConfig(log_transform=True)
    raw = session(seed=9)
    f = correct_frames_np(decode_frames_np(raw).frames).filtered
    ref = intensity_grid_np(f[:, 0], f[:, 1], f[:, 2], cfg=log)
    out = run_session_on_device(raw, log_transform_scene=True)
    cpu = run_session_on_device(raw, device="cpu", log_transform_scene=True)
    fields_equal(out, cpu, ("frames", "frame_valid", "corrected_bs", "keep", "counts"))
    np.testing.assert_array_equal(out.counts.cpu().numpy(), ref.counts)
    mean = out.mean_grid.cpu().numpy()
    np.testing.assert_allclose(mean, ref.mean, rtol=1e-6, atol=0, equal_nan=True)
    fin = ~np.isnan(mean)           # one float32 ulp at most between the card and the CPU
    assert (np.abs(mean[fin] - cpu.mean_grid.numpy()[fin]) <= np.spacing(mean[fin])).all()
    cfg = PipelineConfig(scene=log)
    s = replay_log_device(raw, chunk_bytes=1 << 14, config=cfg, collect_filtered=True)
    np.testing.assert_array_equal(s.filtered, f)
    grid = s.intensity()
    np.testing.assert_array_equal(grid.counts, ref.counts)
    np.testing.assert_allclose(grid.mean, ref.mean, rtol=1e-6, atol=0, equal_nan=True)
    part = DeviceStreamingSession(cfg, chunk_bytes=1 << 14, collect_filtered=True)
    half = (len(raw) // (1 << 14) // 2) * (1 << 14)
    for off in range(0, half, 1 << 14):
        part.feed(raw[off:off + (1 << 14)])
    part.save_checkpoint(tmp_path / "prelog.ckpt")
    r = DeviceStreamingSession.restore(tmp_path / "prelog.ckpt")
    for off in range(half, len(raw), 1 << 14):
        r.feed(raw[off:off + (1 << 14)])
    r.finalize()
    np.testing.assert_array_equal(r.filtered, f)
    np.testing.assert_allclose(r.intensity().mean, grid.mean, rtol=1e-12, atol=0,
                               equal_nan=True)


def test_sm_sic_and_dataset_paths_on_card(tmp_path):
    from slam_process_tpu_torch.models.registry import run_estimator
    from slam_process_tpu_torch.models.sm_sic import SmSicPaths
    from slam_process_tpu_torch.parallel.streaming_device import (
        make_paths_spec, replay_log_device)
    from slam_process_tpu_torch.pipeline.session import Session, sweep_paths_dataset
    from slam_process_tpu_torch.utils.synthetic import to_hex_text, write_angle_table

    angles = write_angle_table(tmp_path / "angles.xlsx")
    sessions, raws = [], []
    for i in range(3):
        raw = synthetic_session_bytes(n_groups=4, frames_per_beam=3, baselines_per_group=9,
                                      junk_frac=0.02, seed=40 + i, n_paths=3)
        path = tmp_path / f"s{i}.txt"
        path.write_bytes(to_hex_text(raw, "shipped"))
        sessions.append(Session.from_log(path))
        raws.append(raw)
    s = sessions[0]
    card = run_estimator("sm_sic", s, angles)
    for other in (run_estimator("sm_sic", s, angles, engine="host"),
                  run_estimator("sm_sic", s, angles, device="cpu")):
        assert list(card["type"]) == list(other["type"]) and len(card) > 0
        np.testing.assert_array_equal(card["aoa"], other["aoa"])
        np.testing.assert_array_equal(card["aod"], other["aod"])
        np.testing.assert_allclose(card["metric"], other["metric"], rtol=1e-6)
    paths, valid = s.sweep_paths(angles, estimator="sm_sic")
    want, want_valid = s.sweep_paths(angles, estimator="sm_sic", device="cpu")
    assert isinstance(paths, SmSicPaths)
    np.testing.assert_array_equal(valid, want_valid)
    for field in ("aoa", "aod", "valid", "is_los"):
        np.testing.assert_array_equal(getattr(paths, field), getattr(want, field))
    np.testing.assert_allclose(paths.metric, want.metric, rtol=1e-6)
    for est in ("nn_omp", "sm_sic"):
        for sess, (p, v) in zip(sessions, sweep_paths_dataset(sessions, angles, estimator=est)):
            q, w = sess.sweep_paths(angles, estimator=est)
            np.testing.assert_array_equal(v, w)
            for a, b in zip(p, q):
                np.testing.assert_array_equal(a, b)
    spec = make_paths_spec(angles, estimator="sm_sic", s_step=8)
    ids = (spec[0].ue_ids, spec[0].bs_ids)
    stream = replay_log_device(raws[0], chunk_bytes=1 << 14, collect_paths=spec)
    (sp, sv), (tr, times, _) = stream.sweep_paths(), stream.path_tracks()
    op, ov = s.sweep_paths(angles, estimator="sm_sic", beam_ids=ids)
    ot = s.path_tracks(angles, estimator="sm_sic", beam_ids=ids)
    np.testing.assert_array_equal(sv, ov)
    for a, b in zip(sp, op):
        np.testing.assert_array_equal(a, b)
    for f in ("pos_aoa", "pos_aod", "power", "observed", "created"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(ot[0], f))
    np.testing.assert_array_equal(times, ot[1])


SLICE_ESTIMATORS = ("svd", "omp_dense", "lasso_refine", "peak_picking", "fusion",
                    "nn_omp_v13", "geometric")


@pytest.fixture(scope="module")
def slice_scene(tmp_path_factory):
    """A dense multipath session decoded and corrected on the card (K1, K2)
    and the angle table."""
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import to_hex_text, write_angle_table

    d = tmp_path_factory.mktemp("slice")
    path = d / "mp.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=2, frames_per_beam=40, baselines_per_group=5, junk_frac=0.02, seed=3,
        n_paths=3)))
    k1, k2 = cuda_decode.LAUNCHES, cuda_correct.LAUNCHES
    s = Session.from_log(path)
    assert cuda_decode.LAUNCHES > k1 and cuda_correct.LAUNCHES > k2
    return s, write_angle_table(d / "angles.xlsx", unmapped=(40,))


@pytest.mark.parametrize("name", SLICE_ESTIMATORS)
def test_estimator_families_on_card_match_cpu_and_host(slice_scene, name):
    """Each family of the eleventh slice on the card against ``device="cpu"``
    and the host engine: the same rows, labels and cells, values within
    the family's bound (``chip_smoke.estimator_tables_differ``'s); geometric
    warns as the JAX package does and runs its host body."""
    import warnings

    from slam_process_tpu_torch.models.registry import run_estimator

    s, angles = slice_scene
    kw = {"grid_res": 2.0} if name == "lasso_refine" else {}
    if name == "geometric":
        with pytest.warns(RuntimeWarning, match="no device engine"):
            card = run_estimator(name, s, angles, **kw)
    else:
        card = run_estimator(name, s, angles, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cpu = run_estimator(name, s, angles, device="cpu", **kw)
    host = run_estimator(name, s, angles, engine="host", **kw)
    assert len(card) > 0
    if name in ("peak_picking", "geometric"):
        for other in (cpu, host):
            assert card.to_string(index=False) == other.to_string(index=False)
        return
    type_col = {"fusion": "type", "nn_omp_v13": "PathType"}.get(name, "Type")
    cells = ("aoa", "aod") if name == "fusion" else ("AoA", "AoD")
    for other, vs in ((cpu, "cpu"), (host, "host")):
        assert len(card) == len(other) and list(card[type_col]) == list(other[type_col])
        for c in cells:
            g, w = np.asarray(card[c]), np.asarray(other[c])
            if name == "nn_omp_v13":
                np.testing.assert_array_equal(g.astype(np.float32), w.astype(np.float32))
            elif name == "lasso_refine" and vs == "host":
                np.testing.assert_allclose(g, w, rtol=0, atol=0.11)
            else:
                np.testing.assert_array_equal(g, w)
        if name == "fusion":
            los = np.asarray(other["type"]) == "LoS"
            np.testing.assert_allclose(card["metric"][~los], other["metric"][~los], rtol=1e-9)
            np.testing.assert_allclose(card["metric"][los], other["metric"][los], rtol=2e-4)
            continue
        rtol = {"svd": 1e-9, "omp_dense": 1e-6, "nn_omp_v13": 2e-4,
                "lasso_refine": 1e-9 if vs == "cpu" else 2e-3}[name]
        for c in (("Power", "SingularValue") if name == "svd" else ("Power",)):
            np.testing.assert_allclose(card[c], other[c], rtol=rtol, atol=0)


def test_stream_axis_kernels_match_plain():
    gen = torch.Generator().manual_seed(12)
    dev = torch.device("cuda")
    raws = [synthetic_session_bytes(n_groups=2 + i, frames_per_beam=2, baselines_per_group=5,
                                    junk_frac=0.2, seed=60 + i) for i in range(4)]
    width = max(len(r) for r in raws) + 7
    b = torch.zeros((4, width), dtype=torch.uint8)
    for i, r in enumerate(raws):
        b[i, :len(r)] = torch.from_numpy(r)
    lim = torch.tensor([width, len(raws[1]) - 30, 11, 0], dtype=torch.int64)
    for rep in range(2):
        got = cuda_decode.decode_rows_streams_cuda(b.to(dev), lim.to(dev), 0xCC, 0x33)
        for g, w in zip(got, decode.decode_rows_streams_plain(b, n_valid=lim)):
            assert torch.equal(g.cpu(), w)

    rows = torch.randint(0, 1000, (5, 30_000, 4), generator=gen, dtype=torch.int32)
    mask = torch.rand((5, 30_000), generator=gen) < 0.3
    ring = torch.randint(0, 9, (5, 12_000, 4), generator=gen, dtype=torch.int32)
    offs = torch.tensor([0, 5, 11_000, 12_000, 3_000], dtype=torch.int32)

    def dests(d):
        return [(12_000, ring.clone().to(d), offs.to(d)), (30_000, None, None)]

    got_o, got_n = cuda_compact.compact_rows_streams_cuda(rows.to(dev), mask.to(dev), dests(dev))
    want_o, want_n = compact.compact_rows_streams_plain(rows, mask, dests("cpu"))
    for g, w in zip((*got_o, got_n), (*want_o, want_n)):
        assert torch.equal(g.cpu(), w)

    s1, k_n, t_n = 65, 3, 8
    lanes = [torch.rand((6, s1, k_n), generator=gen) * 90 - 45 for _ in range(3)]
    val = torch.rand((6, s1, k_n), generator=gen) < 0.7
    m_eff = torch.tensor([0, 1, 33, 64, 65, 80], dtype=torch.int32)
    count = torch.tensor([0, 3, 8, 1, 0, 5], dtype=torch.int32)
    created = torch.arange(t_n)[None] < count[:, None]
    pos = torch.rand((6, t_n, 2), generator=gen) * 90 - 45
    args = (*lanes, val, m_eff, pos, created, count)
    got = cuda_tracker.track_block_streams_cuda(*(x.to(dev) for x in args), 10.0)
    for g, w in zip(got, tracker.track_block_streams_plain(*args, 10.0)):
        assert torch.equal(g.cpu(), w)

    # K2 and K4 flattened: one call for the four sessions against four.
    frames, valid, _ = decode.decode_rows_streams(b.to(dev))
    gid, packed, _ = correct.baseline_table(frames, valid, 8, 16)
    kw = dict(bmax=16, cycle=61_000, tol=500)
    flat = cuda_correct.correct_verdicts_cuda(gid.reshape(-1).contiguous(),
                                              frames[..., 4].reshape(-1).contiguous(), packed,
                                              **kw)
    for i in range(4):
        one = cuda_correct.correct_verdicts_cuda((gid[i] - 8 * i).contiguous(),
                                                 frames[i, :, 4].contiguous(),
                                                 packed[8 * i:8 * i + 8].contiguous(), **kw)
        for g, w in zip(flat, one):
            assert torch.equal(g.view(4, -1)[i], w)
    p = torch.randint(-1, 9 * 64, (4, 5_000), generator=gen, dtype=torch.int32).sort(dim=1)[0]
    bs = torch.randint(0, 64, (4, 5_000), generator=gen, dtype=torch.int32)
    rss = torch.randint(0, 1 << 18, (4, 5_000), generator=gen, dtype=torch.int32)
    flat_p = torch.where(p >= 0, p + (torch.arange(4, dtype=torch.int32) * 9 * 64)[:, None], -1)
    sums, counts = cuda_sweep_sums.sweep_sums_cuda(*(x.reshape(-1).contiguous().to(dev) for x in (
        flat_p, bs, rss)), 36)
    for i in range(4):
        s_i, c_i = cuda_sweep_sums.sweep_sums_cuda(p[i].to(dev), bs[i].to(dev), rss[i].to(dev), 9)
        assert torch.equal(sums[9 * i:9 * i + 9], s_i) and torch.equal(counts[9 * i:9 * i + 9], c_i)


def test_batch_on_card_matches_per_session_and_cpu():
    from slam_process_tpu_torch.parallel import batch

    raws = [synthetic_session_bytes(n_groups=3 + i, frames_per_beam=3, baselines_per_group=6,
                                    junk_frac=0.05, seed=70 + i) for i in range(4)]
    from slam_process_tpu_torch.pipeline.device import bucket_size

    groups = len({bucket_size(len(r), 1 << 13) for r in raws})
    assert groups >= 2
    for k in (cuda_decode, cuda_correct, cuda_raster):
        k.LAUNCHES = 0
    vmap = batch.run_dataset(None, raws, quantum=1 << 13)
    assert [k.LAUNCHES for k in (cuda_decode, cuda_correct, cuda_raster)] == [groups] * 3
    scan = batch.run_dataset(None, raws, quantum=1 << 13, session_axis="scan")
    cpu = batch.run_dataset(None, raws, quantum=1 << 13, device="cpu")
    for i, r in enumerate(raws):
        one = run_session_on_device(r)
        for f in batch.SessionSummaryOut._fields:
            want = getattr(one, f).cpu().numpy()
            for got in (vmap[i], scan[i]):
                assert getattr(got, f).tobytes() == want.tobytes(), f
        for f in ("n_frames", "n_kept", "counts", "mean_grid"):
            np.testing.assert_array_equal(getattr(vmap[i], f), getattr(cpu[i], f))
        fin = np.isfinite(cpu[i].norm_t)
        np.testing.assert_allclose(vmap[i].norm_t[fin], cpu[i].norm_t[fin], atol=1e-4)


def test_multi_stream_on_card_matches_single_streams_and_cpu(tmp_path):
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import write_angle_table

    spec = sd.make_paths_spec(write_angle_table(tmp_path / "angles.xlsx"), s_step=8,
                              grid_res=1.0)
    raws = [synthetic_session_bytes(n_groups=3 + i, frames_per_beam=4, baselines_per_group=6,
                                    junk_frac=0.05, seed=80 + i, n_paths=3) for i in range(3)]
    chunk, step, ecap = 1 << 13, 20_000, 1 << 14

    def multi(device):
        ms = sd.MultiStreamingSession(3, chunk_bytes=chunk, collect_paths=spec,
                                      emit_capacity=ecap, device=device)
        for off in range(0, max(len(r) for r in raws), step):
            ms.feed([r[off:off + step] for r in raws])
        ms.finalize_streams([1])
        ms.finalize()
        return ms

    card, cpu = multi("cuda"), multi("cpu")
    for i, r in enumerate(raws):
        s = sd.DeviceStreamingSession(chunk_bytes=chunk, collect_paths=spec,
                                      collect_filtered=True, emit_capacity=ecap)
        for off in range(0, len(r), step):
            s.feed(r[off:off + step])
        s.finalize()
        nf, nk, ng, sums, counts, _ = card.results()
        assert (nf[i], nk[i], ng[i]) == (s.n_frames, s.n_kept, s.n_groups)
        np.testing.assert_array_equal(sums[i], s._state.sums.cpu().numpy())
        np.testing.assert_array_equal(counts[i], s._state.counts.cpu().numpy())
        np.testing.assert_array_equal(card.stream_filtered(i), s.filtered)
        np.testing.assert_array_equal(card.stream_filtered(i), cpu.stream_filtered(i))
        (pa, va), (pb, vb), (pc, vc) = card.stream_paths(i), s.sweep_paths(), cpu.stream_paths(i)
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(va, vc)
        for f in pa._fields:
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))
            if f == "power":
                np.testing.assert_allclose(getattr(pa, f), getattr(pc, f), rtol=2e-4, atol=1e-6)
            else:
                np.testing.assert_array_equal(getattr(pa, f), getattr(pc, f))
        ta, tb = card.stream_tracks(i)[0], s.path_tracks()[0]
        for f in ("pos_aoa", "pos_aod", "power", "observed", "created"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))


def card_mesh(shape, devices=None):
    from slam_process_tpu_torch.parallel.mesh import make_mesh

    n = int(np.prod(shape))
    return make_mesh(shape, devices=devices or [torch.device("cuda", 0)] * n)


def same_nested(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_nested(x, y) for x, y in zip(a, b))
    return a == b


def test_mesh_forms_on_card_equal_mesh_none(tmp_path):
    """A (2, 2) mesh whose positions repeat cuda:0: the batch, the
    multi-stream session (three streams padded to four, a ragged finalize)
    and ``sweep_paths_dataset`` equal ``mesh=None`` on the card, every
    field, floats bitwise; every kernel of those paths launches."""
    from slam_process_tpu_torch.parallel import batch
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.pipeline.session import Session, sweep_paths_dataset
    from slam_process_tpu_torch.utils.synthetic import to_hex_text, write_angle_table

    mesh = card_mesh((2, 2))
    raws = [synthetic_session_bytes(n_groups=3 + i, frames_per_beam=3, baselines_per_group=6,
                                    junk_frac=0.05, seed=90 + i, n_paths=3) for i in range(3)]
    kernels = (cuda_decode, cuda_correct, cuda_raster, cuda_sweep_sums, cuda_compact,
               cuda_tracker)
    for k in kernels:
        k.LAUNCHES = 0
    got = batch.run_dataset(mesh, raws, quantum=1 << 13)
    assert same_nested(got, batch.run_dataset(None, raws, quantum=1 << 13))

    angles = write_angle_table(tmp_path / "angles.xlsx")
    spec = sd.make_paths_spec(angles, s_step=8, grid_res=1.0)

    def streams(m):
        ms = sd.MultiStreamingSession(3, chunk_bytes=1 << 13, collect_paths=spec,
                                      emit_capacity=1 << 14, mesh=m)
        for off in range(0, max(len(r) for r in raws), 20_000):
            ms.feed([r[off:off + 20_000] for r in raws])
        ms.finalize_streams([1])
        ms.finalize()
        return (ms.results(), [(ms.stream_filtered(i), ms.stream_paths(i), ms.stream_tracks(i))
                               for i in range(3)])

    assert same_nested(streams(mesh), streams(None))
    sessions = []
    for i, r in enumerate(raws):
        (tmp_path / f"s{i}.txt").write_bytes(to_hex_text(r))
        sessions.append(Session.from_log(tmp_path / f"s{i}.txt"))
    assert same_nested(sweep_paths_dataset(sessions, angles, mesh=mesh),
                       sweep_paths_dataset(sessions, angles))
    assert min(k.LAUNCHES for k in kernels) > 0


def test_mesh_shard_on_a_second_card():
    """A shard on cuda:1 finds its own scratch, LUT and shared-memory
    opt-in: run_dataset over (2, 1) on cuda:0 and cuda:1 equals mesh=None."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (this machine has one)")
    from slam_process_tpu_torch.parallel import batch

    raws = [synthetic_session_bytes(n_groups=3, frames_per_beam=3, baselines_per_group=6,
                                    seed=95 + i) for i in range(4)]
    mesh = card_mesh((2, 1), [torch.device("cuda", 0), torch.device("cuda", 1)])
    assert same_nested(batch.run_dataset(mesh, raws), batch.run_dataset(None, raws))


def test_measure_device_time_on_card(tmp_path):
    """Each run's device seconds come from its own activities, by
    correlation id: a product's kernels in every run, the runs' sum within
    the trace's op total, the kept trace readable by
    ``module_device_times``."""
    from slam_process_tpu_torch.utils.device_timing import (
        RUN_RANGE, measure_device_time, module_device_times, op_device_times)

    a = torch.randn(2048, 2048, device="cuda")
    seen = []

    def call(i):
        seen.append(i)
        return (a @ a).sum()

    call(-1)
    torch.cuda.synchronize()
    seen.clear()
    t = measure_device_time(call, n=3, trace_dir=tmp_path)
    assert seen == [0, 1, 2] and len(t.runs) == 3 and min(t.runs) > 0
    assert t.module == "<all>" and len(t.all_modules) >= 2
    assert module_device_times(tmp_path)[RUN_RANGE] == pytest.approx(t.runs)
    assert sum(op_device_times(tmp_path).values()) >= t.total * (1 - 1e-9)
    top = max(t.all_modules, key=lambda k: sum(t.all_modules[k]))
    only = measure_device_time(call, n=2, module=top[:12])
    assert len(only.runs) == 2 and min(only.runs) > 0
    with pytest.raises(RuntimeError, match="no device activity"):
        measure_device_time(lambda i: None, n=2)


def small_packed(seed=31):
    """N scenes of planted atoms, each with its own dictionary (the
    port's ``make_dictionary``), packed with heavy padding."""
    from slam_process_tpu_torch.config import DictionaryConfig
    from slam_process_tpu_torch.models.batch_estimation import pack_scenes
    from slam_process_tpu_torch.models.dictionary import make_dictionary

    rng = np.random.default_rng(seed)
    mats, dicts = [], []
    for u, b, span in [(6, 9, 20.0), (16, 4, 55.0), (10, 10, 8.0), (12, 14, 30.0)]:
        d = make_dictionary(np.sort(rng.uniform(-span, span, u)),
                            np.sort(rng.uniform(-span, span, b)),
                            DictionaryConfig(grid_res=0.5, beam_width=1.4, grid_kind="linspace"))
        m = rng.random((u, b)) * 0.1
        for _ in range(4):
            m += rng.uniform(0.5, 2.0) * np.outer(d.phi_rx[:, rng.integers(len(d.aoa_grid))],
                                                  d.phi_tx[:, rng.integers(len(d.aod_grid))])
        mats.append(m)
        dicts.append(d)
    return pack_scenes(mats, dicts)


def assert_paths_equal(got, want, rtol=2e-4):
    for field in ("aoa_idx", "aod_idx", "n_iters", "valid", "aoa", "aod"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(np.asarray(got.power), np.asarray(want.power), rtol=rtol,
                               atol=1e-6)


def cpu_paths(paths):
    return type(paths)(*(x.cpu() for x in paths))


@pytest.mark.parametrize("flavor", ["v1-7", "v1"])
def test_est_forms_on_card_match_vmap_and_cpu(flavor):
    """``_batched_nn_omp`` "vmap" and "gram" and ``nn_omp_sessions_device``
    on one packed input on the card: each equal to "vmap" (indices,
    n_iters, valid; power within rtol 2e-4) and to its own CPU run."""
    from slam_process_tpu_torch.config import OmpConfig
    from slam_process_tpu_torch.models.batch_estimation import (
        _batched_nn_omp, flavor_config, nn_omp_sessions_device, packed_to_device)

    _, cfg, _, keep, stop = flavor_config(flavor)
    cfg = OmpConfig(max_paths=6, min_power_ratio=cfg.min_power_ratio)
    packed = small_packed()
    p = packed_to_device(packed, torch.device("cuda"))
    vmap = _batched_nn_omp(p, cfg, keep, stop)
    gram = _batched_nn_omp(p, cfg, keep, stop, form="gram")
    each = nn_omp_sessions_device(p, cfg, keep, stop)
    assert vmap.power.is_cuda and gram.power.is_cuda and each[0].power.is_cuda
    vmap, gram = cpu_paths(vmap), cpu_paths(gram)
    assert_paths_equal(gram, vmap)
    for i, e in enumerate(each):
        assert_paths_equal(cpu_paths(e), type(vmap)(*(x[i] for x in vmap)))
    for form, got in (("vmap", vmap), ("gram", gram)):
        assert_paths_equal(got, _batched_nn_omp(packed, cfg, keep, stop, form=form,
                                                device="cpu"))


def test_nn_omp_batch_on_card_matches_gram_and_cpu(tmp_path):
    """``nn_omp_batch`` over sweeps of one session's shared dictionary on
    the card equals ``nn_omp_gram_batch`` on the same sweeps and its CPU
    run (per-sweep config: K = 3, keep "positive", no nonpositive stop)."""
    from slam_process_tpu_torch.models.nn_omp import nn_omp_batch, nn_omp_gram_batch
    from slam_process_tpu_torch.models.sweep_estimation import _fill_per_sweep
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import to_hex_text, write_angle_table

    (tmp_path / "mp.txt").write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=6, frames_per_beam=2, baselines_per_group=9, seed=1, n_paths=3)))
    angles = write_angle_table(tmp_path / "angles.xlsx")
    s = Session.from_log(tmp_path / "mp.txt")
    sub, d, est_key, _ = s._sweep_estimation_inputs(angles, "nn_omp", None, torch.device("cuda"))
    _, cfg, keep, stop = est_key
    filled, _ = _fill_per_sweep(sub)
    args = (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid, filled, cfg, keep, stop)
    chain = cpu_paths(nn_omp_batch(*args))
    assert_paths_equal(chain, cpu_paths(nn_omp_gram_batch(*args)))
    assert_paths_equal(chain, nn_omp_batch(*(x.cpu() if torch.is_tensor(x) else x
                                             for x in args)))


def test_detect_scene_changes_on_card_bit_equal_to_np(estimator_session):
    """The scene change detector on the card's K6 tracks equals
    ``detect_scene_changes_np`` on the same tracks read back, bit for bit."""
    from slam_process_tpu_torch.models.change_detection import (
        detect_scene_changes, detect_scene_changes_np)
    from slam_process_tpu_torch.models.sweep_estimation import path_power
    from slam_process_tpu_torch.models.tracking import Tracks, track_paths

    s, angles = estimator_session
    paths, sweep_valid = s.sweep_paths(angles, grid_res=1.0)
    valid = np.asarray(paths.valid, bool) & sweep_valid[:, None]
    t = track_paths(*(torch.from_numpy(np.ascontiguousarray(x)).cuda()
                      for x in (paths.aoa, paths.aod, path_power(paths), valid)))
    for kw in (dict(), dict(min_persist=1, min_gone=1, jump_deg=0.5)):
        got = detect_scene_changes(t, **kw)
        assert all(x.is_cuda for x in got)
        want = detect_scene_changes_np(Tracks(*(x.cpu().numpy() for x in t[:5]),
                                              int(t.n_tracks)), **kw)
        for g, w in zip(got, want):
            assert g.cpu().numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.cpu().numpy(), w)


# -- the fifteenth slice: the compiled programs as CUDA graphs -------------------------------


def eager_windows(s):
    """``s`` with every window run by the eager body, ``_WindowRound._round``:
    the graphs' comparator."""
    from slam_process_tpu_torch.parallel import streaming_device as sd

    def step(piece, n_bytes):
        s._load_window(piece, n_bytes)
        s._round(sd._map_state(s._state, sd._lift), *s._window_inputs())

    s._step = step
    return s


def feed_stream(s, raw, chunk, stop=None):
    for off in range(0, len(raw) if stop is None else stop, chunk):
        s.feed(raw[off:off + chunk])
    return s


def states_equal(a, b):
    """Two streams' whole state equal, tensor for tensor, bit for bit."""
    from slam_process_tpu_torch.parallel import streaming_device as sd

    la, lb = sd._leaves(a._state), sd._leaves(b._state)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), i


def test_session_graph_equals_eager_body_alternating():
    """Two sessions of one bucket, alternated: every captured call equals the
    eager body bit for bit (a stale static input would show), counts its
    replays' launches, and returns outputs the next replay leaves alone."""
    from slam_process_tpu_torch.pipeline.device import (
        bucket_size, compiled_session_pipeline, device_lut, pad_bytes, session_pipeline)

    raws = [session(seed=21), session(seed=22, n_groups=9)]
    n = bucket_size(max(len(r) for r in raws))
    assert all(bucket_size(len(r)) == n for r in raws)
    lut = device_lut(torch.device("cuda"))
    padded = [torch.from_numpy(pad_bytes(r, n)).cuda() for r in raws]
    fn = compiled_session_pipeline(n, device="cuda")
    fn(padded[0], lut)                                  # captured here, if not before
    replays = fn.runner.replays
    kernels = (cuda_decode, cuda_correct, cuda_raster)
    outs = []
    for i in (0, 1, 0, 1, 1, 0):
        before = [m.LAUNCHES for m in kernels]
        got = fn(padded[i], lut)
        assert [m.LAUNCHES - b for m, b in zip(kernels, before)] == [1, 1, 1]
        fields_equal(got, session_pipeline(padded[i], lut))
        outs.append((i, got, [x.clone() for x in got if x is not None]))
    assert fn.runner.replays == replays + 6
    assert fn.runner.pool_bytes > 0 and fn.runner.capture_ms > 0
    for i, got, kept in outs:
        for x, y in zip([x for x in got if x is not None], kept):
            assert torch.equal(x.nan_to_num(), y.nan_to_num())
    assert not torch.equal(outs[0][1].frames, outs[1][1].frames)
    fields_equal(run_session_on_device(raws[1]), session_pipeline(padded[1], lut))


@pytest.mark.parametrize("log_transform_scene", [False, True])
def test_text_graph_equals_eager_body(log_transform_scene):
    """The text path's graph against ``session_pipeline_from_text`` for two
    body lengths of one bucket (the length is a device scalar the graph
    reads); the pre-log scene within one float32 ulp (float64 atomics)."""
    from slam_process_tpu_torch.ops.tokenize import prepare_text, stride3_offset, text_bucket
    from slam_process_tpu_torch.pipeline.device import (
        compiled_text_session_pipeline, device_lut, session_pipeline_from_text)
    from slam_process_tpu_torch.utils.synthetic import to_hex_text

    lut = device_lut(torch.device("cuda"))
    texts = [to_hex_text(session(seed=s, n_groups=g), "shipped") for s, g in ((23, 6), (24, 8))]
    m = max(text_bucket(len(t) - stride3_offset(t)) for t in texts)
    fn = compiled_text_session_pipeline(m, device="cuda", log_transform_scene=log_transform_scene)
    replays = None
    for t in texts * 2:
        body, n_text = prepare_text(t, stride3_offset(t), m)
        body = torch.from_numpy(body).cuda()
        got = fn(body, n_text, lut)
        want = session_pipeline_from_text(body, n_text, lut,
                                          log_transform_scene=log_transform_scene)
        assert bool(got.tokenize_regular) and int(got.n_tokens) == int(want.n_tokens)
        exact = [f for f in got.out._fields if f not in ("mean_grid", "rgba", "blurred",
                                                          "norm_t")]
        fields_equal(got.out, want.out, exact if log_transform_scene else None)
        if log_transform_scene:
            a, b = got.out.mean_grid.cpu().numpy(), want.out.mean_grid.cpu().numpy()
            assert np.array_equal(np.isnan(a), np.isnan(b))
            fin = ~np.isnan(b)
            assert (np.abs(a[fin].astype(np.float64) - b[fin])
                    <= np.spacing(np.abs(b[fin]))).all()
        replays = fn.runner.replays if replays is None else replays
    assert fn.runner.replays == replays + 3


@pytest.mark.parametrize("case", ["live_64KiB", "straddle_16KiB", "replay_1MiB_partial_last"])
def test_stream_graph_equals_eager_body(case):
    """The window graph against the eager round on the card: the whole state
    bit for bit after the feed and after the flush."""
    from slam_process_tpu_torch.parallel import streaming_device as sd

    if case == "replay_1MiB_partial_last":
        raw = np.concatenate([session(seed=30 + i, n_groups=20, frames_per_beam=40)
                              for i in range(3)])
        chunk, kw = 1 << 20, dict(collect_filtered=True, emit_capacity=len(raw) // 11 + 1)
        assert len(raw) % chunk
    else:
        raw = session(seed=25, n_groups=24, frames_per_beam=20)
        chunk = 1 << 16 if case == "live_64KiB" else 1 << 14
        kw = dict(collect_filtered=True)
    got = feed_stream(sd.DeviceStreamingSession(chunk_bytes=chunk, device="cuda", **kw), raw,
                      chunk)
    want = feed_stream(eager_windows(sd.DeviceStreamingSession(chunk_bytes=chunk,
                                                               device="cuda", **kw)), raw, chunk)
    assert got._graph is not None and got._graph.replays > 0 and want._graph is None
    states_equal(got, want)
    got.finalize()
    want.finalize()
    states_equal(got, want)
    np.testing.assert_array_equal(got.filtered, want.filtered)


def test_stream_graph_recaptures_after_the_ring_grows():
    from slam_process_tpu_torch.parallel import streaming_device as sd

    raw = np.concatenate([session(seed=40 + i) for i in range(3)])

    def small_ring(s):
        s._ecap = 1 << 10                 # a small ring, so that it must grow
        s._state.emit_buf = torch.zeros((s._ecap, 4), dtype=torch.int32, device="cuda")
        return s

    got = small_ring(sd.DeviceStreamingSession(chunk_bytes=1 << 13, collect_filtered=True,
                                               device="cuda"))
    runners = []
    for off in range(0, len(raw), 5_000):
        got.feed(raw[off:off + 5_000])
        if got._graph is not None and got._graph not in runners:
            runners.append(got._graph)
    want = feed_stream(eager_windows(small_ring(sd.DeviceStreamingSession(
        chunk_bytes=1 << 13, collect_filtered=True, device="cuda"))), raw, 5_000)
    assert got._ecap == 1 << 18 and len(runners) == 2
    states_equal(got, want)
    got.finalize()
    want.finalize()
    np.testing.assert_array_equal(got.filtered, want.filtered)


def test_stream_graph_after_a_checkpoint_resume(tmp_path):
    from slam_process_tpu_torch.parallel import streaming_device as sd

    raw = session(seed=45, n_groups=12, frames_per_beam=10)
    chunk, half = 1 << 13, (len(raw) // 2 // (1 << 13)) * (1 << 13)
    part = feed_stream(sd.DeviceStreamingSession(chunk_bytes=chunk, collect_filtered=True,
                                                 device="cuda"), raw, chunk, stop=half)
    part.save_checkpoint(tmp_path / "s.ckpt")
    resumed = sd.DeviceStreamingSession.restore(tmp_path / "s.ckpt", device="cuda")
    assert resumed._graph is None
    for off in range(half, len(raw), chunk):
        resumed.feed(raw[off:off + chunk])
    assert resumed._graph is not None and resumed._graph.replays > 0
    whole = feed_stream(eager_windows(sd.DeviceStreamingSession(
        chunk_bytes=chunk, collect_filtered=True, device="cuda")), raw, chunk)
    states_equal(resumed, whole)


def test_capture_before_the_lazy_build_and_scratch():
    """A program captured in a process whose kernel library, function
    pointers, raster opt-in and scratch words were never made: its warm-up
    makes them, outside the capture.  Scratch made under a capture raises,
    and a capture that raises leaves no graph behind."""
    from slam_process_tpu_torch.ops import _build
    from slam_process_tpu_torch.pipeline.device import (
        compiled_session_pipeline, device_lut, pad_bytes, session_pipeline)
    from slam_process_tpu_torch.utils.graphs import GraphRunner

    for fn in (_build.library, cuda_decode._fn, cuda_decode._fn_streams, cuda_correct._fn,
               cuda_raster._fn, cuda_raster._ready):
        fn.cache_clear()
    _build._SCRATCH.clear()
    raw = session(seed=46)
    n = 3 << 16                                        # a bucket no other test uses
    padded = torch.from_numpy(pad_bytes(raw, n)).cuda()
    lut = device_lut(torch.device("cuda"))
    fn = compiled_session_pipeline(n, device="cuda")
    for _ in range(2):
        fields_equal(fn(padded, lut), session_pipeline(padded, lut))

    _build._SCRATCH.clear()
    b = torch.zeros((1, 4096), dtype=torch.uint8, device="cuda")
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(g, stream=torch.cuda.Stream()):
            cuda_decode.decode_rows_streams_cuda(b, None, 0xCC, 0x33)

    calls = []

    def body(x):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("raised during the capture")
        return x + 1

    runner = GraphRunner(body, [torch.zeros(4, device="cuda")])
    with pytest.raises(ValueError, match="during the capture"):
        runner.run()
    assert runner.graph is None
    assert torch.equal(runner.run(), torch.ones(4, device="cuda"))       # warm-up, capture
    assert torch.equal(runner(torch.full((4,), 2.0, device="cuda")), torch.full((4,), 3.0,
                                                                              device="cuda"))


def test_capture_out_of_memory_empties_the_cache_and_captures_again():
    """A capture cannot free the allocator's cached memory (dead graphs'
    pools): one that runs out of memory empties the cache and captures
    once more, leaving one graph whose replays are right."""
    from slam_process_tpu_torch.utils.graphs import GraphRunner

    capturing = []

    def body(x):
        capturing.append(torch.cuda.is_current_stream_capturing())
        if len(capturing) == 2:
            raise torch.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return x * 2

    runner = GraphRunner(body, [torch.ones(4, device="cuda")])
    assert torch.equal(runner.run(), torch.full((4,), 2.0, device="cuda"))    # the warm-up
    assert capturing == [False, True, True] and runner.graph is not None
    assert torch.equal(runner(torch.full((4,), 3.0, device="cuda")),
                       torch.full((4,), 6.0, device="cuda"))


def test_window_limit_at_the_window_length_equals_none():
    """K1 with a limit equal to the window's length gives its result for no
    limit: what lets full and short windows share one graph."""
    b = torch.from_numpy(session(seed=47)[:1 << 14]).cuda()[None].contiguous()
    got = cuda_decode.decode_rows_streams_cuda(
        b, torch.tensor([b.shape[1]], dtype=torch.int64, device="cuda"), 0xCC, 0x33)
    for g, w in zip(got, cuda_decode.decode_rows_streams_cuda(b, None, 0xCC, 0x33)):
        assert torch.equal(g, w)


def test_measure_device_time_places_graph_replays():
    """The kernels of a graph replay carry the graph launch's correlation id:
    ``measure_device_time`` places every one of them in its run."""
    from slam_process_tpu_torch.pipeline.device import (
        bucket_size, compiled_session_pipeline, device_lut, pad_bytes)
    from slam_process_tpu_torch.utils.device_timing import measure_device_time

    raw = session(seed=48)
    n = bucket_size(len(raw))
    padded = torch.from_numpy(pad_bytes(raw, n)).cuda()
    lut = device_lut(torch.device("cuda"))
    fn = compiled_session_pipeline(n, device="cuda")
    fn(padded, lut)
    t = measure_device_time(lambda i: fn(padded, lut), n=3)
    assert len(t.runs) == 3 and min(t.runs) > 0
    assert any("decode_rows_kernel" in name for name in t.all_modules)


# -- the sixteenth slice: K7 and the paths window as one CUDA graph ---------------------------


def nnls_close(got, want, exact):
    """K7's contract against its plain version: bit-equal (``"auto"`` at K >=
    3), else equal passive sets and x within rtol 1e-6; never a NaN."""
    (x, p), (xw, pw) = got, want
    assert torch.equal(p, pw)
    if exact:
        assert torch.equal(x.view(torch.int32), xw.view(torch.int32))
    else:
        torch.testing.assert_close(x, xw, rtol=1e-6, atol=0)
    assert torch.isfinite(x).all()


@pytest.mark.parametrize("k,solver", [(3, "auto"), (3, "lu"), (20, "auto"), (20, "lu"),
                                      (2, "auto"), (1, "lu"), (32, "auto")])
def test_nnls_kernel_matches_plain(k, solver):
    """K7 on ``utils/synthetic.nnls_edge_cases`` (cold and warm starts,
    near-collinear atoms, all-zero dead lanes, a 0/0 step-back ratio) and
    on the same lanes cold with max_outer = 2, one launch a call, no host
    sync."""
    from slam_process_tpu_torch.ops import cuda_nnls, nnls
    from slam_process_tpu_torch.utils.synthetic import nnls_edge_cases

    G, b, x0, P0 = (torch.from_numpy(a).cuda() for a in nnls_edge_cases(k, seed=k))
    exact = k == 3 or (k > 3 and solver == "auto")
    cuda_nnls.LAUNCHES = nnls.HOST_SYNCS = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = nnls.nnls_gram(G, b, solver=solver, x0=x0, P0=P0)
        cold = nnls.nnls_gram(G, b, max_outer=2, solver=solver)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_nnls.LAUNCHES == 2 and nnls.HOST_SYNCS == 0
    nnls_close(got, nnls.nnls_gram_plain(G, b, solver=solver, x0=x0, P0=P0), exact)
    nnls_close(cold, nnls.nnls_gram_plain(G, b, max_outer=2, solver=solver), exact)
    dead = slice(3 * (65 // 4), 64)
    assert not got[0][dead].any() and not got[1][dead].any()


def test_nnls_kernel_refuses_more_than_32_atoms():
    from slam_process_tpu_torch.ops import cuda_nnls, nnls

    cuda_nnls.LAUNCHES = 0
    with pytest.raises(ValueError, match="1..32 atoms"):
        nnls.nnls_gram(torch.zeros((2, 33, 33), device="cuda"),
                       torch.zeros((2, 33), device="cuda"))
    assert cuda_nnls.LAUNCHES == 0


def paths_stream_inputs(tmp_path):
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import write_angle_table

    raw = synthetic_session_bytes(n_groups=8, frames_per_beam=8, baselines_per_group=9,
                                  junk_frac=0.05, seed=3, n_paths=3)
    angles = write_angle_table(tmp_path / "angles.xlsx")
    return raw, angles, sd.make_paths_spec(angles, s_step=4, grid_res=0.5)


def test_paths_graph_equals_eager_body_alternating(tmp_path):
    """The paths window as one graph against the eager round: the whole
    state bit for bit (the rings' slack rows too) after every feed, with
    windows that close a sweep alternating with windows that close none,
    and after the flush."""
    from slam_process_tpu_torch.parallel import streaming_device as sd

    raw, _, spec = paths_stream_inputs(tmp_path)
    chunk = 1 << 12                       # a sweep is ~5.7 KB: windows close 0 or 1
    kw = dict(chunk_bytes=chunk, collect_filtered=True, collect_paths=spec, device="cuda")
    got = sd.DeviceStreamingSession(**kw)
    want = eager_windows(sd.DeviceStreamingSession(**kw))
    closed = []
    for off in range(0, len(raw), chunk):
        before = int(want._state.paths.n_closed)
        got.feed(raw[off:off + chunk])
        want.feed(raw[off:off + chunk])
        closed.append(int(want._state.paths.n_closed) - before)
        states_equal(got, want)
    assert 0 in closed and max(closed) > 0
    assert got._graph is not None and got._graph.replays > 0 and want._graph is None
    got.finalize()
    want.finalize()
    states_equal(got, want)


def test_paths_stream_on_card_reads_nothing_and_equals_cpu_and_offline(tmp_path):
    """A stream with ``collect_paths`` on the card: its windows sync nothing
    (``set_sync_debug_mode("error")``), both counters stay 0, K7 launches,
    and its paths equal the same stream with ``device="cpu"`` (power within
    rtol 2e-4) and the offline ``Session.sweep_paths`` / ``path_tracks`` on
    the card exactly."""
    from slam_process_tpu_torch.models.tracking import Tracks
    from slam_process_tpu_torch.ops import cuda_nnls, nnls
    from slam_process_tpu_torch.ops.decode import decode_frames_np
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.pipeline.session import Session

    raw, angles, spec = paths_stream_inputs(tmp_path)
    chunk = 1 << 13
    kw = dict(chunk_bytes=chunk, collect_paths=spec)
    sd.HOST_SYNCS = nnls.HOST_SYNCS = cuda_nnls.LAUNCHES = 0
    s = sd.DeviceStreamingSession(device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feed_stream(s, raw, chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    s.finalize()
    assert sd.HOST_SYNCS == nnls.HOST_SYNCS == 0 and cuda_nnls.LAUNCHES > 0
    assert s._graph is not None and s._graph.replays > 0
    cpu = feed_stream(sd.DeviceStreamingSession(device="cpu", **kw), raw, chunk)
    cpu.finalize()
    (paths, valid), (ref, ref_valid) = s.sweep_paths(), cpu.sweep_paths()
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_array_equal(s.sweep_times(), cpu.sweep_times())
    for field in paths._fields:
        if field == "power":
            np.testing.assert_allclose(paths.power, ref.power, rtol=2e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(paths, field), getattr(ref, field))
    off = Session("offline")
    off.frames = decode_frames_np(raw).frames
    beam_ids = (spec[0].ue_ids, spec[0].bs_ids)
    want, want_valid = off.sweep_paths(angles, beam_ids=beam_ids, device="cuda", grid_res=0.5)
    np.testing.assert_array_equal(valid, want_valid)
    for field in paths._fields:
        np.testing.assert_array_equal(getattr(paths, field), getattr(want, field))
    tracks = s.path_tracks()[0]
    want_tracks = off.path_tracks(angles, beam_ids=beam_ids, engine="device", device="cuda",
                                  grid_res=0.5)[0]
    for name in Tracks._fields:
        np.testing.assert_array_equal(getattr(tracks, name), getattr(want_tracks, name))
    assert len(valid) == 8 and tracks.n_tracks > 0


# -- the seventeenth slice: K7's element path (K > 3) and K5's stream-axis chunks -------------


def nnls_lanes(k, lanes, seed):
    """``utils/synthetic.nnls_edge_cases`` at ``lanes`` lanes on the card,
    with a NaN in one cold lane's b and another's G (each ends at its first
    gradient test, as the plain version's lockstep lanes do)."""
    from slam_process_tpu_torch.utils.synthetic import nnls_edge_cases

    G, b, x0, P0 = nnls_edge_cases(k, lanes=lanes, seed=seed)
    if lanes >= 8:
        b[1, k // 2] = np.nan
        G[2, 0, k - 1] = np.nan
    return [torch.from_numpy(a).cuda() for a in (G, b, x0, P0)]


@pytest.mark.parametrize("k", range(4, 33))
def test_nnls_element_path_matches_plain_at_every_k(k):
    """K7's element path (K > 3: a block of ceil(K (K+1) / 32) warps a lane)
    against its plain version: 1, 21, 65 and 300 lanes, "auto" bit-equal and
    "lu" within rtol 1e-6 with equal passive sets, warm starts and cold
    starts at max_outer 64 and 2, NaN lanes and the 0/0 step-back lane; one
    launch a call and no host sync."""
    from slam_process_tpu_torch.ops import cuda_nnls, nnls

    sets = {65: nnls_lanes(k, 65, seed=100 + k), 300: nnls_lanes(k, 300, seed=200 + k)}
    sets[1] = [t[:1] for t in sets[65]]
    sets[21] = [t[:21] for t in sets[65]]
    for solver in ("auto", "lu"):
        for lanes, (G, b, x0, P0) in sorted(sets.items()):
            calls = [dict(x0=x0, P0=P0), dict(max_outer=2), dict()]
            cuda_nnls.LAUNCHES = nnls.HOST_SYNCS = 0
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = [nnls.nnls_gram(G, b, solver=solver, **kw) for kw in calls]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert cuda_nnls.LAUNCHES == len(calls) and nnls.HOST_SYNCS == 0
            for g, kw in zip(got, calls):
                nnls_close(g, nnls.nnls_gram_plain(G, b, solver=solver, **kw), solver == "auto")


@pytest.mark.parametrize("s_n", [1, 2, 19, 64])
def test_stream_axis_compaction_chunks_match_plain(s_n):
    """K5's stream axis against its plain version at S = 1 (the single
    stream's schedule), 2, 19 and 64 (chunks of tiles a block): the 19
    streams at the round's 103,518 rows, two destinations (a ring at
    nonzero offsets that overflows its capacity, and a fresh zero-tailed
    buffer smaller than the masked count), called twice on one stream (the
    epoch-tagged scratch needs no reset)."""
    gen = torch.Generator().manual_seed(30 + s_n)
    f = {1: 103_518, 2: 70_000, 19: 103_518, 64: 9_000}[s_n]
    rows = torch.randint(-(1 << 30), 1 << 30, (s_n, f, 5), generator=gen, dtype=torch.int32)
    mask = torch.rand((s_n, f), generator=gen) < 0.4
    cap = f // 3
    ring = torch.randint(0, 9, (s_n, cap, 5), generator=gen, dtype=torch.int32)
    offs = torch.randint(0, cap + 1, (s_n,), generator=gen, dtype=torch.int32)

    def dests(d):
        return [(cap, ring.clone().to(d), offs.to(d)), (f // 4, None, None)]

    want_o, want_n = compact.compact_rows_streams_plain(rows, mask, dests("cpu"))
    assert int((offs + want_n > cap).sum()) > 0 and int(want_n.max()) > f // 4
    rows_c, mask_c = rows.cuda(), mask.cuda()
    for rep in range(2):
        cuda_compact.LAUNCHES = 0
        got_o, got_n = cuda_compact.compact_rows_streams_cuda(rows_c, mask_c, dests("cuda"))
        assert cuda_compact.LAUNCHES == 1
        for g, w in zip((*got_o, got_n), (*want_o, want_n)):
            assert torch.equal(g.cpu(), w)


# -- the eighteenth slice: K1's and K6's stream axes redesigned ---------------------------------

@functools.lru_cache(maxsize=None)
def decode_streams():
    from slam_process_tpu_torch.utils.synthetic import decode_stream_cases

    return decode_stream_cases()


@pytest.mark.parametrize("name", ["ragged_limits", "no_limits", "width_not_multiple_of_16",
                                  "one_stream"])
def test_stream_axis_decode_cases_match_plain(name):
    """K1 over [S, n] equal to its plain version, one launch a call, called
    twice on one stream (the S ticket words reset)."""
    bn, ln = decode_streams()[name]
    b = torch.from_numpy(bn).cuda()
    lim = None if ln is None else torch.from_numpy(ln).cuda()
    want = decode.decode_rows_streams_plain(b, n_valid=lim)
    for _ in range(2):
        cuda_decode.LAUNCHES = 0
        got = cuda_decode.decode_rows_streams_cuda(b, lim, 0xCC, 0x33)
        assert cuda_decode.LAUNCHES == 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert int(want[2].max()) > 0


def test_stream_axis_decode_batch_bucket_matches_plain():
    """The batch's largest bucket group as ``run_dataset`` stacks it: the
    19 dataset sessions padded to 786,432 bytes, no limits."""
    from slam_process_tpu_torch.parallel.batch import stack_sessions
    from slam_process_tpu_torch.pipeline.device import bucket_size

    raws = [synthetic_session_bytes(n_groups=20, frames_per_beam=44, baselines_per_group=93,
                                    junk_frac=0.02, big_group=0, seed=100 + i)
            for i in range(19)]
    bucket = bucket_size(max(len(r) for r in raws))
    assert bucket == 786_432
    b = torch.from_numpy(stack_sessions(raws, bucket)[0]).cuda()
    got = cuda_decode.decode_rows_streams_cuda(b, None, 0xCC, 0x33)
    for g, w in zip(got, decode.decode_rows_streams_plain(b)):
        assert torch.equal(g, w)


def test_stream_axis_decode_unaligned_and_graph_replay():
    """The 19 streams' 1 MiB bytes at an odd byte offset; then the aligned
    call captured in a CUDA graph (its scratch made on the capture stream
    first) and replayed twice into outputs overwritten in between: equal to
    the plain version each time, the ticket words zero after each replay."""
    bn, ln = decode_streams()["ragged_limits"]
    lim = torch.from_numpy(ln).cuda()
    flat = torch.zeros(bn.size + 16, dtype=torch.uint8, device="cuda")
    odd = flat[1:1 + bn.size].view(bn.shape)
    odd.copy_(torch.from_numpy(bn))
    want = decode.decode_rows_streams_plain(odd, n_valid=lim)
    for g, w in zip(cuda_decode.decode_rows_streams_cuda(odd, lim, 0xCC, 0x33), want):
        assert torch.equal(g, w)
    b = torch.from_numpy(bn).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_decode.decode_rows_streams_cuda(b, lim, 0xCC, 0x33)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = cuda_decode.decode_rows_streams_cuda(b, lim, 0xCC, 0x33)
    tickets = cuda_decode.tickets_for(b.device, side.cuda_stream, b.shape[0])
    for _ in range(2):
        for t in got:
            t.fill_(1)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert int(tickets.count_nonzero()) == 0


@pytest.mark.parametrize("name", ["long_chains_K3", "long_chains_T16_K20", "T16_K20_m_eff_edges",
                                  "planted_ties_and_nan"])
def test_stream_axis_tracker_cases_match_plain(name):
    """K6 over S streams equal to its plain version bit for bit (NaN
    positions included), one launch."""
    from slam_process_tpu_torch.utils.synthetic import track_stream_cases

    *arrays, gate = track_stream_cases()[name]
    args = [torch.from_numpy(a) for a in arrays]
    want = tracker.track_block_streams_plain(*args, gate)
    cuda_tracker.LAUNCHES = 0
    got = cuda_tracker.track_block_streams_cuda(*(a.cuda() for a in args), gate)
    assert cuda_tracker.LAUNCHES == 1
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w)


def test_batch_graph_equals_eager_body_alternating():
    """``batched_session_pipeline`` on the card, both forms and both
    ``outputs``: two buckets alternated, each call's graph replay against
    the eager body, every field bit for bit, K1-K3 once per bucket (vmap)
    or session (scan); two calls share no storage; ``run_dataset`` equal to
    the eager bodies' rows."""
    from slam_process_tpu_torch.parallel import batch
    from slam_process_tpu_torch.pipeline.device import bucket_size, device_lut

    raws = [synthetic_session_bytes(n_groups=2 + 3 * i, frames_per_beam=3, baselines_per_group=6,
                                    junk_frac=0.05, seed=110 + i) for i in range(4)]
    groups = {}
    for r in raws:
        groups.setdefault(bucket_size(len(r), 1 << 13), []).append(r)
    assert len(groups) >= 2
    lut = device_lut(torch.device("cuda"))
    stacked = {b: batch.stack_sessions(rs, b) for b, rs in groups.items()}
    kernels = (cuda_decode, cuda_correct, cuda_raster)
    for axis in ("vmap", "scan"):
        for outputs in ("full", "summary"):
            fns = {b: batch.batched_session_pipeline(None, b, outputs=outputs,
                                                     session_axis=axis) for b in groups}
            last = {}
            for b in sorted(groups) * 2:
                before = [k.LAUNCHES for k in kernels]
                got = fns[b](*stacked[b], lut)
                per = 1 if axis == "vmap" else len(groups[b])
                assert [k.LAUNCHES - n for k, n in zip(kernels, before)] == [per] * 3
                want = fns[b]._body(torch.from_numpy(stacked[b][0]).cuda(), lut)
                for f, g, w in zip(want._fields, got, want):
                    if w is None:
                        assert g is None
                        continue
                    assert g.dtype == w.dtype and torch.equal(
                        g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), f
                if b in last:
                    assert all(x.untyped_storage().data_ptr() != y.untyped_storage().data_ptr()
                               for x, y in zip(got, last[b]) if x is not None)
                last[b] = got
            assert all(r.replays >= 1 for fn in fns.values() for _, r, _ in fn.runners.values())
    got = batch.run_dataset(None, raws, quantum=1 << 13)
    fns = {b: batch.batched_session_pipeline(None, b, outputs="summary") for b in groups}
    for i, r in enumerate(raws):
        b = bucket_size(len(r), 1 << 13)
        row = [j for j, x in enumerate(groups[b]) if x is r][0]
        want = fns[b]._body(torch.from_numpy(stacked[b][0]).cuda(), lut)
        for f in batch.SessionSummaryOut._fields:
            assert getattr(got[i], f).tobytes() == getattr(want, f)[row].cpu().numpy().tobytes()


def test_batch_program_keeps_one_graph_a_shard():
    """``run_dataset`` with another session count in one bucket captures
    anew and drops the program's old graph: the program holds one runner,
    and after ``empty_cache`` every dropped graph's pool holds no bytes;
    each call's rows equal the eager body's."""
    import gc

    from slam_process_tpu_torch.parallel import batch
    from slam_process_tpu_torch.pipeline.device import bucket_size, device_lut
    from slam_process_tpu_torch.utils.graphs import pool_bytes

    raws = [synthetic_session_bytes(n_groups=3, frames_per_beam=3, baselines_per_group=6,
                                    junk_frac=0.05, seed=130 + i) for i in range(5)]
    (b,) = {bucket_size(len(r), 1 << 13) for r in raws}
    fn = batch.batched_session_pipeline(None, b, outputs="summary", device=None)
    lut = device_lut(torch.device("cuda"))
    dropped = []
    for n in (2, 3, 5, 3, 3):
        got = batch.run_dataset(None, raws[:n], quantum=1 << 13)
        ((rows, runner, _),) = fn.runners.values()
        assert rows == n
        pool = tuple(runner.graph.pool())
        if dropped and dropped[-1] == pool:
            dropped.pop()                   # the same graph replayed
        want = fn._body(torch.from_numpy(batch.stack_sessions(raws[:n], b)[0]).cuda(), lut)
        for i in range(n):
            for f in batch.SessionSummaryOut._fields:
                assert getattr(got[i], f).tobytes() == getattr(want, f)[i].cpu().numpy().tobytes()
        del want
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert pool_bytes(pool) > 0
        assert all(pool_bytes(p) == 0 for p in dropped), [pool_bytes(p) for p in dropped]
        dropped.append(pool)
    assert runner.replays == 1


def multi_states_equal(a, b):
    """Two multi-stream sessions' whole state, shard by shard, bit for bit."""
    from slam_process_tpu_torch.parallel import streaming_device as sd

    la = [x for sh in a._shards for x in sd._leaves(sh._state)]
    lb = [x for sh in b._shards for x in sd._leaves(sh._state)]
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), i


def multi_stream_inputs(tmp_path, s_step=8):
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import write_angle_table

    spec = sd.make_paths_spec(write_angle_table(tmp_path / "angles.xlsx"), s_step=s_step,
                              grid_res=1.0)
    raws = [synthetic_session_bytes(n_groups=3 + 2 * i, frames_per_beam=2, baselines_per_group=6,
                                    junk_frac=0.05, seed=120 + i, n_paths=3) for i in range(3)]
    return raws, spec


@pytest.mark.parametrize("mesh_shape", [None, (2, 1)], ids=["mesh_none", "mesh_2x1_cuda0"])
def test_multi_stream_graphs_equal_eager_rounds(tmp_path, mesh_shape):
    """``MultiStreamingSession`` on the card, its rounds CUDA graphs (one
    before the count read, one after per block count), against the same
    session run by the eager halves: the whole state bit for bit after
    every feed, a ragged flush and the final flush; one count read a round
    and shard; with a mesh of two positions of cuda:0 too."""
    from slam_process_tpu_torch.parallel import streaming_device as sd

    raws, spec = multi_stream_inputs(tmp_path)
    mesh = None if mesh_shape is None else card_mesh(mesh_shape)
    kw = dict(chunk_bytes=1 << 12, collect_paths=spec, emit_capacity=1 << 14, mesh=mesh,
              device="cuda" if mesh is None else None)
    got = sd.MultiStreamingSession(3, **kw)
    want = eager_rounds(sd.MultiStreamingSession(3, **kw))
    step = 6000
    n_rounds = []
    for off in range(0, max(len(r) for r in raws), step):
        pieces = [r[off:off + step] if i != 1 or off < 2 * step else b""
                  for i, r in enumerate(raws)]
        sd.HOST_SYNCS = 0
        got.feed(pieces)
        n_rounds.append(sd.HOST_SYNCS)
        want.feed(pieces)
        multi_states_equal(got, want)
        if off == step:
            for x in (got, want):
                x.finalize_streams([1])
            multi_states_equal(got, want)
    for x in (got, want):
        x.finalize()
    multi_states_equal(got, want)
    assert sum(n_rounds) % len(got._shards) == 0 and sum(n_rounds) > 0
    for sh in got._shards:
        assert sh._pre_graph is not None and sh._pre_graph.replays > 0
        assert sh._post_graphs and sum(g.replays for g in sh._post_graphs.values()) > 0
    assert all(sh._pre_graph is None for sh in want._shards)


def test_multi_stream_graphs_after_reset_and_restore(tmp_path):
    """The round's graphs write the state in place, so ``reset_streams``
    keeps them (the same graphs replay after it), and a session restored
    from a checkpoint captures graphs of its own; each equals the eager
    rounds bit for bit."""
    from slam_process_tpu_torch.parallel import streaming_device as sd

    raws, spec = multi_stream_inputs(tmp_path)
    kw = dict(chunk_bytes=1 << 12, collect_paths=spec, emit_capacity=1 << 14, device="cuda")
    got = sd.MultiStreamingSession(3, **kw)
    want = eager_rounds(sd.MultiStreamingSession(3, **kw))
    step = 6000
    for x in (got, want):
        x.feed([r[:2 * step] for r in raws])
        x.finalize_streams([0])
        x.reset_streams([0])
    pre, posts = got._pre_graph, dict(got._post_graphs)
    replays = pre.replays
    for x in (got, want):
        x.feed([raws[2][:step], raws[1][2 * step:3 * step], raws[2][2 * step:3 * step]])
    multi_states_equal(got, want)
    assert got._pre_graph is pre and got._pre_graph.replays > replays
    assert all(got._post_graphs.get(k) is g for k, g in posts.items())
    got.save_checkpoint(tmp_path / "multi.npz")
    back = sd.MultiStreamingSession.restore(tmp_path / "multi.npz", device="cuda")
    back_eager = eager_rounds(sd.MultiStreamingSession.restore(tmp_path / "multi.npz",
                                                               device="cuda"))
    assert back._pre_graph is None and not back._post_graphs
    rest = [raws[2][step:], raws[1][3 * step:], raws[2][3 * step:]]
    for x in (got, want, back, back_eager):
        x.feed(rest)
        x.finalize()
    multi_states_equal(got, want)
    multi_states_equal(back, back_eager)
    multi_states_equal(back, got)
    assert back._pre_graph is not None and back._pre_graph is not pre


ESTIMATOR_PROGRAMS = ("nn_omp", "batched_vmap", "batched_gram", "sm_sic", "fusion_nlos",
                      "omp_dense", "peak_mask", "lasso", "sweep_nn_omp", "sweep_sm_sic",
                      "tracker")


@pytest.fixture(scope="module")
def estimator_sessions_on_card(tmp_path_factory):
    """Four sessions decoded and corrected on the card: 0 and 1 of one scene
    shape and sweep count (6), 2 and 3 of another sweep count (3), and
    their angle table."""
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import to_hex_text, write_angle_table

    tmp = tmp_path_factory.mktemp("est_programs")
    sessions = []
    for i, (g, seed) in enumerate(((6, 1), (6, 2), (3, 3), (3, 4))):
        path = tmp / f"s{i}.txt"
        path.write_bytes(to_hex_text(synthetic_session_bytes(
            n_groups=g, frames_per_beam=2, baselines_per_group=6, seed=seed, n_paths=3)))
        sessions.append(Session.from_log(path))
    return sessions, write_angle_table(tmp / "angles.xlsx")


@pytest.mark.parametrize("name", ESTIMATOR_PROGRAMS)
def test_estimator_program_graph_equals_eager_body(estimator_sessions_on_card, name):
    """Each estimator program (``chip_smoke.estimator_program_cases``) on the
    card: two inputs of one shape alternated, then a second shape, every
    call bit-equal to the eager body on the same inputs, each call's
    outputs its own, K7 / K6 launched as the body launches them."""
    from chip_smoke import estimator_program_cases, leaves_differ
    from slam_process_tpu_torch.ops import cuda_nnls, cuda_tracker
    from slam_process_tpu_torch.utils.graphs import clear_programs

    sessions, angles = estimator_sessions_on_card
    dev = torch.device("cuda")
    clear_programs()
    (case,) = [c for c in estimator_program_cases(np, torch, sessions, angles, dev)
               if c["name"] == name]
    prog, kernels = case["program"], (cuda_nnls, cuda_tracker)

    def run(fn):
        before = [m.LAUNCHES for m in kernels]
        out = fn()
        return out, [m.LAUNCHES - b for m, b in zip(kernels, before)]

    def card(xs):
        return [torch.from_numpy(np.ascontiguousarray(x)).cuda() if isinstance(x, np.ndarray)
                else x.cuda() for x in xs]

    for tag, pair in case["shapes"]:
        want = [run(lambda x=x: prog.body(*card(x))) for x in pair]
        outs = []
        for k in (0, 1, 0, 1):
            got, n = run(lambda: prog(*pair[k]))
            assert not leaves_differ(torch, got, want[k][0]) and n == want[k][1], (tag, k)
            outs.append((k, got))
        for k, got in outs:                       # no later replay overwrote a result
            assert not leaves_differ(torch, got, want[k][0]), (tag, k)
    assert len(prog.graphs) == len(case["shapes"])
    clear_programs()


def test_lasso_program_on_card_equals_cpu_on_sparse_sessions(estimator_sessions_on_card):
    """The LASSO program's inputs from the fixture's sparse sessions (20
    peaks, columns of raw norm down to ~1e-7 and coefficients up to ~1e10):
    the card's graph equals the CPU body on the same inputs within rtol
    1e-9, the contract of ``run_estimator("lasso_refine")``."""
    from chip_smoke import estimator_program_cases
    from slam_process_tpu_torch.utils.graphs import clear_programs

    sessions, angles = estimator_sessions_on_card
    clear_programs()
    (case,) = [c for c in estimator_program_cases(np, torch, sessions, angles,
                                                  torch.device("cuda")) if c["name"] == "lasso"]
    for _, pair in case["shapes"]:
        for x in pair:
            got = case["program"](*x).cpu()
            want = case["program"].body(*x)
            assert want.abs().max() > 1e8
            torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)
    clear_programs()


def test_run_nn_omp_reads_the_host_once_a_call(estimator_sessions_on_card):
    """``run_estimator("nn_omp")``: the scene and the dictionary load into
    the graph's static inputs through pinned memory, and the result comes
    back in one read, the call's one host sync."""
    from chip_smoke import sync_sites_of
    from slam_process_tpu_torch.models.registry import run_estimator

    sessions, angles = estimator_sessions_on_card
    run_estimator("nn_omp", sessions[1], angles)
    sites = sync_sites_of(torch, lambda: run_estimator("nn_omp", sessions[1], angles))
    assert sum(sites.values()) == 1, sites


def test_graph_program_keeps_at_most_max_graphs():
    """A program of two graphs called with three shapes drops the least
    recently called graph; every call equals the body."""
    from slam_process_tpu_torch.utils.graphs import GraphProgram

    prog = GraphProgram(lambda x: (x * 2.0, x.sum(dim=0)), "cuda", 2)
    xs = {n: torch.arange(n * 3, dtype=torch.float32).reshape(n, 3) for n in (2, 4, 5)}
    for n in (2, 4, 2, 5, 4):
        got = prog(xs[n].numpy())
        want = prog.body(xs[n].cuda())
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [sig[0][0] for sig in prog.graphs] == [(5, 3), (4, 3)]


def test_svd_body_syncs_so_it_stays_eager():
    """``torch.linalg.svd`` reads its error information on the host, which a
    CUDA graph cannot capture: svd's device engine stays eager
    (``ROADMAP.md``) and still equals its CPU run."""
    from chip_smoke import sync_sites_of
    from slam_process_tpu_torch.models.svd_est import svd_paths_torch

    rng = np.random.default_rng(4)
    heat = torch.from_numpy(rng.random((90, 180)) * 50)
    grids = [torch.linspace(-45, 45, 90, dtype=torch.float64),
             torch.linspace(-45, 45, 180, dtype=torch.float64)]
    card = [heat.cuda(), *(g.cuda() for g in grids)]
    svd_paths_torch(*card)
    assert sum(sync_sites_of(torch, lambda: svd_paths_torch(*card)).values()) > 0
    got, want = svd_paths_torch(*card), svd_paths_torch(heat, *grids)
    assert torch.equal(got.valid.cpu(), want.valid)
    torch.testing.assert_close(got.power.cpu(), want.power, rtol=1e-9, atol=1e-12)
