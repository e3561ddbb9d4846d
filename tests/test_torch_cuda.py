"""Kernels K1-K4 against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where ``torch.cuda.is_available()`` is False
(the condition is evaluated when each test is set up).  On a machine with
a card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.  These add to
what ``chip_smoke.py`` checks; they do not replace it.  K1 and K2 must equal
their plain versions element for element; K3 holds blurred within 1e-5
relative, norm_t within 1e-4 absolute, the same NaN pattern, LUT-bin flips
under 0.1 % and premultiplied rgba within 1e-3 (the card's logf and the
CPU's log may differ in the last bit).  K4 must equal its plain version
element for element, ``Session.from_log`` on logs past the corrector's
default bounds must rerun K2 on the card and equal its CPU run, and
``Session.sweep_paths`` on the card must equal its CPU run (power within
rtol 2e-4).
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.ops import (
    correct, cuda_correct, cuda_decode, cuda_raster, cuda_sweep_sums, decode, raster, scene)
from slam_process_tpu_torch.pipeline.device import run_session_on_device
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

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
    rgba, t, b = cuda_raster.raster_tiles_cuda(mats, lut, taps, use_log)
    rgba_p, t_p, b_p = raster.raster_tiles_plain(mats, lut, taps, use_log)
    assert torch.equal(torch.isnan(b), torch.isnan(b_p))
    assert torch.equal(torch.isnan(t), torch.isnan(t_p))
    assert torch.allclose(b, b_p, rtol=1e-5, atol=0.0, equal_nan=True)
    fin = ~torch.isnan(t)
    assert float((t[fin] - t_p[fin]).abs().max()) <= 1e-4
    bins = (t.nan_to_num() * 256).long().clamp(0, 255)
    bins_p = (t_p.nan_to_num() * 256).long().clamp(0, 255)
    assert float((bins != bins_p).float().mean()) < 1e-3
    assert float((rgba * rgba[..., 3:] - rgba_p * rgba_p[..., 3:]).abs().max()) <= 1e-3


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
