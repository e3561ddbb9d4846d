"""Kernels K1-K3 against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where ``torch.cuda.is_available()`` is False
(the condition is evaluated when each test is set up).  On a machine with
a card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.  These add to
what ``chip_smoke.py`` checks; they do not replace it.  K1 and K2 must equal
their plain versions element for element; K3 holds blurred within 1e-5
relative, norm_t within 1e-4 absolute, the same NaN pattern, LUT-bin flips
under 0.1 % and premultiplied rgba within 1e-3 (the card's logf and the
CPU's log may differ in the last bit).
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.ops import (
    correct, cuda_correct, cuda_decode, cuda_raster, decode, raster)
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
