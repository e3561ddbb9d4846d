"""Heatmap rasterization: blur -> normalize -> colormap.

  * NaN-aware Gaussian blur: odd kernel of size max(3, ceil(6 sigma)),
    replicate padding, per-pixel mask normalization
    sum(data * k * mask) / sum(k * mask), NaN where the weight is ~0;
  * shifted log norm: value' = value - min + 1e-6, log-normalised over the
    shifted range (or a linear norm), clipped to [0, 1], NaN kept;
    explicit ``vmin`` / ``vmax`` replace the range's ends (in the log form
    they are shifted by the data's own minimum, as the JAX package's are);
  * colormap with matplotlib index semantics idx = clip(int(x N), 0, N - 1);
    NaN cells are fully transparent (0, 0, 0, 0).

Norms reduce over the last two axes, so a batch [S, H, W] is normalised
tile by tile.  ``rasterize_tiles`` launches kernel K3
(``ops/cuda_raster.py``) for CUDA tensors and runs ``raster_tiles_plain``,
the same formulas in the same order, for CPU tensors.  ``to_u8`` is the
PNG-encoding form of a float raster.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from slam_process_tpu_torch.ops import cuda_raster
from slam_process_tpu_torch.render.figures import colormap_table

_ASSETS = Path(__file__).resolve().parent.parent / "assets"


def colormap_lut(name: str = "viridis") -> np.ndarray:
    """[256, 4] float32 RGBA table of a matplotlib colormap name.

    viridis ships with the package (``assets/viridis_256.npy``, matplotlib's
    table); any other name is built by matplotlib
    (``render/figures.colormap_table``), so it raises ImportError where
    matplotlib is not installed."""
    path = _ASSETS / f"{name}_256.npy"
    if path.exists():
        return np.load(path)
    return colormap_table(name)


def gaussian_kernel_np(sigma: float) -> np.ndarray:
    """2-D Gaussian kernel, size max(3, ceil(6 sigma)) forced odd, sum 1."""
    if sigma <= 0:
        return np.array([[1.0]], dtype=np.float64)
    size = int(max(3, math.ceil(6 * sigma)))
    if size % 2 == 0:
        size += 1
    c = size // 2
    y, x = np.ogrid[-c: c + 1, -c: c + 1]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)


@functools.lru_cache(maxsize=None)
def blur_taps(sigma: float, device) -> torch.Tensor:
    """The blur's [k, k] float32 taps on ``device``, built and copied once
    per (sigma, device); callers must not write to the tensor."""
    return torch.as_tensor(gaussian_kernel_np(sigma), dtype=torch.float32,
                           device=torch.device(device))


def blur_nan_aware(data: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """NaN-aware normalised blur of [..., H, W] f32 with [kh, kw] taps.

    Taps are summed in row-major order with separate multiply and add
    roundings, as kernel K3 sums them.
    """
    kh, kw = taps.shape
    ph, pw = kh // 2, kw // 2
    h, w = data.shape[-2:]
    finite = torch.isfinite(data)
    rows = torch.arange(-ph, h + ph, device=data.device).clamp(0, h - 1)
    cols = torch.arange(-pw, w + pw, device=data.device).clamp(0, w - 1)
    pad_v = torch.where(finite, data, 0.0)[..., rows, :][..., cols]
    pad_m = finite.to(torch.float32)[..., rows, :][..., cols]
    num = torch.zeros_like(data)
    den = torch.zeros_like(data)
    for dy in range(kh):
        for dx in range(kw):
            wgt = taps[dy, dx]
            num = num + wgt * pad_v[..., dy:dy + h, dx:dx + w]
            den = den + wgt * pad_m[..., dy:dy + h, dx:dx + w]
    return torch.where(den > 1e-12, num / den.clamp(min=1e-30), float("nan"))


def _finite_range(values: torch.Tensor):
    finite = torch.isfinite(values)
    mn = torch.where(finite, values, float("inf")).amin(dim=(-2, -1), keepdim=True)
    mx = torch.where(finite, values, float("-inf")).amax(dim=(-2, -1), keepdim=True)
    return finite, mn, mx


def shifted_log_norm(values: torch.Tensor, vmin: Optional[float] = None,
                     vmax: Optional[float] = None) -> torch.Tensor:
    """Shifted LogNorm of each [H, W] tile -> [0, 1] (NaN preserved).

    ``vmin`` / ``vmax`` are in the unshifted domain: the norm runs from
    log(max(vmin - min + 1e-6, 1e-30)) to log(vmax - min + 1e-6), min the
    tile's own; a ``vmax`` below the tile's minimum makes every t NaN.
    """
    finite, mn, mx = _finite_range(values)
    log_lo = torch.log(values.new_tensor(1e-6))
    if vmin is not None:
        log_lo = torch.log(((values.new_tensor(vmin) - mn) + 1e-6).clamp(min=1e-30))
    if vmax is None:
        log_hi = torch.log((mx - mn + 1e-6).clamp(min=1e-30))
    else:
        log_hi = torch.log((values.new_tensor(vmax) - mn) + 1e-6)
    t = (torch.log((values - mn + 1e-6).clamp(min=1e-30)) - log_lo) / (
        (log_hi - log_lo).clamp(min=1e-30))
    return torch.where(finite, t.clamp(0.0, 1.0), float("nan"))


def linear_norm(values: torch.Tensor, vmin: Optional[float] = None,
                vmax: Optional[float] = None) -> torch.Tensor:
    """Linear norm of each [H, W] tile -> [0, 1] from ``vmin`` (default: the
    tile's finite minimum) to ``vmax`` (default: its maximum)."""
    finite, mn, mx = _finite_range(values)
    lo = mn if vmin is None else values.new_tensor(vmin)
    hi = mx if vmax is None else values.new_tensor(vmax)
    t = (values - lo) / (hi - lo).clamp(min=1e-30)
    return torch.where(finite, t.clamp(0.0, 1.0), float("nan"))


def apply_colormap_float(norm_values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """[0, 1] (or NaN) values -> float RGBA [..., 4]; NaN -> (0, 0, 0, 0)."""
    n = lut.shape[0]
    finite = torch.isfinite(norm_values)
    x = torch.where(finite, norm_values, 0.0)
    idx = (x * n).to(torch.int64).clamp(0, n - 1)
    return torch.where(finite[..., None], lut[idx], 0.0)


def to_u8(rgba_float: torch.Tensor) -> torch.Tensor:
    """Float RGBA -> uint8 for PNG encoding (round half up)."""
    return (rgba_float * 255.0 + 0.5).to(torch.uint8)


def raster_tiles_plain(mats: torch.Tensor, lut: torch.Tensor, taps: torch.Tensor,
                       use_log: bool, vmin: Optional[float] = None,
                       vmax: Optional[float] = None):
    """Plain PyTorch version of kernel K3: (rgba, norm_t, blurred)."""
    blurred = blur_nan_aware(mats, taps)
    norm = shifted_log_norm if use_log else linear_norm
    norm_t = norm(blurred, vmin, vmax)
    return apply_colormap_float(norm_t, lut), norm_t, blurred


def rasterize_tiles(mats: torch.Tensor, lut: torch.Tensor, blur_sigma: float = 1.0,
                    use_log: bool = True, vmin: Optional[float] = None,
                    vmax: Optional[float] = None):
    """[S, H, W] f32 intensity tiles -> (rgba [S, H, W, 4], norm_t
    [S, H, W], blurred [S, H, W]); kernel K3 on CUDA tensors, the plain
    version on CPU tensors (``pallas_rasterize_batch``'s counterpart, with
    ``rasterize``'s explicit bounds)."""
    taps = blur_taps(blur_sigma, mats.device)
    if mats.is_cuda:
        return cuda_raster.raster_tiles_cuda(mats.contiguous(), lut.contiguous(), taps,
                                             use_log, vmin, vmax)
    if mats.device.type != "cpu":
        raise ValueError(f"the raster runs on CUDA or CPU tensors, got {mats.device}")
    return raster_tiles_plain(mats, lut, taps, use_log, vmin, vmax)
