"""Peak detection primitives: local maxima, percentiles, components, savgol.

The port of ``slam_process_tpu/ops/peaks.py``, the replacements of the
scipy.ndimage / scipy.signal calls in the peak-picking estimators.  Each
function takes numpy (scipy on the host, as in the JAX package) or a
tensor (the same on the tensor's device):

  * ``local_max_mask``: ``heat == maximum_filter(heat, size)``; for a
    tensor, ``max_pool2d`` with its implicit -inf padding (scipy's
    "reflect" border only repeats cells already in the window, so the two
    agree);
  * ``percentile``: ``np.nanpercentile`` (linear interpolation), or
    ``torch.nanquantile`` with the same rule;
  * ``connected_components_np`` / ``peak_regions_np``: 4-connected labels
    of the local-max mask above a percentile, each region's argmax cell,
    by power (host only);
  * ``savgol_matrix`` / ``savgol_rows``: scipy's ``savgol_filter``
    (mode "interp") as one [W, W] matrix, applied to every row by one
    matmul.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def local_max_mask(heat, size: int = 3):
    """mask[i, j] == (heat[i, j] == max over the size x size
    neighbourhood)."""
    if isinstance(heat, np.ndarray):
        from scipy.ndimage import maximum_filter

        return heat == maximum_filter(heat, size=(size, size))
    mx = torch.nn.functional.max_pool2d(heat[None, None], size, stride=1,
                                        padding=size // 2)[0, 0]
    return heat == mx


def percentile(values, q: float):
    """``np.nanpercentile`` (linear interpolation) over the finite
    entries: a float for numpy, a 0-d tensor for a tensor."""
    if isinstance(values, np.ndarray):
        return np.nanpercentile(values, q)
    return torch.nanquantile(values.reshape(-1), q / 100.0, interpolation="linear")


def connected_components_np(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected labelling (scipy.ndimage.label's default structure)."""
    from scipy import ndimage

    return ndimage.label(mask)


def peak_regions_np(heat: np.ndarray, percentile_thresh: float = 65.0,
                    neighborhood: int = 3) -> List[dict]:
    """Local maxima above the percentile, labelled into regions; each
    region's argmax cell, sorted by power, descending."""
    mask = local_max_mask(heat, neighborhood) & (
        heat > np.nanpercentile(heat, percentile_thresh))
    labeled, _ = connected_components_np(mask)
    from scipy.ndimage import find_objects

    peaks = []
    for i, slc in enumerate(find_objects(labeled)):
        if slc is None:
            continue
        region = heat[slc]
        local = np.unravel_index(np.argmax(region), region.shape)
        pos = (local[0] + slc[0].start, local[1] + slc[1].start)
        peaks.append({"label": i + 1, "idx": pos, "power": float(heat[pos])})
    return sorted(peaks, key=lambda p: -p["power"])


@functools.lru_cache(maxsize=16)
def savgol_matrix(n: int, window: int, poly: int) -> np.ndarray:
    """[n, n] matrix applying ``savgol_filter(y, window, poly)`` as W @ y."""
    from scipy.signal import savgol_filter

    eye = np.eye(n)
    cols = [savgol_filter(eye[:, i], window, poly) for i in range(n)]
    return np.stack(cols, axis=1)


def savgol_rows(data, window: int, poly: int):
    """savgol over every row of [H, W] data by one [W, W] matmul (numpy,
    or on the tensor's device in its dtype)."""
    W = savgol_matrix(data.shape[1], window, poly)
    if isinstance(data, np.ndarray):
        return data @ W.T
    return data @ torch.as_tensor(W, dtype=data.dtype, device=data.device).T
