"""Power-data preprocessing (a copy of ``slam_process_tpu/models/preprocess.py``).

Contrast enhancement of the intensity matrix before the v1-3 figure,
float64 numpy: "none", "log" (shift to >= 1, log10), "power" (gamma 0.5
over the range), "quantile" (rank transform), "adaptive" (x0.3 below
median + 0.5 std, log10, 256-bin histogram equalisation, x1.5 over the
90th percentile, rescaled to the original range).
"""

from __future__ import annotations

import numpy as np


def preprocess_power(data: np.ndarray, method: str = "adaptive") -> np.ndarray:
    data = np.asarray(data, dtype=np.float64).copy()
    if method == "none":
        return data
    if method == "log":
        shifted = data - data.min() + 1
        return np.log10(shifted)
    if method == "power":
        rng = data.max() - data.min()
        norm = (data - data.min()) / rng
        out = np.power(norm, 0.5)
        return out * rng + data.min()
    if method == "quantile":
        flat = data.ravel()
        ranks = np.searchsorted(np.sort(flat), data)
        return ranks.astype(np.float64)
    if method == "adaptive":
        median = np.median(data)
        std = np.std(data)
        thresh = median + 0.5 * std
        sup = data.copy()
        sup[data < thresh] = sup[data < thresh] * 0.3
        logged = np.log10(sup - sup.min() + 1)
        hist, bins = np.histogram(logged.ravel(), bins=256)
        cdf = hist.cumsum() / hist.sum()
        eq = np.interp(logged.ravel(), bins[:-1], cdf).reshape(data.shape)
        t90 = np.percentile(eq, 90)
        eq[eq > t90] = eq[eq > t90] * 1.5
        rng = data.max() - data.min()
        out = (eq - eq.min()) / max(eq.max() - eq.min(), 1e-300)
        return out * rng + data.min()
    raise ValueError(f"unknown preprocessing method {method!r}")
