"""Per-sweep estimator construction: config, dictionary, program body.

The port of ``slam_process_tpu/models/sweep_estimation.py`` for the
``"nn_omp"`` estimator.  ``est_key`` = (name, frozen config, keep_rule,
stop_nonpositive).  The body takes the per-sweep compact tensor mats [S,
U, B] (NaN where a cell was not observed) and the session dictionary,
fills each sweep's empty cells with that sweep's finite minimum (0 for a
sweep with no finite cell) and runs the Gram-domain batched NN-OMP.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slam_process_tpu_torch.config import DictionaryConfig, OmpConfig
from slam_process_tpu_torch.models.dictionary import BeamDictionary, make_dictionary
from slam_process_tpu_torch.models.nn_omp import nn_omp_gram_batch


def sweep_estimator_setup(estimator: str, ue_ang: np.ndarray, bs_ang: np.ndarray,
                          **overrides) -> Tuple[BeamDictionary, tuple]:
    """(host float64 dictionary, est_key) for a per-sweep estimator over the
    participating beams' angles (degrees).  Unknown override keys are
    ignored."""
    if estimator == "nn_omp":
        cfg = OmpConfig(max_paths=overrides.get("max_paths", 3))
        d = make_dictionary(ue_ang, bs_ang, DictionaryConfig(
            grid_res=overrides.get("grid_res", 0.1),
            beam_width=overrides.get("beam_width", 1.4),
            grid_kind="linspace"))
        return d, (estimator, cfg, overrides.get("keep_rule", "positive"),
                   overrides.get("stop_nonpositive", False))
    if estimator == "sm_sic":
        raise NotImplementedError("the sm_sic per-sweep estimator is not ported yet "
                                  "(ROADMAP queue 1 item 9); use estimator='nn_omp'")
    raise ValueError(f"unknown sweep estimator {estimator!r}")


def _fill_per_sweep(mats: torch.Tensor):
    """(filled, finite): empty cells take their sweep's finite minimum, or
    0 where the sweep has no finite cell."""
    finite = torch.isfinite(mats)
    fill = torch.where(finite, mats, float("inf")).amin(dim=(1, 2))
    fill = torch.where(torch.isfinite(fill), fill, 0.0)
    return torch.where(finite, mats, fill[:, None, None]), finite


def sweep_estimator_body(est_key):
    """(mats [S, U, B], phi_rx, phi_tx, aoa_g, aod_g) -> (OmpPaths of [S,
    K] tensors, sweep_valid [S] bool: the sweep has a finite cell)."""
    name, cfg, keep_rule, stop_np = est_key
    if name != "nn_omp":
        raise NotImplementedError(f"per-sweep estimator {name!r} is not ported")

    def run_all(mats, phi_rx, phi_tx, aoa_g, aod_g):
        filled, finite = _fill_per_sweep(mats)
        out = nn_omp_gram_batch(phi_rx, phi_tx, aoa_g, aod_g, filled, cfg=cfg,
                                keep_rule=keep_rule, stop_nonpositive=stop_np)
        return out, finite.any(dim=2).any(dim=1)

    return run_all
