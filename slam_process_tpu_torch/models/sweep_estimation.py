"""Per-sweep estimator construction: config, dictionary, program body.

The port of ``slam_process_tpu/models/sweep_estimation.py``: ``"nn_omp"``
and ``"sm_sic"``.  ``est_key`` = (name, frozen config, keep_rule,
stop_nonpositive).  The body takes the per-sweep compact tensor mats [S,
U, B] (NaN where a cell was not observed) and the session dictionary,
fills each sweep's empty cells with that sweep's finite minimum (0 for a
sweep with no finite cell) and runs the Gram-domain batched NN-OMP or
SM-SIC over the sweeps; ``sweep_program`` makes it one compiled program per
est_key and shape (a CUDA graph on the card).  ``estimator_dictionary``
gives the dictionary in the dtypes the body takes: float32 phi matrices,
float32 grids for NN-OMP and float64 grids for SM-SIC (its masks'
geometry, ``models/sm_sic.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slam_process_tpu_torch.config import DictionaryConfig, OmpConfig, SmSicConfig
from slam_process_tpu_torch.models.dictionary import BeamDictionary, make_dictionary
from slam_process_tpu_torch.models.nn_omp import OmpPaths, nn_omp_gram_batch
from slam_process_tpu_torch.models.sm_sic import SmSicPaths, sm_sic
from slam_process_tpu_torch.utils.graphs import GraphProgram, program_cache


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
        cfg = SmSicConfig(max_paths=overrides.get("max_paths", 3),
                          beam_width=overrides.get("beam_width", 10.0),
                          grid_res=overrides.get("grid_res", 0.5))
        d = make_dictionary(ue_ang, bs_ang, DictionaryConfig(
            grid_res=cfg.grid_res, beam_width=cfg.beam_width, grid_kind="arange_inclusive"))
        return d, (estimator, cfg, None, None)
    raise ValueError(f"unknown sweep estimator {estimator!r}")


def estimator_dictionary(est_key, d: BeamDictionary) -> BeamDictionary:
    """The host float64 dictionary ``d`` as the body takes it, numpy:
    phi_rx and phi_tx rounded once to float32, the grids float32 for
    NN-OMP and float64 for SM-SIC."""
    grid_dtype = np.float64 if est_key[0] == "sm_sic" else np.float32
    return BeamDictionary(np.asarray(d.aoa_grid, grid_dtype), np.asarray(d.aod_grid, grid_dtype),
                          np.asarray(d.phi_rx, np.float32), np.asarray(d.phi_tx, np.float32))


def _fill_per_sweep(mats: torch.Tensor):
    """(filled, finite): empty cells take their sweep's finite minimum, or
    0 where the sweep has no finite cell."""
    finite = torch.isfinite(mats)
    fill = torch.where(finite, mats, float("inf")).amin(dim=(1, 2))
    fill = torch.where(torch.isfinite(fill), fill, 0.0)
    return torch.where(finite, mats, fill[:, None, None]), finite


def sweep_estimator_body(est_key):
    """(mats [S, U, B], phi_rx, phi_tx, aoa_g, aod_g, model_devices=None) ->
    (paths of [S, K] tensors, sweep_valid [S] bool: the sweep has a finite
    cell).  The paths are OmpPaths (NN-OMP) or SmSicPaths with float32
    angles (SM-SIC).  ``model_devices`` (a mesh row's devices) shards
    NN-OMP's AoA grid over them (``nn_omp_gram_batch``); SM-SIC runs with
    the whole dictionary on the inputs' device, so its results cannot
    differ from the unsharded run's."""
    name, cfg, keep_rule, stop_np = est_key
    if name == "nn_omp":
        def run_all(mats, phi_rx, phi_tx, aoa_g, aod_g, model_devices=None):
            filled, finite = _fill_per_sweep(mats)
            out = nn_omp_gram_batch(phi_rx, phi_tx, aoa_g, aod_g, filled, cfg=cfg,
                                    keep_rule=keep_rule, stop_nonpositive=stop_np,
                                    model_devices=model_devices)
            return out, finite.any(dim=2).any(dim=1)
    elif name == "sm_sic":
        def run_all(mats, phi_rx, phi_tx, aoa_g, aod_g, model_devices=None):
            del model_devices
            filled, finite = _fill_per_sweep(mats)
            out = sm_sic(phi_rx, phi_tx, aoa_g, aod_g, filled, cfg)
            out = out._replace(aoa=out.aoa.to(torch.float32), aod=out.aod.to(torch.float32))
            return out, finite.any(dim=2).any(dim=1)
    else:
        raise ValueError(f"unknown sweep estimator {name!r}")
    return run_all


@program_cache(16)
def sweep_program(est_key, device=None) -> GraphProgram:
    """The per-sweep estimator of ``est_key`` as one compiled program on
    ``device`` (None: CUDA), the JAX package's ``_sweep_estimator_fn(est_key,
    None)``: ``sweep_estimator_body`` called as ``fn(mats, phi_rx, phi_tx,
    aoa_g, aod_g)``; on CUDA one graph per shape, 16 at most, and 16
    programs, as JAX caches 16.  The mesh rows of several devices run the
    body eagerly (``model_devices``)."""
    return GraphProgram(sweep_estimator_body(est_key), device, 16)


def zero_paths(est_key, rows: int, device) -> tuple:
    """A zero result of the body for ``rows`` sweeps (the stream's rings):
    OmpPaths or SmSicPaths."""
    k = est_key[1].max_paths

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    f32, b = torch.float32, torch.bool
    if est_key[0] == "sm_sic":
        return SmSicPaths(zeros(rows, k, dtype=f32), zeros(rows, k, dtype=f32),
                          zeros(rows, k, dtype=f32), zeros(rows, k, dtype=b),
                          zeros(rows, k, dtype=b))
    return OmpPaths(zeros(rows, k, dtype=f32), zeros(rows, k, dtype=f32),
                    zeros(rows, k, dtype=f32), zeros(rows, k, dtype=b), zeros(rows),
                    zeros(rows, k), zeros(rows, k))


def path_power(paths):
    """The tracker's power of a body's paths: NN-OMP's power, SM-SIC's
    metric."""
    return paths.power if hasattr(paths, "power") else paths.metric
