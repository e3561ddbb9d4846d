"""Whole-dataset estimation: N sessions through one batched NN-OMP.

The port of ``slam_process_tpu/models/batch_estimation.py``'s
``PackedScenes``, ``flavor_config``, ``pack_scenes``,
``nn_omp_sessions_sharded`` (a mesh: sessions over ``data``, the AoA grid
over ``model``) and ``estimate_sessions``, and of the forms the JAX
package keeps to judge the production one by: ``_batched_nn_omp``
(``"vmap"``, the production form, or ``"gram"``) and
``nn_omp_sessions_device`` (one run per session).  Per session the host builds
the float64 scene (``registry.build_scene``) and its dictionary;
``pack_scenes`` pads them to the dataset's largest (U, B, Ga, Gd) with
zeros; ``nn_omp_scenes`` runs all N scenes in lockstep on a device (the
JAX package's production ``"vmap"`` program), so each iteration's
correlation chain is one batched product per side.  As in the JAX package
each form is one compiled program per (config, form) and shape
(``batched_program``; the per-session form replays the session program
``models/nn_omp.nn_omp_program``): a CUDA graph on the card, the eager body
on the CPU.

Zero padding is exact: padded measurement rows multiply zero ``phi`` rows,
and padded grid atoms have zero ``phi`` columns, so their correlation is
exactly 0.  With ``stop_nonpositive=True`` (v1-7) a padded atom is never
selected.  With ``stop_nonpositive=False`` (v1) one can win only when every
real correlation is negative; its coefficient refits to 0, so every keep
rule drops it: the valid paths match the per-session run, ``n_iters`` may
not.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from slam_process_tpu_torch.config import DictionaryConfig, OmpConfig
from slam_process_tpu_torch.models.dictionary import BeamDictionary, make_dictionary
from slam_process_tpu_torch.models.nn_omp import (
    OmpPaths, nn_omp_gram_batch, nn_omp_program, nn_omp_scenes)
from slam_process_tpu_torch.pipeline.device import resolve_device
from slam_process_tpu_torch.utils.graphs import GraphProgram, program_cache


class PackedScenes(NamedTuple):
    """N sessions padded to one shape: numpy from ``pack_scenes``, float32
    / int32 tensors from ``packed_to_device``."""

    matrices: np.ndarray   # [N, U, B] f32 (0 past each session's extent)
    phi_rx: np.ndarray     # [N, U, Ga] (0 rows / cols past the extent)
    phi_tx: np.ndarray     # [N, B, Gd]
    aoa_grid: np.ndarray   # [N, Ga] (edge-padded; padded atoms never selected)
    aod_grid: np.ndarray   # [N, Gd]
    n_ue: np.ndarray       # [N] true U per session
    n_bs: np.ndarray       # [N]
    n_ga: np.ndarray       # [N]
    n_gd: np.ndarray       # [N]


def flavor_config(flavor: str, **overrides):
    """(dict_cfg, omp_cfg, log_transform, keep_rule, stop_nonpositive) of
    an estimator flavor: "v1-7" (the flagship) or "v1" (the golden
    renders)."""
    if flavor == "v1-7":
        dict_cfg = DictionaryConfig(grid_res=overrides.get("grid_res", 0.1),
                                    beam_width=overrides.get("beam_width", 1.4),
                                    grid_kind="linspace")
        cfg = OmpConfig(max_paths=overrides.get("max_paths", 20),
                        min_power_ratio=overrides.get("min_power_ratio", 0.0003))
        return dict_cfg, cfg, True, "ratio", True
    if flavor == "v1":
        dict_cfg = DictionaryConfig(grid_res=overrides.get("grid_res", 0.1),
                                    beam_width=overrides.get("beam_width", 1.4),
                                    grid_kind="arange")
        cfg = OmpConfig(max_paths=overrides.get("max_paths", 3))
        return dict_cfg, cfg, False, "positive", False
    raise ValueError(f"unknown flavor {flavor!r}")


def pack_scenes(matrices: Sequence[np.ndarray], dictionaries: Sequence[BeamDictionary],
                pad_to=None) -> PackedScenes:
    """Pad per-session scenes and dictionaries to the dataset's largest
    shape, or to ``pad_to = (U, B, Ga, Gd)`` (each at least that), as
    numpy."""
    n = len(matrices)
    U = max(m.shape[0] for m in matrices)
    B = max(m.shape[1] for m in matrices)
    Ga = max(len(d.aoa_grid) for d in dictionaries)
    Gd = max(len(d.aod_grid) for d in dictionaries)
    if pad_to is not None:
        pad = tuple(int(x) for x in pad_to)
        if any(p < v for p, v in zip(pad, (U, B, Ga, Gd))):
            raise ValueError(f"pad_to {pad} is smaller than the scenes' {(U, B, Ga, Gd)}")
        U, B, Ga, Gd = pad

    mats = np.zeros((n, U, B), np.float32)
    prx = np.zeros((n, U, Ga), np.float32)
    ptx = np.zeros((n, B, Gd), np.float32)
    ag = np.zeros((n, Ga), np.float32)
    dg = np.zeros((n, Gd), np.float32)
    dims = np.zeros((4, n), np.int32)
    for i, (m, d) in enumerate(zip(matrices, dictionaries)):
        u, b = m.shape
        ga, gd = len(d.aoa_grid), len(d.aod_grid)
        mats[i, :u, :b] = m
        prx[i, :u, :ga] = d.phi_rx
        ptx[i, :b, :gd] = d.phi_tx
        ag[i, :ga] = d.aoa_grid
        ag[i, ga:] = d.aoa_grid[-1]
        dg[i, :gd] = d.aod_grid
        dg[i, gd:] = d.aod_grid[-1]
        dims[:, i] = (u, b, ga, gd)
    return PackedScenes(mats, prx, ptx, ag, dg, *dims)


def packed_to_device(packed: PackedScenes, device) -> PackedScenes:
    """The packed arrays as tensors on ``device``: float32 scenes,
    dictionaries and grids, int32 extents."""
    return PackedScenes(*(torch.from_numpy(np.ascontiguousarray(
        x, dtype=np.float32 if i < 5 else np.int32)).to(device)
        for i, x in enumerate(packed)))


def _program_inputs(packed: PackedScenes, device):
    """(device, [phi_rx, phi_tx, aoa_grid, aod_grid, matrices], the float32
    arrays a program takes) of ``packed``: numpy goes to ``device`` (None:
    CUDA; the program loads it), tensors stay where they are unless
    ``device`` names another device."""
    fields = (packed.phi_rx, packed.phi_tx, packed.aoa_grid, packed.aod_grid, packed.matrices)
    if isinstance(packed.matrices, torch.Tensor):
        dev = packed.matrices.device if device is None else resolve_device(device)
        return dev, [x.to(dev, torch.float32) for x in fields]
    return resolve_device(device), [np.ascontiguousarray(x, dtype=np.float32) for x in fields]


FORMS = {"vmap": nn_omp_scenes, "gram": nn_omp_gram_batch}


@program_cache(16)
def batched_program(cfg: OmpConfig, keep_rule: str = "ratio", stop_np: bool = True,
                    form: str = "vmap", device=None) -> GraphProgram:
    """The batched program of one (cfg, keep rule, stopping rule, form) on
    ``device`` (None: CUDA): the JAX package's ``_batched_nn_omp_fn``,
    called as ``fn(phi_rx, phi_tx, aoa_grid, aod_grid, mats)`` on N packed
    scenes; on CUDA one graph per shape, 16 at most, and 16 programs, as
    JAX caches 16."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; use 'vmap' or 'gram'")
    est = FORMS[form]

    def body(phi_rx, phi_tx, aoa_grid, aod_grid, mats):
        return est(phi_rx, phi_tx, aoa_grid, aod_grid, mats, cfg, keep_rule, stop_np)
    return GraphProgram(body, device, 16)


def _batched_nn_omp(packed: PackedScenes, cfg: OmpConfig, keep_rule: str = "ratio",
                    stop_np: bool = True, form: str = "vmap", device=None) -> OmpPaths:
    """The N packed sessions in one batched run (the JAX package's
    ``_batched_nn_omp_fn``, ``batched_program``), in one of two forms:

      * ``"vmap"``: ``nn_omp_scenes``, the chain recomputed from the
        residual every iteration, one batched product per side (what
        ``nn_omp_sessions_sharded`` runs on one device and
        ``estimate_sessions`` returns);
      * ``"gram"``: ``nn_omp_gram_batch`` with each session's own
        dictionary (the JAX package's vmap of ``nn_omp_gram_batch_jax`` over
        sessions): the correlation chain once, then per iteration a rank-K
        update of the [N, Ga, Gd] surfaces.  The sessions' Grams are
        batched ([N, Ga, Ga] and [N, Gd, Gd], one product each), not looped.

    ``packed`` is numpy (moved to ``device``, None: CUDA) or tensors (kept
    on their device).  Returns OmpPaths of [N, K] tensors ([N] n_iters) on
    that device; both forms select alike (the JAX package's comparator
    contract: indices, ``n_iters`` and ``valid`` equal, power within
    float32 rounding)."""
    dev, args = _program_inputs(packed, device)
    return batched_program(cfg, keep_rule, stop_np, form, dev)(*args)


def nn_omp_sessions_device(packed: PackedScenes, cfg: OmpConfig, keep_rule: str = "ratio",
                           stop_nonpositive: bool = True, device=None) -> list:
    """The N packed sessions as N runs of one program: the session program
    ``nn_omp_program`` (JAX's ``_jitted_nn_omp``, N = 1) replayed on each
    session's row of ``packed`` (padded as packed), the JAX package's
    per-session dispatch, which it keeps as the yardstick of the batched
    forms (``_batched_nn_omp``).  ``packed`` as ``_batched_nn_omp``'s.
    Returns a list of N OmpPaths of [K] tensors (``n_iters`` 0-d) on the
    device, not read back; each its own copy of the program's outputs."""
    dev, args = _program_inputs(packed, device)
    fn = nn_omp_program(cfg, keep_rule, stop_nonpositive, dev)
    return [OmpPaths(*(x[0] for x in fn(*(a[i:i + 1] for a in args))))
            for i in range(args[0].shape[0])]


def nn_omp_sessions_sharded(packed: PackedScenes, cfg: OmpConfig, mesh,
                            keep_rule: str = "ratio", stop_nonpositive: bool = True,
                            device=None) -> OmpPaths:
    """Whole-dataset estimation over a mesh (None: one row of ``device``,
    None: CUDA; ``parallel.mesh.placement``): the sessions over ``data``
    (padded with zero scenes to a multiple of it: every correlation 0, so
    they select nothing that is kept, and are dropped), each data shard on
    its row's devices.  A row of one device runs the "vmap" form's
    ``batched_program`` (a CUDA graph per shard shape on the card); a row
    of several shards the AoA grid over ``model`` (``nn_omp_scenes``'s
    ``model_devices``: Ga pads to a multiple of ``model`` with zero phi_rx
    columns and edge-repeated angles, as the JAX package pads it), eagerly:
    each iteration crosses the row's devices, which one device's graph
    cannot.

    ``packed`` is ``pack_scenes``' numpy.  Returns an OmpPaths of [N, ...]
    numpy arrays, each shard read back once; equal to the unsharded run's.
    """
    from slam_process_tpu_torch.parallel.mesh import placement, read_once, shard_rows

    rows = placement(mesh, device)
    n = packed.matrices.shape[0]
    n_pad, per = shard_rows(n, len(rows))
    padded = PackedScenes(*(np.pad(x, ((0, n_pad - n),) + ((0, 0),) * (x.ndim - 1))
                            for x in packed))
    outs = []
    for r, devs in enumerate(rows):
        shard = PackedScenes(*(x[r * per:(r + 1) * per] for x in padded))
        if len(devs) == 1:
            outs.append(_batched_nn_omp(shard, cfg, keep_rule, stop_nonpositive, "vmap",
                                        devs[0]))
            continue
        p = packed_to_device(shard, devs[0])
        outs.append(nn_omp_scenes(p.phi_rx, p.phi_tx, p.aoa_grid, p.aod_grid, p.matrices, cfg,
                                  keep_rule, stop_nonpositive, model_devices=devs))
    host = [read_once([o])[0] for o in outs]
    return OmpPaths(*(np.concatenate(fs)[:n] for fs in zip(*host)))


def estimate_sessions(sessions, angle_file, flavor: str = "v1-7", device=None, mesh=None,
                      **overrides) -> list:
    """v1-7 (or v1) NN-OMP over N sessions in one batched run on ``device``
    (None: CUDA) or over ``mesh``, through ``nn_omp_sessions_sharded``.

    Per session the host builds the scene and the dictionary; the N padded
    scenes then run through ``nn_omp_scenes`` in lockstep (with its LU
    NNLS solve, where the JAX package's dataset program uses Gauss-Jordan:
    the two select alike).  Returns a list of per-session OmpPaths of
    numpy arrays of [K] (``n_iters`` a numpy scalar), equal to
    ``run_nn_omp(engine="device")`` on each session under the padding
    caveat (module docstring); the mesh form equals ``mesh=None``.
    """
    from slam_process_tpu_torch.models.registry import build_scene
    from slam_process_tpu_torch.parallel.mesh import placement

    dev = placement(mesh, device)[0][0]
    dict_cfg, cfg, log_transform, keep_rule, stop_np = flavor_config(flavor, **overrides)
    mats, dicts = [], []
    for s in sessions:
        matrix, ue_ang, bs_ang = build_scene(s, angle_file, log_transform, device=dev)
        mats.append(matrix)
        dicts.append(make_dictionary(ue_ang, bs_ang, dict_cfg))
    host = nn_omp_sessions_sharded(pack_scenes(mats, dicts), cfg, mesh, keep_rule, stop_np,
                                   device=device)
    return [OmpPaths(*(x[i] for x in host)) for i in range(len(sessions))]
