"""Estimator registry: one entry point for the JAX registry's 13 names.

The port of ``slam_process_tpu/models/registry.py``.  ``run_estimator(name,
session, angle_file, ...)`` builds the session's scene, runs the
estimator, classifies the paths, draws the figure where asked, and returns
the paths table in the reference's output format:

  * ``nn_omp`` (v1-7, the flagship): pre-log scene, linspace grid, K = 20,
    keep rule "ratio", ``classify_advanced``;
  * ``nn_omp_v1``: linear scene, arange grid, K = 3, keep rule "positive",
    ``classify_argmax`` (the golden renders); ``nn_omp_v13`` the same with
    the preprocessed-matrix figure (``models/nn_omp_v13.py``);
  * ``nn_omp_v14`` / ``v15`` / ``v16``: linear scene, linspace grid, K =
    10, ratio 0.01, then ``classify_weak_far`` / ``classify_cross_region``
    / ``classify_advanced``;
  * ``sm_sic``: linear scene, inclusive-arange grid at 0.5 deg, 10 deg
    beams, K = 3; its table has the columns id, type (LoS / NLoS), aoa,
    aod, metric (``models/sm_sic.py``);
  * ``svd``, ``lasso_refine``, ``peak_picking``, ``fusion``, ``omp_dense``
    and ``geometric``, each in its module of that name (``svd_est`` for
    svd), with its own table.

The scene is built on the host in float64 (numpy), as in the JAX package.
``engine="device"`` (the default here; the JAX package's default is
"host") runs each family's device engine on ``device`` (None: CUDA):
the NN-OMP chain form, the SM-SIC tensors, and for the other families
float64 torch (where the JAX package's device engines are float32);
``engine="host"`` runs the float64 numpy oracles.  ``geometric`` has no
device engine in either package and warns, as the JAX package does.  The
table is a ``Table`` of numpy columns, not a pandas DataFrame: its
``to_string(index=False)`` prints pandas' text and ``to_dict("records")``
gives pandas' records.  An unknown name raises ``KeyError``.
"""

from __future__ import annotations

import dataclasses
import importlib
import re
from pathlib import Path
from typing import Optional, Union

import numpy as np

from slam_process_tpu_torch.config import (
    ClassifierConfig, DictionaryConfig, OmpConfig, SceneConfig, SmSicConfig)
from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.models.classifiers import (
    LABEL_NAMES, LOS, NLOS, NOISE, ClassifiedPaths, classify_advanced, classify_argmax,
    classify_cross_region, classify_weak_far)
from slam_process_tpu_torch.models.batch_estimation import flavor_config
from slam_process_tpu_torch.models.dictionary import make_dictionary
from slam_process_tpu_torch.models.nn_omp import run_nn_omp
from slam_process_tpu_torch.models.sm_sic import run_sm_sic
from slam_process_tpu_torch.ops.scene import compact_grid, fill_grid, intensity_grid_np

COLUMNS = ("AoA", "AoD", "Power", "PathType")
PRECISION = 6   # pandas' display.precision


def build_scene(session, angle_file, log_transform: bool, device=None):
    """Filtered rows -> (matrix [U, B] float64, ue_angles, bs_angles), on
    the host; a session not yet corrected is corrected on ``device``
    (None: CUDA) first."""
    if session.filtered is None:
        session.correct(device=device)
    ue, bs, rss = (session.filtered[:, i] for i in range(3))
    cfg = SceneConfig(log_transform=log_transform)
    grid = intensity_grid_np(ue, bs, rss, cfg=cfg)
    filled = fill_grid(grid, cfg)
    matrix, ue_ang, bs_ang, _, _ = compact_grid(grid, filled, load_angle_lut(angle_file))
    return matrix, ue_ang, bs_ang


def session_rows(session, device=None):
    """The (UE, BS, RSS) columns of ``session``'s filtered rows, correcting
    it on ``device`` (None: CUDA) first where it is not corrected yet."""
    if session.filtered is None:
        session.correct(device=device)
    return tuple(session.filtered[:, i] for i in range(3))


def pair_means(ue: np.ndarray, bs: np.ndarray, rss: np.ndarray):
    """pandas' ``groupby(["UE", "BS"])["RSS"].mean()`` without pandas: the
    observed (UE, BS) pairs sorted by UE then BS, and each pair's float64
    mean RSS (bincount sums, one division; integer RSS sums exactly, so
    the means equal pandas' bit for bit)."""
    ue = np.asarray(ue, dtype=np.int64)
    bs = np.asarray(bs, dtype=np.int64)
    lo = int(bs.min())
    span = int(bs.max()) - lo + 1
    keys, inv = np.unique(ue * span + (bs - lo), return_inverse=True)
    sums = np.bincount(inv, weights=np.asarray(rss, dtype=np.float64), minlength=len(keys))
    counts = np.bincount(inv, minlength=len(keys))
    return keys // span, keys % span + lo, sums / counts


def _trim_zeros(strings: list) -> list:
    """pandas' trim of trailing zeros, equal across a column's plain
    decimals, leaving one after the point."""
    plain = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")
    numbers = [x for x in strings if plain.match(x)]
    while numbers and all(x.endswith("0") for x in numbers):
        strings = [x[:-1] if plain.match(x) else x for x in strings]
        numbers = [x for x in strings if plain.match(x)]
    return [x + "0" if plain.match(x) and x.endswith(".") else x for x in strings]


def _float_column(values: np.ndarray) -> list:
    """A float column's cells as pandas prints them: fixed point with
    ``PRECISION`` digits and trimmed zeros, or exponent notation where a
    value would print as 0 or the column grows too wide."""
    def cells(fmt):
        return _trim_zeros([fmt.format(value=v) if not np.isnan(v) else "NaN"
                            for v in values])

    out = cells("{value:.%df}" % PRECISION)
    mag = np.abs(values)
    too_long = max(len(x) for x in out) > PRECISION + 6
    if ((mag < 10.0 ** -PRECISION) & (mag > 0)).any() or (too_long and (mag > 1e6).any()):
        out = cells("{value:.%de}" % PRECISION)
    return out


class Table:
    """A table of named columns (numpy numbers, or lists of str), in place
    of the JAX package's pandas DataFrame; with no columns, pandas' empty
    ``DataFrame([])``."""

    def __init__(self, columns: dict) -> None:
        self.columns = {c: (list(v) if isinstance(v, list) else np.asarray(v))
                        for c, v in columns.items()}

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def concat(self, other: "Table") -> "Table":
        """pandas' ``concat([self, other], ignore_index=True)`` of two tables
        with the same columns, or of one with an empty table."""
        if not other.columns:
            return self
        if not self.columns:
            return other
        return Table({c: (v + other[c] if isinstance(v, list) else np.concatenate([v, other[c]]))
                      for c, v in self.columns.items()})

    def __getitem__(self, name: str):
        return self.columns[name]

    def to_dict(self, orient: str = "records") -> list:
        """pandas' ``to_dict("records")``: one dict of Python values per
        row."""
        if orient != "records":
            raise ValueError(f"only orient='records' is supported, got {orient!r}")
        return [{c: (v[i] if isinstance(v, list) else v[i].item())
                 for c, v in self.columns.items()} for i in range(len(self))]

    def to_string(self, index: bool = False) -> str:
        """pandas' ``DataFrame.to_string(index=False)`` text of the table,
        byte for byte, with pandas' default display options."""
        if index:
            raise ValueError("only index=False is supported")
        if len(self) == 0:
            return "Empty DataFrame\nColumns: [" + ", ".join(self.columns) + "]\nIndex: []"
        strcols = []
        for c, v in self.columns.items():
            numeric = not isinstance(v, list)
            if not numeric:
                cells = [str(x) for x in v]
            elif np.issubdtype(v.dtype, np.integer):
                cells = [str(int(x)) for x in v]
            else:
                cells = _float_column(v)
            header = " " + c if numeric else c
            width = max(len(header), *(len(x) for x in cells))
            strcols.append([header.rjust(width)] + [x.rjust(width) for x in cells])
        return "\n".join(" ".join(row) for row in zip(*strcols))


class PathsTable(Table):
    """The estimated paths (AoA, AoD, Power, PathType), one numpy column
    each."""

    def __init__(self, aoa, aod, power, path_type) -> None:
        super().__init__({"AoA": aoa, "AoD": aod, "Power": power, "PathType": list(path_type)})


def paths_table(c: ClassifiedPaths) -> PathsTable:
    keep = np.asarray(c.valid)
    return PathsTable(np.asarray(c.aoa)[keep], np.asarray(c.aod)[keep],
                      np.asarray(c.power)[keep],
                      [LABEL_NAMES[int(lab)] for lab in np.asarray(c.label)[keep]])


# The NN-OMP flavors this module runs, and every name, in the JAX CLI's
# order.  The other families' entries live in their modules.
FLAVORS = ("nn_omp", "nn_omp_v1", "nn_omp_v14", "nn_omp_v15", "nn_omp_v16")
PORTED = ("nn_omp", "nn_omp_v1", "nn_omp_v13", "nn_omp_v14", "nn_omp_v15", "nn_omp_v16",
          "sm_sic", "svd", "lasso_refine", "peak_picking", "fusion", "omp_dense", "geometric")


def nn_omp_settings(name: str, **overrides):
    """(dict_cfg, omp_cfg, log_transform, keep_rule, stop_nonpositive) of
    an NN-OMP flavor: v1-7 and v1 as ``batch_estimation.flavor_config``;
    v1-4 / v1-5 / v1-6 the linear scene, linspace grid, K = 10 and keep
    ratio 0.01."""
    if name == "nn_omp":
        return flavor_config("v1-7", **overrides)
    if name == "nn_omp_v1":
        return flavor_config("v1", **overrides)
    if name not in FLAVORS:
        raise KeyError(f"unknown NN-OMP flavor {name!r}; have {FLAVORS}")
    dict_cfg = DictionaryConfig(grid_res=overrides.get("grid_res", 0.1),
                                beam_width=overrides.get("beam_width", 1.4),
                                grid_kind="linspace")
    omp_cfg = OmpConfig(max_paths=overrides.get("max_paths", 10),
                        min_power_ratio=overrides.get("min_power_ratio", 0.01))
    return dict_cfg, omp_cfg, False, "ratio", True


def classify_paths(name: str, p, **overrides) -> ClassifiedPaths:
    """Flavor ``name``'s classifier on OmpPaths ``p``: v1-7 the advanced
    classifier with the threshold overrides, v1 the argmax rule, v1-4 weak
    and far, v1-5 the cross region (its own overrides), v1-6 the advanced
    classifier with the default thresholds."""
    if name == "nn_omp":
        cfg = ClassifierConfig(**{f.name: overrides[f.name]
                                  for f in dataclasses.fields(ClassifierConfig)
                                  if f.name in overrides})
        return classify_advanced(p.aoa, p.aod, p.power, p.valid, cfg)
    if name == "nn_omp_v1":
        return classify_argmax(p.aoa, p.aod, p.power, p.valid)
    if name == "nn_omp_v14":
        return classify_weak_far(p.aoa, p.aod, p.power, p.valid)
    if name == "nn_omp_v15":
        return classify_cross_region(
            p.aoa, p.aod, p.power, p.valid,
            sidelobe_width_aoa=overrides.get("sidelobe_width_aoa", 45.0),
            sidelobe_width_aod=overrides.get("sidelobe_width_aod", 45.0),
            nlos_power_thresh_db=overrides.get("nlos_power_thresh_db", 10.0),
            nlos_min_angle_sep=overrides.get("nlos_min_angle_sep", 20.0))
    if name == "nn_omp_v16":
        return classify_advanced(p.aoa, p.aod, p.power, p.valid, ClassifierConfig())
    raise KeyError(f"unknown NN-OMP flavor {name!r}; have {FLAVORS}")


def run_sm_sic_estimator(session, angle_file, output_path=None, **overrides) -> Table:
    """The ``sm_sic`` entry: the linear scene, SM-SIC, the LoS / NLoS
    labels, the v1-style figure where asked; the table (id, type, aoa, aod,
    metric) of the valid peaks, as the JAX entry builds it."""
    device = overrides.get("device")
    cfg = SmSicConfig(max_paths=overrides.get("max_paths", 3),
                      beam_width=overrides.get("beam_width", 10.0),
                      grid_res=overrides.get("grid_res", 0.5),
                      proximity_mask_radius=overrides.get("proximity_mask_radius", 2.0),
                      cross_mask_width=overrides.get("cross_mask_width", 5.0))
    matrix, ue_ang, bs_ang = build_scene(session, angle_file, False, device=device)
    d = make_dictionary(ue_ang, bs_ang, DictionaryConfig(
        grid_res=cfg.grid_res, beam_width=cfg.beam_width, grid_kind="arange_inclusive"))
    paths = run_sm_sic(d, matrix, cfg, engine=overrides.get("engine", "device"), device=device)
    if output_path is not None:
        from slam_process_tpu_torch.render.estimation import estimation_plot

        label = np.where(paths.is_los, LOS, np.where(paths.valid, NLOS, NOISE))
        classified = ClassifiedPaths(paths.aoa, paths.aod, paths.metric,
                                     label.astype(np.int32), paths.valid)
        estimation_plot(matrix, ue_ang, bs_ang, classified, output_path, style="v1",
                        title="mmWave Beamspace Heatmap & SM-SIC Path Identification",
                        device=device)
    keep = np.asarray(paths.valid)
    return Table({"id": np.arange(1, cfg.max_paths + 1)[keep],
                  "type": list(np.where(paths.is_los[keep], "LoS", "NLoS")),
                  "aoa": paths.aoa[keep], "aod": paths.aod[keep],
                  "metric": paths.metric[keep]})


# The families kept in modules of their own: name -> (module, entry).
# Those modules import this one, so each is imported when it is asked for.
FAMILIES = {"nn_omp_v13": ("nn_omp_v13", "run_v13"), "svd": ("svd_est", "run_svd"),
            "lasso_refine": ("lasso_refine", "run_lasso_refine"),
            "peak_picking": ("peak_picking", "run_peak_picking"),
            "fusion": ("fusion", "run_fusion"),
            "omp_dense": ("omp_dense", "run_omp_dense_estimator"),
            "geometric": ("geometric", "run_geometric")}


def run_estimator(name: str, session, angle_file: Union[str, Path],
                  output_path: Optional[Union[str, Path]] = None, **overrides) -> Table:
    """Run estimator ``name`` on ``session``: the paths table, and with
    ``output_path`` the estimator's figure (needs matplotlib).  Overrides:
    ``engine`` ("device", the default, or "host"), ``device`` (None:
    CUDA), ``max_paths``, ``grid_res``, ``beam_width``, the keep ratio and
    the classifier thresholds (NN-OMP), the mask radii (SM-SIC, fusion),
    and each family's own (``energy_thresh``, ``percentile``, ``alpha``,
    ``preprocess``, ``bs_xy`` / ``ue_xy``, ...)."""
    if name == "sm_sic":
        return run_sm_sic_estimator(session, angle_file, output_path, **overrides)
    if name in FAMILIES:
        module, entry = FAMILIES[name]
        module = importlib.import_module(f"slam_process_tpu_torch.models.{module}")
        return getattr(module, entry)(session, angle_file, output_path, **overrides)
    if name not in FLAVORS:
        raise KeyError(f"unknown estimator {name!r}; have {PORTED}")
    device = overrides.get("device")
    dict_cfg, omp_cfg, log_transform, keep_rule, stop_np = nn_omp_settings(name, **overrides)
    matrix, ue_ang, bs_ang = build_scene(session, angle_file, log_transform, device=device)
    paths = run_nn_omp(make_dictionary(ue_ang, bs_ang, dict_cfg), matrix, omp_cfg,
                       keep_rule=keep_rule, stop_nonpositive=stop_np,
                       engine=overrides.get("engine", "device"), device=device)
    classified = classify_paths(name, paths, **overrides)
    if output_path is not None:
        from slam_process_tpu_torch.render.estimation import estimation_plot

        estimation_plot(matrix, ue_ang, bs_ang, classified, output_path,
                        style="v1" if name == "nn_omp_v1" else "v1-7", device=device)
    return paths_table(classified)
