"""The v1-3 estimator: v1 NN-OMP and the original-against-preprocessed
figure.

The port of ``slam_process_tpu/models/nn_omp_v13.py``: the linear scene,
the v1 NN-OMP (0.1 deg arange grid, beam 1.4 deg, 3 paths, keep rule
"positive") on the UNPROCESSED matrix, the argmax classifier; the
preprocessed matrix (``models/preprocess``, "adaptive" by default) feeds
only the figure's right panel.
"""

from __future__ import annotations

from slam_process_tpu_torch.config import DictionaryConfig, OmpConfig
from slam_process_tpu_torch.models.classifiers import classify_argmax
from slam_process_tpu_torch.models.dictionary import make_dictionary
from slam_process_tpu_torch.models.nn_omp import run_nn_omp
from slam_process_tpu_torch.models.preprocess import preprocess_power
from slam_process_tpu_torch.models.registry import PathsTable, build_scene, paths_table


def run_v13(session, angle_file, output_path=None, preprocess: str = "adaptive",
            **overrides) -> PathsTable:
    """The ``nn_omp_v13`` entry: the paths table (AoA, AoD, Power,
    PathType); with ``output_path`` the two-panel figure (needs
    matplotlib).  ``engine="device"`` (default) runs the NN-OMP on
    ``device`` (None: CUDA), ``"host"`` the float64 oracle."""
    device = overrides.get("device")
    matrix, ue_ang, bs_ang = build_scene(session, angle_file, False, device=device)
    processed = preprocess_power(matrix, preprocess)
    d = make_dictionary(ue_ang, bs_ang, DictionaryConfig(
        grid_res=overrides.get("grid_res", 0.1), beam_width=overrides.get("beam_width", 1.4),
        grid_kind="arange"))
    paths = run_nn_omp(d, matrix, OmpConfig(max_paths=overrides.get("max_paths", 3)),
                       keep_rule="positive", stop_nonpositive=False,
                       engine=overrides.get("engine", "device"), device=device)
    classified = classify_argmax(paths.aoa, paths.aod, paths.power, paths.valid)
    if output_path is not None:
        from slam_process_tpu_torch.render.estimators import plot_v13_comparison

        plot_v13_comparison(matrix, processed, ue_ang, bs_ang, classified, output_path,
                            preprocess, device=device)
    return paths_table(classified)
