"""``run-config`` of the port's CLI against the JAX CLI's, all five named
configs, in process on a synthetic data directory of the dataset's layout
(two multipath logs and one filtered xlsx) with ``--device cpu``.

Each result dict equals the JAX package's once its timing keys
(``timings_s``, ``elapsed_s``, ``frames_per_sec``, ``host_frames_per_sec``)
and the output directory are cut, except ``bs_beam_correction``'s paths
records, whose angles and power (the port's float32 NN-OMP against the
JAX package's float64 host engine) agree within rtol 2e-4 with the same
path types.  The configs that draw PNGs draw them.
"""

import json

import numpy as np
import pytest

from slam_process_tpu.pipeline import cli as jax_cli
from slam_process_tpu.pipeline.session import Session as JaxSession
from slam_process_tpu_torch.pipeline import cli
from slam_process_tpu_torch.pipeline.configs import NAMED_CONFIGS, run_named_config
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)

TIMING = {"timings_s", "elapsed_s", "frames_per_sec", "host_frames_per_sec"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("configs")
    dd = root / "debugDoc"
    dd.mkdir()
    for i in range(2):
        raw = synthetic_session_bytes(n_groups=3, frames_per_beam=4, baselines_per_group=9,
                                      junk_frac=0.05, seed=30 + i, n_paths=3)
        (dd / f"Serial Debug 2026-01-2{i} 16452{i}.txt").write_bytes(to_hex_text(raw))
    s = JaxSession.from_log(sorted(dd.glob("*.txt"))[0])
    s.correct()
    s.export_filtered(dd / f"{s.name}_filtered.xlsx")
    return root, dd, write_angle_table(root / "beam_angle.xlsx")


def result(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return json.loads(line)


@pytest.mark.parametrize("name", list(NAMED_CONFIGS))
def test_run_config_matches_jax(data, capsys, name):
    root, dd, angles = data
    argv = ["run-config", name, "--data-dir", str(dd), "--mapping", str(angles)]
    got = result(cli.main, argv + ["--outdir", str(root / "port"), "--device", "cpu"], capsys)
    want = result(jax_cli.main, argv + ["--outdir", str(root / "jax")], capsys)
    assert TIMING & set(got) == TIMING & set(want)
    got, want = ({k: v for k, v in d.items() if k not in TIMING} for d in (got, want))
    got = json.loads(json.dumps(got).replace(str(root / "port"), "OUT"))
    want = json.loads(json.dumps(want).replace(str(root / "jax"), "OUT"))
    if name == "bs_beam_correction":
        g_paths, w_paths = got.pop("paths"), want.pop("paths")
        assert len(g_paths) == len(w_paths) > 1
        assert [list(p) for p in g_paths] == [list(p) for p in w_paths]
        assert [p["PathType"] for p in g_paths] == [p["PathType"] for p in w_paths]
        for col in ("AoA", "AoD", "Power"):
            np.testing.assert_allclose([p[col] for p in g_paths], [p[col] for p in w_paths],
                                       rtol=2e-4, err_msg=col)
        assert (root / "port" / "2026-01-20 164520_corrected_render.png").stat().st_size > 10_000
    assert got == want
    if name == "excel_heatmap_v3":
        assert (root / "port" / "2026-01-20 164520_heatmap.png").stat().st_size > 10_000
    if name in ("batched_session", "streaming_replay"):
        assert got["total_frames"] == 2 * 768


def test_run_config_needs_the_dataset_paths(tmp_path):
    with pytest.raises(ValueError, match="--data-dir DIR --mapping"):
        run_named_config("batched_session", outdir=tmp_path, device="cpu")
    with pytest.raises(KeyError, match="unknown config"):
        run_named_config("nope", tmp_path, tmp_path, tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="no .txt logs"):
        run_named_config("batched_session", tmp_path, tmp_path / "a.xlsx", tmp_path,
                         device="cpu")
