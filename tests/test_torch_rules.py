"""Rules of the port package (slam_process_tpu_torch).

  * It imports torch and numpy, never jax, the JAX package
    (``slam_process_tpu`` as a whole module name), matplotlib or pandas:
    checked by AST over every file and by importing every module in a
    fresh interpreter.
  * Entry points take ``device=None`` meaning CUDA, and raise when there is
    no CUDA device instead of moving to the CPU.
  * The kernel wrappers launch or raise: a CPU tensor handed to one raises.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "slam_process_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "slam_process_tpu", "matplotlib", "pandas"}
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    assert not set(imported_roots(path)) & FORBIDDEN


def test_importing_every_module_loads_no_jax():
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts).replace(
        ".__init__", "") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
            "print(len(bad), bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.startswith("0 "), out


def test_entry_points_need_cuda_without_falling_back(monkeypatch, tmp_path):
    from slam_process_tpu_torch.pipeline.device import run_session_on_device
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = synthetic_session_bytes(n_groups=1, frames_per_beam=1, baselines_per_group=1)
    path = tmp_path / "s.txt"
    path.write_bytes(to_hex_text(raw))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_session_on_device(raw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session.from_log(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_session_on_device(raw, device="cuda")
    assert int(run_session_on_device(raw, device="cpu").n_frames) == 64

    from slam_process_tpu_torch.utils.synthetic import write_angle_table

    s = Session.from_log(path, device="cpu")
    angles = write_angle_table(tmp_path / "angles.xlsx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.sweep_paths(angles)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.sweep_intensity()
    assert s.sweep_intensity(device="cpu")[1].sum() == len(s.filtered)


def test_kernel_wrappers_refuse_cpu_tensors():
    from slam_process_tpu_torch.ops import cuda_correct, cuda_decode, cuda_raster, cuda_sweep_sums

    kernels = (cuda_decode, cuda_correct, cuda_raster, cuda_sweep_sums)
    for m in kernels:
        m.LAUNCHES = 0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_decode.decode_rows_cuda(torch.zeros(22, dtype=torch.uint8), 22, 0xCC, 0x33)
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_correct.correct_verdicts_cuda(i32, i32, torch.zeros(2, 4), bmax=1, cycle=61_000,
                                           tol=500)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_raster.raster_tiles_cuda(torch.zeros(1, 4, 4), torch.zeros(256, 4),
                                      torch.ones(1, 1), True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep_sums.sweep_sums_cuda(i32, i32, i32, 2)
    assert [m.LAUNCHES for m in kernels] == [0, 0, 0, 0]


def test_dispatch_refuses_other_devices():
    from slam_process_tpu_torch.ops.decode import decode_rows

    with pytest.raises(ValueError, match="CUDA or CPU"):
        decode_rows(torch.zeros(22, dtype=torch.uint8, device="meta"))


def test_synthetic_session_is_seeded_and_exact():
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    kw = dict(n_groups=3, frames_per_beam=2, baselines_per_group=7, junk_frac=0.5,
              big_group=300, seed=4)
    a, b = synthetic_session_bytes(**kw), synthetic_session_bytes(**kw)
    np.testing.assert_array_equal(a, b)
    res = decode_frames_np(a)
    assert res.valid == 64 * (5 + 2 + 2)
    corr = correct_frames_np(res.frames)
    assert corr.n_groups == 3 and corr.n_baselines == 3 * 7
