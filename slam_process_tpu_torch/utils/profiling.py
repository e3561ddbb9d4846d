"""Profiler traces of a pipeline run.

The counterpart of ``slam_process_tpu/utils/profiling.py::trace``: a
``torch.profiler`` trace of the CPU and, where there is one, the CUDA
device, written as a Chrome trace (``trace.json``) into a directory, for
``cli session --profile DIR``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Union

import torch


@contextlib.contextmanager
def trace(log_dir: Union[str, Path, None]) -> Iterator[None]:
    """Profile the body into ``log_dir/trace.json`` (nothing if None)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / "trace.json"))
