"""Profiler traces of a pipeline run, and named regions in them.

The counterpart of ``slam_process_tpu/utils/profiling.py``'s ``trace`` and
``annotate``: a ``torch.profiler`` trace of the CPU and, where there is
one, the CUDA device, written as a Chrome trace (``trace.json``) into a
directory, for ``cli session --profile DIR``; and a named range in it
(``utils/device_timing.module_device_times`` reads the ranges back).
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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region of the trace: a ``torch.profiler.record_function``
    range (a ``user_annotation`` event in the Chrome trace) and, where
    there is a CUDA device, an NVTX range of the same name."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
