"""Profiler traces of a pipeline run, and named spans in them.

The counterpart of ``slam_process_tpu/utils/profiling.py``'s ``trace`` and
``annotate``: a ``torch.profiler`` trace of the CPU and, where there is
one, the CUDA device, written as a Chrome trace (``trace.json``) into a
directory, for ``cli session --profile DIR`` and ``cli replay --profile
DIR``; and a named span in it (``annotate``).

The port's spans mark its layer boundaries, named ``slam.<layer>.<step>``
(``slam.batch.stack``, ``slam.stream.round``, ``slam.graph.capture``, ...):
each is a ``record_function`` range while a profiler runs, so it lands on
the profiler's clock beside the device activities, and the device's idle
gaps can be named by the host step they fell in.  Spans of one thread
nest by time.  With no profiler running a span is one shared no-op
context.  ``utils/device_timing.module_device_times`` reads the ranges
back.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import ContextManager, Iterator, Union

import torch

# What ``annotate`` returns while no profiler runs: nothing to open or close.
NO_SPAN = contextlib.nullcontext()


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


def annotate(name: str) -> ContextManager:
    """A named span of the trace: while a profiler runs, a
    ``torch.profiler.record_function`` range (a ``user_annotation`` event
    in the Chrome trace), else ``NO_SPAN``, which costs one check."""
    if not torch.autograd._profiler_enabled():
        return NO_SPAN
    return torch.profiler.record_function(name)
