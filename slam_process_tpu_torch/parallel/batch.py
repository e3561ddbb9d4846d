"""Batched multi-session pipeline on one device.

The port of ``slam_process_tpu/parallel/batch.py``'s one-device half: S
sessions, padded to one byte width and stacked to [S, N], run the session
pipeline as one batch (``session_axis="vmap"``,
``pipeline/device.session_pipeline_batch``): one launch of kernel K1 over
the [S, N] bytes, one of K2 for all S sessions' rows (group ids offset per
session, ``ops/correct.py``), the intensity sums of all S grids in one
``index_add_`` and one launch of K3 over the [S, 64, 64] tiles.
``session_axis="scan"`` is JAX's ``lax.map`` form: a loop of the
single-session pipeline, S launches per stage, with outputs equal bit for
bit to the batch's.  On CPU tensors every kernel's plain version runs.

Where the JAX package takes a mesh and shards S over its ``data`` axis, the
port takes ``mesh=None`` and ``device=`` (``pipeline/device.require_no_mesh``).
There is nothing to compile, so ``batched_session_pipeline`` returns a
plain function and nothing is cached.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from slam_process_tpu_torch.pipeline.device import (
    DeviceSessionOut, bucket_size, device_lut, pad_bytes, require_no_mesh, resolve_device,
    session_pipeline, session_pipeline_batch)


class SessionSummaryOut(NamedTuple):
    """Per-session results without the [S, R] frame tensors."""

    n_frames: torch.Tensor          # [S] i32
    correct_overflow: torch.Tensor  # [S] bool
    n_kept: torch.Tensor            # [S] i32
    mean_grid: torch.Tensor         # [S, 64, 64] f32
    counts: torch.Tensor            # [S, 64, 64] i32
    rgba: torch.Tensor              # [S, 64, 64, 4] f32
    blurred: torch.Tensor           # [S, 64, 64] f32
    norm_t: torch.Tensor            # [S, 64, 64] f32


def _stack_outputs(outs: Sequence[DeviceSessionOut]) -> DeviceSessionOut:
    return DeviceSessionOut(*(None if f == "n_discarded" else torch.stack(
        [getattr(o, f) for o in outs]) for f in DeviceSessionOut._fields))


def batched_session_pipeline(mesh, n_bytes_padded: int, blur_sigma: float = 1.0,
                             use_log: bool = True, max_groups: int = 128,
                             max_baselines_per_group: int = 192, outputs: str = "full",
                             session_axis: str = "vmap", *, device=None):
    """An [S, N]-batched pipeline on one device.

    Returns fn(byte_batch [S, N] u8, n_bytes [S] i32, lut [256, 4] f32) ->
    ``DeviceSessionOut`` with a leading S axis on every field
    (``n_discarded`` None), or with ``outputs="summary"`` a
    ``SessionSummaryOut``.  The inputs may be numpy arrays or tensors; they
    are moved to ``device`` (None: CUDA).  ``n_bytes`` is unused: the
    padding is inert, as in the JAX package.  ``session_axis="vmap"`` runs
    the batch (one launch per kernel), ``"scan"`` a loop of the
    single-session pipeline (S launches per kernel), bit-equal to it.
    ``mesh`` must be None.
    """
    require_no_mesh(mesh)
    if outputs not in ("full", "summary"):
        raise ValueError(f"outputs must be 'full' or 'summary', got {outputs!r}")
    if session_axis not in ("vmap", "scan"):
        raise ValueError(f"session_axis must be 'vmap' or 'scan', got {session_axis!r}")
    dev = resolve_device(device)
    n_bytes_padded = int(n_bytes_padded)
    kw = dict(blur_sigma=blur_sigma, use_log=use_log, max_groups=max_groups,
              max_baselines_per_group=max_baselines_per_group)

    def batched(byte_batch, n_bytes, lut) -> DeviceSessionOut:
        del n_bytes
        b = torch.as_tensor(byte_batch, dtype=torch.uint8).to(dev)
        if b.dim() != 2 or b.shape[1] != n_bytes_padded:
            raise ValueError(f"byte_batch must be [S, {n_bytes_padded}], got {tuple(b.shape)}")
        lut_t = torch.as_tensor(lut, dtype=torch.float32).to(dev)
        if session_axis == "scan":
            out = _stack_outputs([session_pipeline(b[i], lut_t, **kw)
                                  for i in range(b.shape[0])])
        else:
            out = session_pipeline_batch(b, lut_t, **kw)
        if outputs == "summary":
            return SessionSummaryOut(*(getattr(out, f) for f in SessionSummaryOut._fields))
        return out

    return batched


def stack_sessions(raw_list: Sequence[np.ndarray], n_bytes_padded: Optional[int] = None):
    """Stack tokenized sessions into a padded [S, N] u8 batch + lengths."""
    if n_bytes_padded is None:
        n_bytes_padded = max(len(r) for r in raw_list)
    batch = np.stack([pad_bytes(r, n_bytes_padded) for r in raw_list])
    lengths = np.asarray([len(r) for r in raw_list], dtype=np.int32)
    return batch, lengths


def run_dataset_batched_grouped(mesh, raw_list: Sequence[np.ndarray], quantum: int = 1 << 18,
                                *, device=None, **pipeline_kwargs):
    """The batch without uniform-padding waste: sessions group by their
    byte bucket (``pipeline.device.bucket_size``) and one batched call runs
    per bucket, so each session is padded only to its own bucket.

    Returns ``[(indices, SessionSummaryOut), ...]``, one entry per bucket
    group in bucket order, each output's rows the sessions at those input
    positions, on ``device`` (None: CUDA).  With one device a group needs no
    padding sessions (JAX pads to a multiple of the mesh's ``data`` size,
    which is 1 here).  ``mesh`` must be None.
    """
    require_no_mesh(mesh)
    dev = resolve_device(device)
    groups: dict = {}
    for i, r in enumerate(raw_list):
        groups.setdefault(bucket_size(len(r), quantum), []).append(i)
    lut = device_lut(dev)
    results = []
    for bucket, idxs in sorted(groups.items()):
        batch, lengths = stack_sessions([raw_list[i] for i in idxs], bucket)
        fn = batched_session_pipeline(None, bucket, outputs="summary", device=dev,
                                      **pipeline_kwargs)
        results.append((idxs, fn(batch, lengths, lut)))
    return results


def run_dataset(mesh, raw_list: Sequence[np.ndarray], *, device=None, **pipeline_kwargs):
    """Every session through the per-bucket batches, ONE device-to-host copy
    per bucket, and per-session ``SessionSummaryOut`` of numpy arrays in
    input order.  Warns (JAX's message) when a session overflowed the
    corrector's bounds.  ``mesh`` must be None; ``device`` None means CUDA.
    """
    grouped = run_dataset_batched_grouped(mesh, raw_list, device=device, **pipeline_kwargs)
    results: list = [None] * len(raw_list)
    for idxs, out in grouped:
        host = _to_host(out)
        for row, orig in enumerate(idxs):
            results[orig] = SessionSummaryOut(*(x[row] for x in host))
    bad = [i for i, r in enumerate(results) if bool(r.correct_overflow)]
    if bad:
        warnings.warn(
            f"corrector capacity exceeded on sessions {bad}: their rows "
            "were silently truncated — re-run with larger max_groups/"
            "max_baselines_per_group", RuntimeWarning, stacklevel=2)
    return results


def _to_host(out: SessionSummaryOut) -> SessionSummaryOut:
    """One device-to-host copy of a bucket's outputs: the fields are packed
    into one byte buffer on the device, copied once and split on the
    host."""
    flat = [x.reshape(-1) for x in out]
    if flat[0].device.type == "cpu":
        return SessionSummaryOut(*(x.numpy() for x in out))
    packed = torch.cat([x.view(torch.uint8) for x in flat]).cpu().numpy()
    fields, pos = [], 0
    for x in out:
        n = x.numel() * x.element_size()
        dtype = np.dtype(str(x.dtype).replace("torch.", ""))
        fields.append(packed[pos:pos + n].view(dtype).reshape(tuple(x.shape)))
        pos += n
    return SessionSummaryOut(*fields)
