"""Stream-order compaction of masked rows.

``compact_rows(rows, mask, capacity)`` packs ``rows[mask]`` ([F, W] int32,
in stream order) into a dense [capacity, W] buffer: rows past the first
``capacity`` masked ones are dropped, and the tail is zero.  With ``out``
and ``offset`` (an int32 device scalar) it appends instead: the masked
rows land at ``out[offset:]`` while they stay below ``capacity``, and the
other rows of ``out`` are left as they are.  Both forms also return the
total masked count, not clamped, as an int32 scalar tensor.

``compact_rows_multi(rows, mask, dests)`` does the same for one or two
destinations at once, each ``(capacity, out or None, offset or None)``,
with the same ranks: one launch and one read of the mask and the rows.  The
two ``out`` tensors must be different tensors.

The device streaming session compacts its open-group carry with the first
form and, in one ``compact_rows_multi`` call, appends a window's kept rows
to its emit ring and compacts them for its online paths.  Both functions
launch kernel K5 (``ops/cuda_compact.py``) on CUDA tensors and run the
plain version on CPU tensors; the plain version is what
``slam_process_tpu/ops/pallas_compact.py::compact_rows_pallas`` computes,
``rows[mask][:capacity]`` zero-padded, once per destination.

``compact_rows_streams(rows, mask, dests)`` is the stream axis: rows [S, F,
W] and masks [S, F], each destination ``(capacity, out [S, >= capacity, W]
or None, offsets int32 [S] or None)``; stream s compacts into ``out[s]`` at
``offsets[s]``.  One launch of K5 for all S on CUDA tensors; on CPU tensors
``compact_rows_multi_plain`` per stream.  The multi-stream session uses
it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from slam_process_tpu_torch.ops import cuda_compact

Dest = Tuple[int, Optional[torch.Tensor], Optional[torch.Tensor]]


def compact_rows_plain(rows: torch.Tensor, mask: torch.Tensor, capacity: int,
                       out: Optional[torch.Tensor] = None,
                       offset: Optional[torch.Tensor] = None):
    """Plain PyTorch compaction: (out, count), see the module docstring."""
    count = mask.sum(dtype=torch.int32)
    sel = rows[mask]
    if out is None:
        out = rows.new_zeros((capacity, rows.shape[1]))
    start = 0 if offset is None else int(offset)
    take = max(0, min(sel.shape[0], capacity - start))
    out[start:start + take] = sel[:take]
    return out, count


def compact_rows_multi_plain(rows: torch.Tensor, mask: torch.Tensor, dests: Sequence[Dest]):
    """Plain PyTorch form of ``compact_rows_multi``: one
    ``compact_rows_plain`` call per destination.  Returns ([out...],
    count)."""
    done = [compact_rows_plain(rows, mask, cap, out, offset) for cap, out, offset in dests]
    return [out for out, _ in done], done[0][1]


def compact_rows(rows: torch.Tensor, mask: torch.Tensor, capacity: int,
                 out: Optional[torch.Tensor] = None, offset: Optional[torch.Tensor] = None):
    """Masked rows in stream order into ``out`` (a new zero-tailed
    [capacity, W] buffer when None) at ``offset``: kernel K5 on CUDA
    tensors, the plain version on CPU tensors.  Returns (out, count)."""
    outs, count = compact_rows_multi(rows, mask, [(capacity, out, offset)])
    return outs[0], count


def compact_rows_multi(rows: torch.Tensor, mask: torch.Tensor, dests: Sequence[Dest]):
    """Masked rows in stream order into one or two destinations, each
    ``(capacity, out or None, offset or None)`` as in ``compact_rows``:
    one launch of kernel K5 on CUDA tensors, the plain version on CPU
    tensors.  Returns ([out per destination], count)."""
    if not 1 <= len(dests) <= 2:
        raise ValueError(f"compaction takes one or two destinations, got {len(dests)}")
    if rows.is_cuda:
        return cuda_compact.compact_rows_multi_cuda(rows, mask, dests)
    if rows.device.type != "cpu":
        raise ValueError(f"compaction runs on CUDA or CPU tensors, got {rows.device}")
    return compact_rows_multi_plain(rows, mask, dests)


def compact_rows_streams_plain(rows: torch.Tensor, mask: torch.Tensor, dests: Sequence[Dest]):
    """Plain PyTorch stream axis: ``compact_rows_multi_plain`` on each
    stream.  Returns ([out [S, capacity, W] per destination], count [S])."""
    s_n, _, width = rows.shape
    outs = [rows.new_zeros((s_n, cap, width)) if out is None else out for cap, out, _ in dests]
    counts = []
    for i in range(s_n):
        per = [(cap, out[i], None if off is None else off[i])
               for (cap, _, off), out in zip(dests, outs)]
        counts.append(compact_rows_multi_plain(rows[i], mask[i], per)[1])
    return outs, torch.stack(counts) if counts else rows.new_zeros(0, dtype=torch.int32)


def compact_rows_streams(rows: torch.Tensor, mask: torch.Tensor, dests: Sequence[Dest]):
    """Masked rows of S streams, each in stream order, into one or two
    per-stream destinations (see the module docstring): one launch of
    kernel K5 on CUDA tensors, the plain version on CPU tensors.  Returns
    ([out per destination], count [S])."""
    if not 1 <= len(dests) <= 2:
        raise ValueError(f"compaction takes one or two destinations, got {len(dests)}")
    if rows.is_cuda:
        return cuda_compact.compact_rows_streams_cuda(rows, mask, dests)
    if rows.device.type != "cpu":
        raise ValueError(f"compaction runs on CUDA or CPU tensors, got {rows.device}")
    return compact_rows_streams_plain(rows, mask, dests)
