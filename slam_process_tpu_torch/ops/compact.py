"""Stream-order compaction of masked rows.

``compact_rows(rows, mask, capacity)`` packs ``rows[mask]`` ([F, W] int32,
in stream order) into a dense [capacity, W] buffer: rows past the first
``capacity`` masked ones are dropped, and the tail is zero.  With ``out``
and ``offset`` (an int32 device scalar) it appends instead: the masked
rows land at ``out[offset:]`` while they stay below ``capacity``, and the
other rows of ``out`` are left as they are.  Both forms also return the
total masked count, not clamped, as an int32 scalar tensor.

The device streaming session compacts its open-group carry with the first
form, appends kept rows to its emit ring with the second, and compacts the
kept rows its online paths segment.  ``compact_rows`` launches kernel K5
(``ops/cuda_compact.py``) on CUDA tensors and runs ``compact_rows_plain``
on CPU tensors; the plain version is what ``slam_process_tpu/ops/
pallas_compact.py::compact_rows_pallas`` computes, ``rows[mask][:capacity]``
zero-padded.
"""

from __future__ import annotations

from typing import Optional

import torch

from slam_process_tpu_torch.ops import cuda_compact


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


def compact_rows(rows: torch.Tensor, mask: torch.Tensor, capacity: int,
                 out: Optional[torch.Tensor] = None, offset: Optional[torch.Tensor] = None):
    """Masked rows in stream order into ``out`` (a new zero-tailed
    [capacity, W] buffer when None) at ``offset``: kernel K5 on CUDA
    tensors, the plain version on CPU tensors.  Returns (out, count)."""
    if rows.is_cuda:
        return cuda_compact.compact_rows_cuda(rows, mask, capacity, out, offset)
    if rows.device.type != "cpu":
        raise ValueError(f"compaction runs on CUDA or CPU tensors, got {rows.device}")
    return compact_rows_plain(rows, mask, capacity, out, offset)
