"""Device mesh: the JAX package's ``data x model`` layout over torch devices.

The port of ``slam_process_tpu/parallel/mesh.py``.  A ``Mesh`` is an
ndarray of ``torch.device`` with axis names:

  * ``data``: sessions, sweeps or streams are cut into contiguous shards,
    one per mesh row, padded to a multiple of the row count as the JAX
    package pads them (empty sessions, all-NaN sweeps, inert streams);
  * ``model``: the NN-OMP estimators' AoA grid is cut into contiguous
    slices, one per position of a row (``models/nn_omp.py``); every other
    stage runs a shard once, on its row's first device, where the JAX
    package only replicates it over ``model``.

A shard's work is issued on its device, device after device, and its
results cross to the host once.  Positions may name one device more than
once (``devices=[torch.device("cpu")] * 8``): that is how one card or the
CPU holds the JAX package's (8, 1) and (4, 2) layouts.  It changes no
result: every shard computes what it would compute on a device of its own.

Across processes (``parallel/multihost.py``) a mesh also records which
process owns each position (``processes``) and which process this is; a
process computes only its own rows (``local``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from slam_process_tpu_torch.pipeline.device import resolve_device


class Mesh:
    """An ndarray of ``torch.device`` with named axes; hashable, so caches
    can key on it.  ``processes`` (same shape, default all 0) names the
    process that owns each position and ``process_index`` this process."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None, process_index: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {devices.shape} has {len(self.axis_names)} axis "
                             f"names {self.axis_names}")
        if "data" not in self.axis_names:
            raise ValueError(f"a mesh needs a 'data' axis, got {self.axis_names}")
        self.processes = (np.zeros(devices.shape, np.int64) if processes is None
                          else np.asarray(processes, np.int64).reshape(devices.shape))
        self.process_index = int(process_index)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (self.devices.shape, tuple(str(d) for d in self.devices.flat), self.axis_names,
                tuple(self.processes.flat), self.process_index)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"

    def _rows_array(self, arr: np.ndarray) -> np.ndarray:
        """``arr`` (the mesh's shape) as [data, rest]: row r lists the
        positions of data index r, the model axis in order."""
        axis = self.axis_names.index("data")
        return np.moveaxis(arr, axis, 0).reshape(self.devices.shape[axis], -1)

    def rows(self) -> list:
        """One tuple of devices per data index; the first is the row's own."""
        return [tuple(r) for r in self._rows_array(self.devices)]

    def local(self) -> "Mesh":
        """The rows this process owns, as a mesh of their own.  The model
        axis must lie within one process: a row whose positions belong to
        several processes raises, naming the layout."""
        owners = self._rows_array(self.processes)
        split = [r for r in range(len(owners)) if len(set(owners[r])) > 1]
        if split:
            raise ValueError(
                f"mesh {dict(self.shape)} puts the model axis of data rows {split} across "
                f"processes (owners {owners[split[0]].tolist()}); the model axis must lie "
                "within one process: use model <= the local device count")
        mine = [r for r in range(len(owners)) if owners[r][0] == self.process_index]
        if not mine:
            raise ValueError(f"process {self.process_index} owns no row of mesh "
                             f"{dict(self.shape)}")
        devs = self._rows_array(self.devices)[mine]
        return Mesh(devs.reshape((len(mine),) + self._model_shape()), ("data",)
                    + tuple(a for a in self.axis_names if a != "data"),
                    np.full(devs.shape, self.process_index), self.process_index)

    def _model_shape(self) -> tuple:
        return tuple(n for a, n in self.shape.items() if a != "data")


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "model"), devices=None) -> Mesh:
    """A mesh over ``devices`` (None: every CUDA device, which raises where
    there is none).  ``shape=None`` puts every device on ``data``, with the
    other axes 1.  Positions may repeat a device (module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a mesh; pass devices= (for example "
                               "[torch.device('cpu')] * 8), or device= to run on one device")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axis_names)


def shard_rows(n: int, dp: int) -> Tuple[int, int]:
    """(n padded to a multiple of dp, rows per shard)."""
    n_pad = -(-n // dp) * dp
    return n_pad, n_pad // dp


def read_once(results: list) -> list:
    """Host copies of a list of tensor tuples (NamedTuples stay NamedTuples)
    on one device, in one device-to-host read: every field is widened to
    float64 (exact for float32, int32 and bool) and concatenated."""
    flat = [x for r in results for x in r]
    packed = torch.cat([x.reshape(-1).to(torch.float64) for x in flat]).cpu().numpy()
    out, off = [], 0
    for r in results:
        fields = []
        for x in r:
            n = x.numel()
            dtype = np.dtype(str(x.dtype).replace("torch.", ""))
            fields.append(packed[off:off + n].reshape(tuple(x.shape)).astype(dtype))
            off += n
        out.append(type(r)(*fields) if hasattr(r, "_fields") else tuple(fields))
    return out


def read_per_device(results: list) -> list:
    """``read_once`` for tensor tuples that lie on several devices: one read
    per device, results in the input order."""
    by_dev: dict = {}
    for i, r in enumerate(results):
        by_dev.setdefault(r[0].device, []).append(i)
    out: list = [None] * len(results)
    for idx in by_dev.values():
        for i, host in zip(idx, read_once([results[i] for i in idx])):
            out[i] = host
    return out


def placement(mesh: Optional[Mesh], device=None) -> list:
    """The rows work runs on, each a tuple of devices (the first is the
    row's own): this process's rows of ``mesh`` (``Mesh.local``), or without
    a mesh one row of ``device`` (None: CUDA).  Passing both raises."""
    if mesh is None:
        return [(resolve_device(device),)]
    if device is not None:
        raise ValueError("pass mesh= or device=, not both: a mesh names its own devices")
    return mesh.local().rows()
