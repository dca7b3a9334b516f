"""The device mesh: a grid of ``torch.device``s with named axes.

Counterpart of ``fluidframework_tpu/parallel/mesh.py``. Documents are
independent, so the scaling axis is ``"docs"``: each device owns a
contiguous block of doc rows. A second ``"replica"`` axis holds redundant
copies of each doc shard (the Broadcaster fan-out becomes a copy of the
sequenced op batch to every replica's device).

The mesh is single-process and single-controller, as a JAX mesh is: the
host enqueues every shard's work on that shard's device. No
``torch.distributed`` process group is involved. ``devices`` may name one
card several times: a one-card machine then runs the per-shard path (as
JAX's virtual CPU devices do), and ``device="cpu"`` gives n CPU shards
for the tests.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DOC_AXIS = "docs"
REPLICA_AXIS = "replica"


class Mesh:
    """A grid of devices with one name per axis. ``devices`` is an object
    array of ``torch.device`` of the grid's shape."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        for dev in devices.flat:
            _check_device(dev)
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def doc_devices(self, replica: int = 0) -> list:
        """The devices of the doc shards, in row-block order (those of
        replica ``replica`` on a (replica, docs) mesh)."""
        if self.axis_names == (DOC_AXIS,):
            return list(self.devices)
        if self.axis_names == (REPLICA_AXIS, DOC_AXIS):
            return list(self.devices[replica])
        raise ValueError(f"mesh axes {self.axis_names} have no docs axis")

    def __repr__(self) -> str:
        grid = np.vectorize(str, otypes=[object])(self.devices).tolist()
        return f"Mesh({self.shape}, {grid})"


def _check_device(dev) -> None:
    """A mesh names devices that exist: no quiet fall-back to another."""
    if not isinstance(dev, torch.device):
        raise TypeError(f"mesh devices are torch.device, got {dev!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to build a mesh of CPU shards")
        if dev.index is None or dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev} does not exist (this host has "
                             f"{torch.cuda.device_count()} cards)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}")


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` → ``cuda:<current card>``: a shard names its card."""
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_devices(n_devices: Optional[int], device="cuda",
                 devices: Optional[Sequence] = None) -> list:
    """The flat device list of a mesh: ``devices`` as given (a card may
    appear more than once), else the first ``n_devices`` cards
    (default: every card ``torch.cuda.device_count()`` reports), else
    ``n_devices`` CPU shards when ``device="cpu"``."""
    if devices is not None:
        out = [_indexed(torch.device(d)) for d in devices]
        if n_devices is not None and n_devices != len(out):
            raise ValueError(f"n_devices={n_devices} but {len(out)} devices")
        for d in out:
            _check_device(d)
        return out
    kind = torch.device(device).type
    if kind == "cpu":
        if n_devices is None:
            raise ValueError("a CPU mesh needs n_devices")
        return [torch.device("cpu")] * n_devices
    if kind != "cuda":
        raise ValueError(f"unsupported mesh device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "build a mesh of CPU shards")
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(f"{n} cards asked for, this host has {have} (name "
                         "a card several times with devices=[...])")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None,
              replicas: Optional[int] = None, device="cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """(replica, docs) mesh over the devices. ``replicas`` defaults to 2
    when the device count is even and > 1 (so the cross-replica digest
    check is meaningful), else 1."""
    flat = mesh_devices(n_devices, device, devices)
    n = len(flat)
    if replicas is None:
        replicas = 2 if n % 2 == 0 and n > 1 else 1
    if n % replicas != 0:
        raise ValueError(f"{n} devices do not split into {replicas} "
                         "replicas")
    grid = np.empty((n,), dtype=object)
    grid[:] = flat
    return Mesh(grid.reshape(replicas, n // replicas),
                (REPLICA_AXIS, DOC_AXIS))
