"""Device meshes: a ``[time, channels]`` grid of torch devices.

Port of ``tsl_sdr_tpu/parallel/mesh.py``. JAX's ``Mesh`` names devices its
runtime owns; here a :class:`Mesh` is a plain grid of ``torch.device``
entries, which may repeat (``["cpu"] * 8`` stands for eight devices in the
tests, ``[cuda:0] * 4`` for four on one card), and, across processes
(:mod:`tsl_sdr_tpu_torch.parallel.multihost`), the rank that owns each time
row. The time axis walks the ranks in order, so each rank's rows are one
contiguous stretch of stream time.
"""

from __future__ import annotations

import numpy as np
import torch

TIME_AXIS = "time"
CHANNEL_AXIS = "channels"


class Mesh:
    """``devices`` ``[time, channels]`` of ``torch.device``; ``ranks``
    ``[time]``, the process that owns each time row (all ``rank`` in one
    process); ``rank``, this process's."""

    axis_names = (TIME_AXIS, CHANNEL_AXIS)

    def __init__(self, devices, ranks=None, rank: int = 0):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2 or not grid.size:
            raise ValueError(f"mesh devices must be a non-empty [time, "
                             f"channels] grid, got shape {grid.shape}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, dev in np.ndenumerate(grid):
            self.devices[idx] = torch.device(dev)
        self.rank = int(rank)
        self.ranks = (np.full(grid.shape[0], self.rank, np.int64)
                      if ranks is None else np.asarray(ranks, np.int64))
        if self.ranks.shape != (grid.shape[0],) or \
                np.any(np.diff(self.ranks) < 0):
            raise ValueError("ranks must give one rank a time row, in "
                             "non-decreasing order")

    @property
    def shape(self) -> dict:
        t, c = self.devices.shape
        return {TIME_AXIS: t, CHANNEL_AXIS: c}

    @property
    def multiprocess(self) -> bool:
        """Whether time rows belong to other processes."""
        return bool(np.any(self.ranks != self.rank))

    @property
    def local_rows(self) -> list:
        """This process's time rows, in time order."""
        return [t for t in range(len(self.ranks)) if self.ranks[t] == self.rank]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={self.devices.tolist()}, "
                f"ranks={self.ranks.tolist()})")


def cuda_devices() -> list:
    """Every CUDA device this process sees (``CUDA_VISIBLE_DEVICES``
    selects them); raises where there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("no CUDA device; pass devices= (for example "
                           "['cpu'] * n) to build a mesh without one")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(time: int | None = None, channels: int = 1,
              devices=None) -> Mesh:
    """A ``(time, channels)`` mesh over ``devices`` (default: every CUDA
    device, :func:`cuda_devices`). ``time=None`` puts every remaining
    device on the time axis. A device may appear more than once."""
    if devices is None:
        devices = cuda_devices()
    devices = list(devices)
    n = len(devices)
    if time is None:
        if n % channels:
            raise ValueError(f"{n} devices not divisible by "
                             f"channels={channels}")
        time = n // channels
    if time * channels > n:
        raise ValueError(f"mesh {time}x{channels} needs {time * channels} "
                         f"devices, have {n}")
    grid = np.empty((time, channels), dtype=object)
    for k in range(time * channels):
        grid[k // channels, k % channels] = devices[k]
    return Mesh(grid)
