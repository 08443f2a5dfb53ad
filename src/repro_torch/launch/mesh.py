"""Device grids for the sharded and tiled detection paths -- the port of
repro/launch/mesh.py's detection builders.

A grid is a small frozen table of ``torch.device`` values with axis
names: ``make_detection_mesh`` lays the frame batch over a 1-D ("data",)
grid, ``make_tiled_mesh`` one frame's pyramid over the "tile" axis of a
("data", "tile") grid (core/detector.py runs the programs; tiles on one
device run one after another). Both raise the reference's ValueErrors
when the host has too few devices; there is no silent fallback.

``visible_devices(device)`` lists what the host offers: every CUDA card
for a CUDA entry point, one CPU for a CPU one. ``REPRO_TEST_DEVICES=N``
(the reference's knob, repro/platform.py) presents N logical devices
instead, the entry point's device repeated, so one card or the CPU runs
the multi-device schedules as tests and smoke runs check them.

The LM training meshes (``make_production_mesh``, ``make_host_mesh``)
belong with LM training, which the port does not run yet.
"""
from __future__ import annotations

import dataclasses
import os
from typing import MutableMapping, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """Devices laid out on named axes: ``devices[r]`` is row r of a 2-D
    grid (a tuple of devices), or device r of a 1-D one."""

    devices: tuple
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        if len(self.axis_names) == 1:
            return (len(self.devices),)
        return (len(self.devices), len(self.devices[0]))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def forced_devices(env: Optional[MutableMapping] = None) -> int:
    """$REPRO_TEST_DEVICES as a count, 0 when unset or empty."""
    env = os.environ if env is None else env
    n = env.get("REPRO_TEST_DEVICES", "")
    return int(n) if n else 0


def visible_devices(device=None) -> Tuple[torch.device, ...]:
    """The devices an entry point on ``device`` may spread over: N copies
    of ``device`` under REPRO_TEST_DEVICES=N, else every CUDA card for a
    CUDA device (``torch.cuda.device_count()``) and the one CPU for the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    forced = forced_devices()
    if forced:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return (dev,) * forced
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def make_detection_mesh(data_parallel: int = 0,
                        device=None) -> DeviceGrid:
    """1-D ("data",) grid for sharded detection: ``data_parallel=0``
    takes every visible device, ``n > 0`` exactly the first n, and a
    ValueError names the count when the host has fewer."""
    devs = visible_devices(device)
    n = len(devs)
    data = n if data_parallel == 0 else int(data_parallel)
    if not 1 <= data <= n:
        raise ValueError(
            f"make_detection_mesh(data_parallel={data_parallel}): the "
            f"host has {n} visible device(s) (visible_devices()); "
            f"data_parallel must be 0 (= all) or in [1, {n}]")
    return DeviceGrid(devs[:data], ("data",))


def make_tiled_mesh(data_parallel: int = 1, frame_parallel: int = 0,
                    device=None) -> DeviceGrid:
    """2-D ("data", "tile") grid for intra-frame tiled detection: the
    batch over "data" as in make_detection_mesh, each frame's pyramid
    over "tile"; ``frame_parallel=0`` takes every device left over after
    the data axis."""
    devs = visible_devices(device)
    n = len(devs)
    dp = n if data_parallel == 0 else int(data_parallel)
    if dp < 1 or dp > n:
        raise ValueError(
            f"make_tiled_mesh(data_parallel={data_parallel}): the host "
            f"has {n} visible device(s) (visible_devices()); data_parallel "
            f"must be 0 (= all) or in [1, {n}]")
    fp = (n // dp) if frame_parallel == 0 else int(frame_parallel)
    if fp < 1 or dp * fp > n:
        raise ValueError(
            f"make_tiled_mesh(data_parallel={data_parallel}, "
            f"frame_parallel={frame_parallel}): with {n} visible "
            f"device(s) and data_parallel={dp}, frame_parallel must be "
            f"0 (= all remaining) or in [1, {n // dp}]")
    return DeviceGrid(tuple(tuple(devs[r * fp:(r + 1) * fp])
                            for r in range(dp)), ("data", "tile"))
