"""Device grids (port of repro/launch/mesh.py).

A grid is a small frozen table of ``torch.device`` values on named axes,
nested tuples one level an axis. Detection: ``make_detection_mesh`` lays
the frame batch over a 1-D ("data",) grid, ``make_tiled_mesh`` one
frame's pyramid over the "tile" axis of a ("data", "tile") grid
(core/detector.py runs the programs; tiles on one device run one after
another). The LM: ``make_host_mesh`` is a ("data", "model") grid over the
visible devices, ``make_production_mesh`` the reference's (16, 16)
("data", "model") or (2, 16, 16) ("pod", "data", "model") pod grid; the
sharding rules (sharding/rules.py), the expert-parallel MoE
(models/moe.py), the sharded and pipelined trainers (train/) read them.
Each of these functions raises the reference's kind of ValueError when
the host has too few devices; there is no silent fallback.

``visible_devices(device)`` lists what the host offers: every CUDA card
for a CUDA entry point, one CPU for a CPU one. ``REPRO_TEST_DEVICES=N``
(the reference's knob, repro/platform.py) presents N logical devices
instead, the entry point's device repeated, so one card or the CPU runs
the multi-device schedules as tests and smoke runs check them.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, MutableMapping, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """Devices laid out on named axes: ``devices[i][j]...`` is the device
    at index (i, j, ...), one tuple level an axis (a 1-D grid is a tuple
    of devices)."""

    devices: tuple
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        out, level = [], self.devices
        for _ in self.axis_names:
            out.append(len(level))
            level = level[0]
        return tuple(out)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """The size of each axis by name (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def indices(self):
        """Every index of the grid, row-major (the last axis fastest)."""
        return itertools.product(*(range(n) for n in self.shape))

    def device(self, index) -> torch.device:
        d = self.devices
        for i in index:
            d = d[i]
        return d

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        """The devices in row-major order."""
        return tuple(self.device(i) for i in self.indices())


def grid_of(devices, shape: Tuple[int, ...],
            axis_names: Tuple[str, ...]) -> DeviceGrid:
    """A grid of ``shape`` over the first prod(shape) of ``devices``,
    row-major."""
    devs = list(devices)

    def nest(dims, start):
        if len(dims) == 1:
            return tuple(devs[start:start + dims[0]])
        step = 1
        for n in dims[1:]:
            step *= n
        return tuple(nest(dims[1:], start + i * step) for i in range(dims[0]))

    return DeviceGrid(nest(tuple(shape), 0), tuple(axis_names))


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
    return grid_of(devs, (dp, fp), ("data", "tile"))


def production_layout(multi_pod: bool = False
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production grid's shape and axis names (make_production_mesh)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceGrid:
    """16 x 16 ("data", "model") single pod (256 devices) or 2 x 16 x 16
    ("pod", "data", "model") two pods (512): "pod" carries only gradient
    reductions and pipeline hops, "data" is FSDP and batch, "model"
    tensor, expert and sequence parallelism. Raises the reference's
    ValueError (jax.make_mesh's) unless that many devices are visible
    (e.g. REPRO_TEST_DEVICES=256)."""
    shape, axes = production_layout(multi_pod)
    devs = visible_devices(device)
    need = 1
    for n in shape:
        need *= n
    if len(devs) < need:
        raise ValueError(f"Number of devices {len(devs)} must be >= the "
                         f"product of mesh_shape {shape}")
    return grid_of(devs, shape, axes)


def make_host_mesh(model: int = 1, device=None) -> DeviceGrid:
    """Small ("data", "model") grid over the visible devices (tests,
    local runs): "model" of ``model``, "data" of the rest."""
    devs = visible_devices(device)
    n = len(devs)
    if not 1 <= model <= n:
        raise ValueError(
            f"make_host_mesh(model={model}): the host has {n} visible "
            f"device(s) (visible_devices()); 'model' must be in [1, {n}]")
    return grid_of(devs, (n // model, model), ("data", "model"))
