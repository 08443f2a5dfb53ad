"""Window classification -- the port of repro/core/pipeline.py.

``classify_windows(params, windows)`` is the paper's co-processor op
(Fig. 6: RGB window -> HOG -> SVM -> {0, 1}) for a batch of windows.

Execution paths:
  * path="ref"     plain tensor stages (core/hog.py), mode per HOGConfig,
  * path="kernel"  the staged window kernels (hog_gradient, cell_hist,
                   block_norm) and the svm_scores kernel,
  * path="fused"   the fused window kernel and svm_scores.

Devices: a numpy input goes to ``resolve_device(device)`` -- CUDA unless
``device="cpu"``, RuntimeError without a GPU. A tensor input stays on
its own device, and tensor SVM parameters must be on it too (numpy ones
are moved there). On CUDA tensors the kernel paths launch their kernels
or raise; nothing falls back to the CPU.

Grids: ``shard_over_data(grid, windows)`` places a window batch on a
device grid (launch/mesh.py), split row-major over every axis but
"model", one chunk a device (replicated over "model"), and
``detection_step_specs(grid)`` gives the port's ``Sharding``s of the
parameters, the windows and the outputs (the reference's in and out
shardings for ``jax.jit(classify_windows)``). ``classify_windows`` takes
such a placed batch: each chunk runs on its device through that
device's kernels (numpy or tensor SVM parameters copied to each), and
the scores come back in order on the grid's first device -- detection
is data-parallel, the co-processor at pod scale (the dry run's
``hog_svm_coproc`` cell). On logical devices of one card the chunks run
one after another.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .detector import _same_device, resolve_device
from .hog import HOGConfig, PAPER_HOG
from .svm import SVMParams, svm_score

Tensor = torch.Tensor


def _windows_on(windows, device) -> Tensor:
    if isinstance(windows, Tensor):
        if device is not None and not _same_device(
                resolve_device(device), windows.device):
            raise ValueError(f"windows are on {windows.device}, but "
                             f"device={device!r} was asked for")
        return windows
    return torch.from_numpy(np.ascontiguousarray(windows)).to(
        resolve_device(device))


def _params_on(params, dev: torch.device) -> SVMParams:
    out = {}
    for k in ("w", "b"):
        v = params[k]
        if isinstance(v, Tensor):
            if not _same_device(v.device, dev):
                raise ValueError(f"SVM parameter {k!r} is on {v.device}, "
                                 f"the windows on {dev}")
            out[k] = v.to(torch.float32)
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    return out


def extract_features(windows, cfg: HOGConfig = PAPER_HOG, path: str = "ref",
                     device=None) -> Tensor:
    """(B, 130, 66, 3) uint8 (or (B, H, W) gray) -> (B, 3780) descriptors,
    f32 (bf16 for feat_dtype="bf16"). Windows smaller than the configured
    geometry raise ValueError."""
    from .stages import window_descriptor
    return window_descriptor(_windows_on(windows, device), cfg, backend=path)


def classify_windows(params: SVMParams, windows, cfg: HOGConfig = PAPER_HOG,
                     path: str = "ref", device=None) -> Dict[str, Tensor]:
    """Full co-processor op: windows -> {"score": (B,) f32, "human": (B,)
    int32}. (Fig. 6 datapath.) ``windows`` placed on a grid
    (``shard_over_data``): each chunk on its device, the result on the
    grid's first device."""
    if isinstance(windows, PlacedWindows):
        return _classify_placed(params, windows, cfg, path)
    windows = _windows_on(windows, device)
    svm = _params_on(params, windows.device)
    feats = extract_features(windows, cfg, path)
    if path in ("kernel", "fused"):
        from ..kernels import ops
        # the f32 weights, even against bf16 descriptors
        # (repro/core/pipeline.py:57)
        score = ops.svm_score_kernel(feats, svm["w"], svm["b"])
    elif cfg.feat_dtype == "bf16":
        # bf16 descriptors AND bf16 weights, f32 accumulation
        # (repro/core/pipeline.py:60-67); both upcast exactly, since a
        # bf16 torch.matmul would round its sum to bf16
        w16 = svm["w"].to(torch.bfloat16).to(torch.float32)
        score = torch.matmul(feats.to(torch.float32), w16) + svm["b"]
    else:
        score = svm_score(svm, feats)
    return {"score": score, "human": (score > 0).to(torch.int32)}


# ---------------------------------------------------------------- grids

@dataclasses.dataclass(frozen=True)
class PlacedWindows:
    """A window batch laid out on a grid (``shard_over_data``):
    ``pieces[i]`` on grid device i (row-major), its block of
    ``sharding``; holders of one block on one device share one tensor."""
    sharding: object
    pieces: Tuple[Tensor, ...]


def _data_entry(grid):
    from ..sharding.rules import _entry
    return _entry(a for a in grid.axis_names if a != "model")


def shard_over_data(grid, windows) -> PlacedWindows:
    """Place a window batch on ``grid`` (launch/mesh.py:``DeviceGrid``),
    the batch over every axis but "model", row-major: numpy windows go
    block by block straight to their devices, a tensor's are copied from
    it (views on logical devices of its own device). ValueError unless
    the batch splits over those axes."""
    from ..models.sharded import shard_leaf
    from ..sharding.rules import Sharding
    ndim = windows.ndim
    sh = Sharding(grid, (_data_entry(grid),) + (None,) * (ndim - 1))
    if isinstance(windows, Tensor):
        return PlacedWindows(sh, tuple(shard_leaf(sh, windows)))
    for d in grid.flat:
        resolve_device(d)
    made, pieces = {}, []
    for d, sl in zip(grid.flat, sh.slices(windows.shape)):
        block = (sl[0].start, d)
        if block not in made:
            made[block] = torch.from_numpy(
                np.ascontiguousarray(windows[sl])).to(d)
        pieces.append(made[block])
    return PlacedWindows(sh, tuple(pieces))


def detection_step_specs(grid):
    """((the SVM parameters' shardings {"w", "b"}: replicated, the
    windows' (B, H, W, C): the batch over every axis but "model"), the
    outputs' {"score", "human"}: as the batch) -- the reference's in and
    out shardings of ``jax.jit(classify_windows)``, as ``Sharding``s."""
    from ..sharding.rules import Sharding
    data = _data_entry(grid)
    w_spec = {"w": Sharding(grid, (None,)), "b": Sharding(grid, ())}
    x_spec = Sharding(grid, (data, None, None, None))
    out_spec = {"score": Sharding(grid, (data,)),
                "human": Sharding(grid, (data,))}
    return (w_spec, x_spec), out_spec


def _classify_placed(params: SVMParams, windows: PlacedWindows,
                     cfg: HOGConfig, path: str) -> Dict[str, Tensor]:
    """Each distinct chunk through ``classify_windows`` on its first
    holder's device (every card at once), the scores gathered in order
    onto the grid's first device."""
    from ..sharding.rules import Sharding
    sh = windows.sharding
    grid = sh.grid
    if len(windows.pieces) != grid.size:
        raise ValueError(f"{len(windows.pieces)} pieces on a grid of "
                         f"{grid.size} devices")
    for p, d in zip(windows.pieces, grid.flat):
        if not _same_device(p.device, d):
            raise ValueError(f"a window chunk on {p.device} where the "
                             f"grid's device is {d}")
    owners = sh.owners(windows.pieces[0].dim())
    out = {}
    for i in sorted(set(owners)):
        piece = windows.pieces[i]
        svm = {k: (v.to(piece.device) if isinstance(v, Tensor) else v)
               for k, v in params.items()}
        out[i] = classify_windows(svm, piece, cfg, path)
    score = Sharding(grid, (sh.spec[0],)).gather(
        [out[o]["score"] for o in owners], grid.flat[0])
    return {"score": score, "human": (score > 0).to(torch.int32)}
