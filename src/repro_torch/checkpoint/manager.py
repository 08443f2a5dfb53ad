"""Fault-tolerant checkpointing: atomic, async, device-agnostic restore.

A copy of repro/checkpoint/manager.py for tensors; the layout on disk is
the reference's, byte for byte, so a directory either package writes
loads in the other:

    ckpt_dir/step_00000100.tmp/...   (written, fsync'd)
    ckpt_dir/step_00000100/          (atomic rename = commit)

One .npy file per leaf, named by the leaf's "/"-joined dict path with
"/" -> "__"; metadata.json (the step and the sorted keys) is written
LAST, so its presence in a .tmp dir is the completion marker the
crash-recovery scan keys on. A bf16 leaf is written as the reference's
numpy writes an ml_dtypes bf16 array: raw 2-byte void values under the
descr '<V2'; ``restore`` reads void leaves back by the skeleton's dtype.

Crash safety: every file is fsync'd before the commit rename and the
PARENT DIRECTORY is fsync'd after it. Re-committing an existing step
swaps the old dir to `<name>.old` first -- never an rmtree-then-rename
window with NO valid checkpoint on disk -- and `__init__` runs
`_recover()`: complete .tmp dirs (metadata.json present) are finished,
truncated ones removed, and an orphaned .old is restored when its
commit is missing. `atomic_write_json` is the same temp+fsync+rename
discipline for single manifests.

Async: `save_async` copies every leaf to host memory synchronously --
the only part that must be consistent -- then writes in a daemon thread
(a killed writer leaves only a .tmp dir, never a corrupt commit).

Restore takes a skeleton: a tree of tensors or of (shape, dtype) pairs
in place of the leaves, and puts every leaf on ``device`` (CUDA unless
the CPU is asked for; RuntimeError without a GPU), or, given a tree of
``Sharding``s, lays each leaf out on their grid as its pieces (a grid's
tree is saved gathered, as the reference's host copy gathers it).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: the .npy descr the reference's numpy gives an ml_dtypes bf16 leaf
_BF16_DESCR = "<V2"


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it survives power loss
    (no-op on filesystems that refuse O_RDONLY dir fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:          # pragma: no cover -- exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:          # pragma: no cover
        pass
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj: Any, **json_kw) -> None:
    """Durable single-file JSON write: temp file in the target's
    directory, fsync, rename over the destination, fsync the
    directory. A reader never observes a truncated file."""
    d = os.path.dirname(os.path.abspath(path))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, **json_kw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)


def _is_spec(x: Any) -> bool:
    """A (shape, dtype) skeleton leaf."""
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))


def _leaves(tree: Any, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's order (jax.tree_util: dict
    keys sorted, sequences by index); the key is the "/"-joined path."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def _unflatten(tree: Any, values: Dict[str, Any], prefix: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], values, prefix + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(_unflatten(v, values, prefix + (i,))
                          for i, v in enumerate(tree))
    return values["/".join(str(p) for p in prefix)]


def _to_host(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array (a copy); bf16 as 2-byte void values
    (numpy has no bf16), which ``_save_npy`` writes as the reference's
    numpy writes ml_dtypes' bfloat16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {k: _to_host(v) for k, v in _leaves(tree)}


def _save_npy(f, arr: np.ndarray) -> None:
    """np.save, but 2-byte void values (a bf16 leaf, see _to_host) go
    under the descr '<V2', as numpy writes ml_dtypes' bfloat16 (its own
    descr for plain void is '|V2')."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        f.write(arr.tobytes())
    else:
        np.save(f, arr)


def _from_npy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A loaded leaf as a tensor of ``dtype``. Void leaves (bf16 saved by
    either package) are re-viewed as the skeleton's dtype; others are
    converted, as the reference's ``astype``."""
    if arr.dtype.kind == "V":
        if dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise ValueError(f"a raw {arr.dtype.itemsize}-byte leaf can "
                             f"only restore as bfloat16, not {dtype}")
        return torch.from_numpy(np.array(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dtype)


def _step_of(name: str) -> Optional[int]:
    """step_00000100 -> 100; None for .tmp/.old/foreign entries."""
    if not name.startswith("step_"):
        return None
    digits = name[len("step_"):]
    return int(digits) if digits.isdigit() else None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._recover()

    # --------------------------------------------------- crash recovery
    def _recover(self) -> None:
        """Settle the debris of a writer killed mid-save.

        .tmp with metadata.json  -> every leaf was written and fsync'd
                                    (metadata is written last): finish
                                    the commit.
        .tmp without             -> truncated write: remove.
        .old with no commit      -> the swap's rename never happened:
                                    restore the old checkpoint.
        .old with a commit       -> superseded: remove.
        """
        for name in sorted(os.listdir(self.dir)):
            p = os.path.join(self.dir, name)
            if name.endswith(".tmp"):
                final = p[:-len(".tmp")]
                if (os.path.exists(os.path.join(p, "metadata.json"))
                        and not os.path.exists(final)):
                    os.rename(p, final)
                else:
                    shutil.rmtree(p, ignore_errors=True)
            elif name.endswith(".old"):
                final = p[:-len(".old")]
                if os.path.exists(final):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    os.rename(p, final)
        _fsync_dir(self.dir)

    # ------------------------------------------------------------- save
    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        old = os.path.join(self.dir, name + ".old")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for key, arr in flat.items():
            fn = os.path.join(tmp, key.replace("/", "__") + ".npy")
            with open(fn, "wb") as f:
                _save_npy(f, arr)
                f.flush()
                os.fsync(f.fileno())
        # metadata LAST: its presence marks the .tmp complete (recovery
        # finishes such a dir instead of discarding it)
        meta = {"step": step, "keys": sorted(flat.keys())}
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            # swap, don't rmtree-then-rename: a crash between those two
            # would leave NO valid copy of this step on disk
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(final, old)
        os.rename(tmp, final)            # atomic commit
        _fsync_dir(self.dir)             # make the commit durable
        shutil.rmtree(old, ignore_errors=True)
        self._gc()

    def save(self, step: int, tree: Any) -> None:
        self._write(step, _flatten(tree))

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()                       # one writer at a time
        flat = _flatten(tree)             # consistent host snapshot
        self._thread = threading.Thread(
            target=self._write, args=(step, flat), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = [s for s in (_step_of(d) for d in os.listdir(self.dir))
                 if s is not None]
        return max(steps) if steps else None

    def restore(self, step: int, target: Any, device=None,
                shardings: Optional[Any] = None) -> Any:
        """target: tree of tensors or (shape, dtype) pairs (the
        skeleton); each leaf is read, given the skeleton's dtype, checked
        against its shape and put on ``device``. ``shardings``: a matching
        tree of ``sharding.rules.Sharding`` -- each leaf then comes back
        as its pieces on that grid (elastic: any grid the shape divides
        over, whatever grid wrote it), each block read from the mapped
        file straight onto its device, one tensor a (block, device), so
        no device ever holds a whole leaf it does not own."""
        from ..core.detector import resolve_device
        dev = resolve_device(device)
        if shardings is not None:
            flat_sh = dict(_leaves(shardings))
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "metadata.json")) as f:
            json.load(f)
        values = {}
        for key, leaf in _leaves(target):
            shape, dtype = ((tuple(leaf[0]), leaf[1]) if _is_spec(leaf)
                            else (tuple(leaf.shape), leaf.dtype))
            arr = np.load(os.path.join(path, key.replace("/", "__")
                                       + ".npy"), mmap_mode="r")
            if tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, the skeleton {shape}")
            if shardings is None:
                values[key] = _from_npy(arr, dtype).to(dev)
                continue
            sh, made, pieces = flat_sh[key], {}, []
            for d, sl in zip(sh.grid.flat, sh.slices(shape)):
                block = (tuple((i.start, i.stop) for i in sl), d)
                if block not in made:
                    made[block] = _from_npy(arr[sl], dtype).to(d)
                pieces.append(made[block])
            values[key] = pieces
        return _unflatten(target, values)

    # --------------------------------------------------------------- gc
    def _gc(self) -> None:
        all_steps = sorted(
            s for s in (_step_of(d) for d in os.listdir(self.dir))
            if s is not None)
        for s in all_steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
