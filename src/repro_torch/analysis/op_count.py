"""FLOPs, HBM bytes and live bytes of one step traced on the meta device
(the counterpart of repro/analysis/hlo_parse.py, which reads the compiled
HLO; eager PyTorch has none, so the ops themselves are counted as they
dispatch).

  * FLOPs -- ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
    batched matmuls, convolutions: 2 x the multiply-adds, as the
    reference's ``dot`` model), with a formula for the port's flash
    forward and backward that counts the tiles the route's kernels
    compute (``kernels/flash_attention.py:kernel_flops`` /
    ``kernel_bwd_flops``: the causal tiles, not the plain version's full
    S x S).
  * HBM bytes -- every dispatched op that is not a view (or a ``to``
    that returns its input): its tensor
    operands' bytes plus its results' (a broadcast operand counted once
    per distinct element; a gather or an indexed read counted as the rows
    it reads, not the whole table). Eager PyTorch fuses nothing, so this
    is what the port moves: the counterpart of the reference's "operands
    + result per fused region".
  * Live bytes -- the bytes of every storage an op allocates during the
    trace while a tensor still holds it; ``peak_bytes`` is their most at
    any point (what the step needs above its arguments, which exist
    before it starts).

The flash wrappers take meta tensors inside ``count`` only
(``kernels/flash_attention.py:shape_only``). Nothing is allocated and no
value is read: ``.item()`` on a meta tensor
raises, so a traced path must take what it reads on the host from the
caller (launch/dryrun.py supplies what the shape set fixes).
"""
from __future__ import annotations

import collections
import gc
import weakref
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..kernels.flash_attention import (kernel_bwd_flops, kernel_flops,
                                      shape_only)

aten = torch.ops.aten

# ops that read only the rows they gather (the table itself is not
# streamed): their bytes are the indices, the result read and the result
# written
_GATHERS = {aten.embedding.default, aten.index.Tensor,
            aten.index_select.default, aten.gather.default}
# ops that allocate without moving data through the memory system
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.detach.default,
               aten.lift_fresh.default, aten._local_scalar_dense.default}


def _flash_fwd_formula(q, k, v, causal, lse, q_offset=0, out_val=None):
    B, H, S, hd = q.shape
    return kernel_flops(B, H, S, hd, q.dtype, causal, Sk=k.shape[2],
                        q_offset=q_offset)


def _flash_bwd_formula(q, k, v, out, dout, lse, causal, q_offset=0,
                       out_val=None):
    B, H, S, hd = q.shape
    return kernel_bwd_flops(B, H, S, hd, q.dtype, causal, Sk=k.shape[2],
                            q_offset=q_offset)


_flash_fwd_formula._get_raw = True
_flash_bwd_formula._get_raw = True

FLASH_FORMULAS = {
    torch.ops.repro_torch.flash_attention_fwd: _flash_fwd_formula,
    torch.ops.repro_torch.flash_attention_bwd: _flash_bwd_formula,
}


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t``'s distinct elements take (a stride-0 dimension, a
    broadcast, counted once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _Traffic(TorchDispatchMode):
    """Bytes each non-view op moves (by op), and the live bytes of the
    storages the trace allocates, with their peak."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = collections.Counter()
        self.read: set = set()              # storages an op read
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}   # storage key -> [bytes, tensors]

    def _release(self, key: int) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def _hold(self, t: torch.Tensor, new: bool) -> None:
        key = t.untyped_storage()._cdata
        entry = self._refs.get(key)
        if entry is None:
            if not new:
                return            # an argument's storage, or a view of one
            entry = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        operands = _tensors((args, kwargs))
        seen = {t.untyped_storage()._cdata for t in operands}
        out = func(*args, **kwargs)
        results = _tensors(out)
        fresh = [t.untyped_storage()._cdata not in seen for t in results]
        for t, new in zip(results, fresh):
            self._hold(t, new)
        # a view op moves nothing where it aliases (``to`` converts, and
        # then copies)
        if (func.is_view and not any(fresh)) or func in _NO_TRAFFIC:
            return out
        # copy_ writes its first operand and reads only its source
        self.read.update(t.untyped_storage()._cdata for t in (
            operands[1:] if func is aten.copy_.default else operands))
        wrote = sum(tensor_bytes(t) for t in results)
        if func in _GATHERS:
            idx = [t for t in _tensors((args[1:], kwargs))
                   if not t.is_floating_point()]
            moved = 2 * wrote + sum(tensor_bytes(t) for t in idx)
        else:
            moved = wrote + sum(tensor_bytes(t) for t in operands)
        self.by_op[str(func.overloadpacket.__name__)] += moved
        return out


def count(fn: Callable[[], object]) -> Tuple[object, Dict[str, object]]:
    """Run ``fn()`` (on meta tensors, or any device) counting what it
    dispatches -> (its result, {"flops", "flops_by_op", "mem_bytes",
    "bytes_by_op", "peak_bytes", "live_bytes", "read"}): FLOPs by
    ``FlopCounterMode`` with ``FLASH_FORMULAS``, HBM bytes, the peak of
    the bytes allocated during the call that are live at once and those
    still live after it (what it returns), and the storages some op read
    (``storage_key``)."""
    flops = FlopCounterMode(display=False, custom_mapping=FLASH_FORMULAS)
    traffic = _Traffic()
    with flops, traffic, shape_only():
        result = fn()
    gc.collect()
    by_op = {str(k): int(v)
             for k, v in flops.get_flop_counts().get("Global", {}).items()}
    return result, {
        "flops": float(flops.get_total_flops()),
        "flops_by_op": by_op,
        "mem_bytes": float(sum(traffic.by_op.values())),
        "bytes_by_op": dict(traffic.by_op),
        "peak_bytes": traffic.peak,
        "live_bytes": traffic.live,
        "read": traffic.read,
    }


def storage_key(t: torch.Tensor) -> int:
    """Which storage ``t`` views, as ``count``'s "read" lists them."""
    return t.untyped_storage()._cdata
