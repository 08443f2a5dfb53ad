"""Process-level settings of the port: the seed stream and a snapshot of
the environment a run was measured under (the port's part of
repro/platform.py; the reference's XLA flag handling has no counterpart
here).

    REPRO_SEED=N           deterministic seed for launchers and harnesses
                           (``default_seed()``, default 0)

``describe()`` records torch's and CUDA's versions and the device's name
and count, so a printed number carries the environment it came from.
``is_main()`` is the rank-0 guard the metrics emitter applies.
"""
from __future__ import annotations

import os
import platform as host
from typing import MutableMapping, Optional


def default_seed(env: Optional[MutableMapping] = None) -> int:
    """Deterministic-seed plumbing: $REPRO_SEED, default 0. Launchers and
    harnesses derive their numpy/torch streams from this so a run can be
    replayed exactly by exporting one variable."""
    env = os.environ if env is None else env
    try:
        return int(env.get("REPRO_SEED", "0"))
    except ValueError:
        return 0


def is_main() -> bool:
    """Rank-0 guard (the port of repro/platform.py:is_main): only the main
    process of a multi-process run emits metrics. True when no
    torch.distributed process group is initialized."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def describe() -> dict:
    """Snapshot of the platform: torch and CUDA versions, whether a GPU
    is visible, the first device's name and the device count."""
    import torch

    from .core import autotune_cache
    cuda = torch.cuda.is_available()
    return {
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "machine": host.machine(),
        "python": host.python_version(),
        "cpu_count": os.cpu_count(),
        "autotune_cache": autotune_cache.cache_path(),
        "seed": default_seed(),
    }
