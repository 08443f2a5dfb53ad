"""Disk persistence for the batch-schedule autotune -- a copy of
repro/core/autotune_cache.py, with the host fingerprint taken from torch
and the path resolution of repro/platform.py:187-197 kept here.

The in-memory autotune (core/detector.py:_autotune_chunk) probes each
new (true-shape, bucket, B) tuple at first use -- a few timed runs, paid
once per process. This module lets warm starts skip the probe entirely:
decisions are keyed by a HOST FINGERPRINT (machine, torch and CUDA
versions, device name and count, cpu count) plus the autotune key and a
digest of the DetectorConfig, and stored in one JSON file.

Path resolution: $REPRO_AUTOTUNE_CACHE if set (empty string DISABLES
persistence -- tests and benches use this for hermetic probes),
otherwise ~/.cache/repro_torch/autotune.json, so the port and the
reference never share entries.

Everything is best-effort: a missing, corrupt or unwritable cache file
degrades to probing, never to an error. Writes are atomic (temp +
rename) so concurrent processes at worst lose each other's newest
entries, never corrupt the file. ``stats()`` counts how many schedule
decisions came from memory, from disk, or had to be probed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import tempfile
from typing import Optional

_STATS = {"memory_hits": 0, "disk_hits": 0, "probes": 0, "writes": 0,
          "load_errors": 0}
_CACHE: Optional[dict] = None       # parsed file content, memoized
_CACHE_PATH: Optional[str] = None   # path _CACHE was loaded from


def cache_path() -> Optional[str]:
    """Resolved cache file path, or None when persistence is disabled
    (REPRO_AUTOTUNE_CACHE set to an empty string)."""
    p = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if p is not None:
        return os.path.expanduser(p) if p else None
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def host_fingerprint() -> str:
    """A schedule probed on one host is only trusted on an equivalent
    one: same architecture, torch and CUDA versions, device name and
    count, and cpu count."""
    import torch
    cuda = torch.cuda.is_available()
    return "|".join([
        platform.machine(), torch.__version__, str(torch.version.cuda),
        torch.cuda.get_device_name(0) if cuda else "cpu",
        str(torch.cuda.device_count() if cuda else 0),
        str(os.cpu_count())])


def entry_key(report_key: str, cfg) -> str:
    """The on-disk key: the human-readable autotune key (autotune_report
    format) plus a digest of every DetectorConfig field -- backend,
    scales, numerics mode etc. all change what the probe measured."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return f"{report_key} cfg={hashlib.sha1(blob.encode()).hexdigest()[:12]}"


def _load(path: str) -> dict:
    global _CACHE, _CACHE_PATH
    if _CACHE is not None and _CACHE_PATH == path:
        return _CACHE
    data: dict = {}
    try:
        with open(path) as f:
            loaded = json.load(f)
        if isinstance(loaded, dict):
            data = loaded
        else:
            _STATS["load_errors"] += 1
    except FileNotFoundError:
        pass
    except Exception:
        _STATS["load_errors"] += 1
    _CACHE, _CACHE_PATH = data, path
    return data


def lookup(key: str) -> Optional[dict]:
    """Disk decision for ``key`` under this host's fingerprint, as
    {"chunk": int, "probe_ms": {int: float}}, or None."""
    path = cache_path()
    if path is None:
        return None
    host = _load(path).get(host_fingerprint())
    e = host.get(key) if isinstance(host, dict) else None
    if not isinstance(e, dict) or "chunk" not in e:
        return None
    _STATS["disk_hits"] += 1
    try:
        probe = {int(c): float(v)
                 for c, v in dict(e.get("probe_ms", {})).items()}
    except (TypeError, ValueError):
        probe = {}
    return {"chunk": int(e["chunk"]), "probe_ms": probe}


def store(key: str, chunk: int, probe_ms: dict) -> None:
    """Record a freshly probed decision (counts the probe even when
    persistence is disabled, so stats stay truthful)."""
    _STATS["probes"] += 1
    path = cache_path()
    if path is None:
        return
    global _CACHE
    data = dict(_load(path))
    host = dict(data.get(host_fingerprint(), {}))
    host[key] = {"chunk": int(chunk),
                 "probe_ms": {str(c): float(v) for c, v in probe_ms.items()}}
    data[host_fingerprint()] = host
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".autotune.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, path)          # atomic publish
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _CACHE = data
        _STATS["writes"] += 1
    except OSError:
        pass                               # best-effort: probing still won


def note_memory_hit() -> None:
    _STATS["memory_hits"] += 1


def stats() -> dict:
    """Counters + resolved path."""
    return {**_STATS, "path": cache_path()}


def _reset_for_tests() -> None:
    global _CACHE, _CACHE_PATH
    _CACHE = _CACHE_PATH = None
    for k in _STATS:
        _STATS[k] = 0
