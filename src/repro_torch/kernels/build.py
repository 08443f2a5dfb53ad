"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false -Xptxas -v

Every source takes the same flags. ``flash_attention_sm90.cu`` needs
no other: it includes ``cuda.h`` for the tensor-map types only and
reaches ``cuTensorMapEncodeTiled`` through the runtime's
``cudaGetDriverEntryPoint``, so no library links ``libcuda``; its
``wgmma`` and ``setmaxnreg`` exist only for ``sm_90a``.

``--fmad=false`` keeps nvcc from contracting ``a*b - c*d`` into an FMA,
which would flip sector bins at the 20-degree boundaries and change the
Newton-Raphson rsqrt bits; the kernels also spell the sensitive
expressions with ``__fmul_rn``/``__fsub_rn``. Fast math is never used.

Libraries land in ``build/kernels/`` at the repository root (listed in
``.gitignore``), one file per source keyed on a hash of the sources and
flags, so an edited kernel rebuilds and an unchanged one is reused.
``build_all`` starts one nvcc per source, all at once.

The build and the library load happen inside the launching call, never
at import: the CPU tests import every module on a machine with no nvcc.
One lock serializes them across threads (a service's worker and its
caller can both reach a kernel's first launch), so no two threads run
nvcc for one kernel or write one temporary file.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

#: kernel name -> CUDA source under csrc/
SOURCES = {
    "dense_grad_hist": "dense_grad_hist.cu",
    "dense_block_norm": "dense_block_norm.cu",
    "dense_fused_hog": "dense_fused_hog.cu",
    "score_matmul": "score_matmul.cu",
    "score_matmul_int8": "score_matmul_int8.cu",
    "hog_gradient": "hog_gradient.cu",
    "cell_hist": "cell_hist.cu",
    "block_norm": "block_norm.cu",
    "fused_hog": "fused_hog.cu",
    "svm_scores": "svm_scores.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_sm90": "flash_attention_sm90.cu",
}

#: the card the launch plans are sized for by default: an H100 SXM's SMs
SMS = 132

#: the dynamic shared memory a thread block may take without opting in
SMEM_DEFAULT = 48 * 1024
#: the most a thread block may take on Hopper after opting in with
#: cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize)
SMEM_OPTIN = 227 * 1024

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, "ctypes._CFuncPtr"] = {}
#: held while kernels build and load (temporary files are named by pid)
_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (the card's own count)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def nvcc() -> str:
    """Path of nvcc: $PATH, then $CUDA_HOME/bin, then /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = [CSRC / SOURCES[name]] + sorted(CSRC.glob("*.cuh"))
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process per source, all started together. Returns seconds
    per kernel built; raises RuntimeError with nvcc's output on failure.
    ptxas's register/shared-memory report goes to ``<library>.log``."""
    with _BUILD_LOCK:
        return _build(list(SOURCES if names is None else names))


def _build(names) -> Dict[str, float]:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    took, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)       # atomic: readers never see a partial
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _BUILD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _LIBS[name] = lib
    return lib


def launch(name: str, argtypes, device_tensor, *args) -> None:
    """Call kernel ``name``'s C entry point ``<name>_launch`` with
    ``args`` plus PyTorch's current stream, on ``device_tensor``'s card.
    ``argtypes`` is its C signature (pointers and the stream as c_void_p,
    so ctypes does not cut them to 32 bits). The entry point returns
    cudaGetLastError(); a non-zero code raises, since a refused launch
    never runs and synchronize would not report it."""
    import torch
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(library(name), f"{name}_launch")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    with torch.cuda.device(device_tensor.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
