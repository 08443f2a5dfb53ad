"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

Each kernel module holds the wrapper (launches the kernel for a CUDA
tensor, runs the plain version for a CPU tensor), the plain PyTorch
version, and a ``launches`` counter on the wrapper that counts kernel
launches only; a wrapper with more than one kernel (``flash_attention``)
also counts each route's in ``route_launches``. ``build.py`` compiles
csrc/ at first use.
"""
from __future__ import annotations

from typing import Dict


def wrappers() -> Dict[str, object]:
    """Kernel name -> wrapper function (each carries ``.launches``)."""
    from .block_norm import block_norm
    from .cell_hist import cell_hist
    from .dense_block_norm import dense_block_norm
    from .dense_grad_hist import dense_grad_hist
    from .flash_attention import flash_attention, flash_attention_bwd
    from .fused_hog import dense_fused_hog, fused_hog
    from .hog_gradient import hog_gradient
    from .svm_matmul import score_matmul, score_matmul_int8, svm_scores
    return {"dense_grad_hist": dense_grad_hist,
            "dense_block_norm": dense_block_norm,
            "dense_fused_hog": dense_fused_hog,
            "score_matmul": score_matmul,
            "score_matmul_int8": score_matmul_int8,
            "hog_gradient": hog_gradient,
            "cell_hist": cell_hist,
            "block_norm": block_norm,
            "fused_hog": fused_hog,
            "svm_scores": svm_scores,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}
