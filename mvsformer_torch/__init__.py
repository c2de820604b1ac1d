"""MVSFormer in PyTorch and CUDA for NVIDIA Hopper GPUs.

The port of `mvsformer_tpu` (JAX on a TPU). Plain tensor code is PyTorch;
each Pallas kernel of the JAX package is a kernel written by hand for the
H100 (`csrc/` for CUDA C++, Triton inside `ops/`), with its plain PyTorch
version beside it in the same module.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU present they raise rather than carry on on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["fp32_math", "resolve_device"]


@contextlib.contextmanager
def fp32_math():
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions inside the
    block, so fp32 work runs in full fp32; the caller's flags come back on
    exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def resolve_device(device=None) -> torch.device:
    """`cuda` by default; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mvsformer_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
