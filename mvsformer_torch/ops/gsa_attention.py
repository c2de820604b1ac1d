"""K6: Twins global sub-sampled attention, softmax(q k^T / sqrt(hd)) v per head.

Port of `mvsformer_tpu/ops/pallas/gsa_attention.py` `gsa_attention`. The
kernel is `csrc/gsa_attention.cu` (both products in 3xTF32 on the tensor
cores, fp32's accuracy; `tests/test_torch_gsa_tf32.py` emulates its
arithmetic on the CPU); `gsa_attention_plain` is its plain version, the two
matmuls and the fp32 softmax of `GlobalSubsampledAttention`. Heads are
contiguous slices of C. Unlike the Pallas kernel, which casts the
probabilities to bf16, both versions keep them in fp32. `gsa_attention`
launches the kernel for CUDA tensors and runs the plain version only for
CPU tensors; it adds no PyTorch op but the output's `torch.empty` (and,
when an input requires grad, `cuda_build.eval_outputs`' identity).
"""

from __future__ import annotations

import ctypes

import torch

from mvsformer_torch.ops import cuda_build

HEAD_DIM = 32  # the kernel's head width: every Twins preset has hd = 32


def gsa_attention_plain(q, k, v, num_heads: int):
    """q [B, N, C], k and v [B, Nk, C] -> [B, N, C]."""
    B, N, C = q.shape
    hd = C // num_heads
    qh = q.reshape(B, N, num_heads, hd).transpose(1, 2)  # [B, nh, N, hd]
    kh = k.reshape(B, -1, num_heads, hd).transpose(1, 2)
    vh = v.reshape(B, -1, num_heads, hd).transpose(1, 2)
    attn = torch.matmul(qh, kh.transpose(-1, -2)).float() * hd ** -0.5
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.matmul(attn, vh).transpose(1, 2).reshape(B, N, C)


def gsa_attention(q, k, v, num_heads: int):
    """The K6 wrapper; same arguments and result as the plain version.

    On CUDA it takes float32 tensors with unit stride along C and rows
    16-byte aligned (k and v may be the two halves of one [B, Nk, 2C]
    tensor), and head width 32; it raises on anything else.
    """
    what = "gsa_attention"
    if not cuda_build.require_cuda_inputs(what, q, k, v):
        return gsa_attention_plain(q, k, v, num_heads)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{what}: q must be [B, N, C] and k, v [B, Nk, C], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, N, C = q.shape
    Nk = k.shape[1]
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"{what}: kernel takes head width {HEAD_DIM}, got C={C} "
                         f"with {num_heads} heads")
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {key} must be float32, got {t.dtype}")
        if t.stride(2) != 1 or t.stride(0) % 4 or t.stride(1) % 4 or t.data_ptr() % 16:
            raise ValueError(f"{what}: {key} needs unit stride along C and 16-byte "
                             f"aligned rows, got strides {t.stride()}")
    out = torch.empty((B, N, C), dtype=torch.float32, device=q.device)
    lib = cuda_build.library("gsa_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.gsa_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   B, N, Nk, num_heads, q.stride(0), q.stride(1),
                                   k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                                   ctypes.c_float(HEAD_DIM ** -0.5), stream)
    cuda_build.check_launch(rc, what)
    cuda_build.LAUNCHES[what] += 1
    return cuda_build.eval_outputs(what, out, q, k, v)
