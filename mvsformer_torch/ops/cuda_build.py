"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` exports plain C functions. On first use it is compiled
with `nvcc -gencode arch=compute_90a,code=sm_90a` into
`build/kernels/lib<name>-<hash>.so` at the root of the checkout (the hash
covers the source, the shared `csrc/*.cuh` headers and the flags, so an
edited source or header rebuilds) and loaded
with ctypes. `build()` compiles every source at once, one `nvcc` each.

`LAUNCHES` counts kernel launches by wrapper name: each wrapper adds one
right after a launch that returned success, and nowhere else, so a run can
show which kernels its main path went through.

Every kernel takes fp32. `fp32_island` lets a wrapper take bf16 too: the
bf16 mode's islands around K2, K4, K5 and K6.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# Exported C functions and their argument types. Every launching function
# returns the launch's cudaError_t as an int (0 = success, -1 = shape not
# supported); the *_blocks_per_sm and *_packed_floats functions return a
# count.
SIGNATURES = {
    "warp_corr": {"warp_group_corr_f32": [_P] * 6 + [_I] * 7 + [_P],
                  "warp_corr_fwd_f32": [_P] * 5 + [_I] * 7 + [_P],
                  "warp_corr_blocks_per_sm": [_I] * 3},
    "warp_corr_bwd": {"warp_corr_bwd_f32": [_P] * 7 + [_I] * 7 + [_P],
                      "warp_corr_bwd_blocks_per_sm": [_I] * 2},
    "vis_net": {"visibility_net_pack_f32": [_P] * 13,
                "visibility_net_f32": [_P] * 3 + [_I] * 3 + [_P],
                "visibility_net_packed_floats": [],
                "visibility_net_blocks_per_sm": []},
    "encoder_head": {"encoder_head_pack_f32": [_P] * 11,
                     "encoder_head_f32": [_P] * 4 + [_I] * 3 + [_P],
                     "encoder_head_packed_floats": [],
                     "encoder_head_blocks_per_sm": []},
    "fpn_level": {"fpn_level_f32": [_P] * 6 + [_I] * 5 + [_P],
                  "fpn_level_blocks_per_sm": [_I] * 2},
    "gsa_attention": {"gsa_attention_f32": [_P] * 4 + [_I] * 4 + [_L] * 6 + [_F, _P],
                      "gsa_attention_blocks_per_sm": []},
    "depth_decode": {"depth_decode_f32": [_P] * 4 + [_I] * 3 + [_F, _P]},
}

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    """The library's path; its hash covers the source, every shared header
    of `csrc/` (any source may include one) and the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile the named sources that are not built yet, all in parallel.

    Returns {name: {"seconds": wall time or 0.0 if cached, "ptxas": the
    compiler's register and shared-memory report}}. Raises on a failed build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), tmp, out)
    for name, (proc, tmp, out) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{stdout}\n{stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": stderr}
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_launch(rc: int, what: str) -> None:
    if rc == -1:
        raise ValueError(f"{what}: shape not supported by the kernel")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def require_cuda_inputs(what: str, *tensors) -> bool:
    """True if every tensor lies on one CUDA device (launch the kernel),
    False if every tensor lies on the CPU (run the plain version); raise on
    any other mix."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what}: all inputs must lie on one CUDA device, got {devices}")
    return True


class _NoBackward(torch.autograd.Function):
    """The identity on an eval kernel's outputs, whose backward raises."""

    @staticmethod
    def forward(ctx, what, n_out, *tensors):
        ctx.what = what
        return tensors[:n_out]

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.what}: this eval kernel has no backward; run the eval forward under "
            "torch.no_grad() or torch.inference_mode(), or in train mode")


def eval_outputs(what: str, outputs, *inputs):
    """An eval kernel's `outputs` (a tensor or a tuple), as the wrapper
    returns them. The kernels write them through ctypes, which autograd
    does not see, so when grad mode is on and any of `inputs` requires grad
    they pass through an identity whose backward raises, naming the kernel:
    a gradient through an eval forward fails where it is asked for instead
    of stopping silently. Otherwise (under no_grad or inference_mode) they
    come back as they are."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
        return outputs
    outs = outputs if isinstance(outputs, tuple) else (outputs,)
    tracked = _NoBackward.apply(what, len(outs), *outs, *inputs)
    return tracked if isinstance(outputs, tuple) else tracked[0]


def check_f32_contiguous(what: str, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {key} must be contiguous")


def _map_tensors(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(fn, t) for t in x)
    return x


def up_cast(x):
    """`x` with every bf16 tensor in it (nested in tuples and lists too)
    cast to fp32, which holds each bf16 value exactly; the rest as it is."""
    return _map_tensors(lambda t: t.float() if t.dtype == torch.bfloat16 else t, x)


def fp32_island(out_dtype=None):
    """Decorate an fp32 kernel wrapper so that it also takes bf16 tensors:
    the arguments go through `up_cast`, the wrapper launches its kernel, or
    runs its plain version on the CPU, in fp32, and when the first argument
    was bf16 each output is cast to `out_dtype`, by default bf16 (the
    caller's dtype). fp32 and float64 arguments pass through untouched, so
    the fp32 path is the wrapper itself."""
    def decorate(wrapper):
        @functools.wraps(wrapper)
        def island(*args, **kwargs):
            if not (isinstance(args[0], torch.Tensor) and args[0].dtype == torch.bfloat16):
                return wrapper(*args, **kwargs)
            out = wrapper(*up_cast(args), **kwargs)
            return _map_tensors(lambda t: t.to(out_dtype or torch.bfloat16), out)
        return island
    return decorate
