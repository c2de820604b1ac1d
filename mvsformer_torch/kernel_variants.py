"""What the kernel-variant scripts (`k1_variants`, `k2_variants`, ...) share.

A variant is a kernel source in `csrc/` with a few lines substituted. Each
script names its variants; this module applies the substitutions, builds
every variant in parallel with the kernels' own nvcc flags, binds it as
`cuda_build` binds the kernel, summarises ptxas's report, and times a
launch by CUDA events. Only `variant_source` and `ptxas_summary` run
without a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess

import torch

from mvsformer_torch.ops import cuda_build


def variant_source(lib: str, subs, csrc=cuda_build.CSRC) -> str:
    """`<csrc>/<lib>.cu` (the port's `csrc/` by default) with each (old,
    new) of `subs` applied; raises if an old line is not in it, so a variant
    cannot silently time the source."""
    src = (csrc / f"{lib}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{old!r} not found in csrc/{lib}.cu")
        src = src.replace(old, new)
    return src


def build_all(lib: str, variants: dict, csrc=cuda_build.CSRC) -> dict:
    """{variant: (ctypes library, ptxas report)} for {variant: subs} of
    `<csrc>/<lib>.cu`, all compiled at once; a variant that does not build
    is reported and left out. The functions of `cuda_build.SIGNATURES[lib]`
    that a library exports are bound (an earlier tree's source may export
    fewer)."""
    out_dir = cuda_build.BUILD_DIR / f"{lib}_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in variants.items():
        text = variant_source(lib, subs, csrc)
        tag = hashlib.sha1(text.encode()).hexdigest()[:16]  # a loaded path is never rebuilt
        src, so = out_dir / f"{lib}_{tag}.cu", out_dir / f"lib{lib}_{tag}.so"
        src.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(csrc),
               "-o", str(so), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), so)
    built = {}
    for name, (proc, so) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for the {name!r} variant:\n{stdout}\n{stderr}")
            continue
        handle = ctypes.CDLL(str(so))
        for fn, argtypes in cuda_build.SIGNATURES[lib].items():
            if not hasattr(handle, fn):
                continue
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        built[name] = (handle, stderr)
    return built


def ptxas_summary(report: str) -> list:
    """[(kernel<template arguments>, registers, spill store bytes, static
    smem bytes)] from nvcc's -Xptxas -v report."""
    out, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(?:I((?:L[a-z]\d+E)+)E)?", m.group(1))
            name = m.group(1)
            if k:
                args = re.findall(r"L[a-z](\d+)E", k.group(2) or "")
                name = k.group(1) + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)), spill, int(smem.group(1)) if smem else 0))
    return out


def time_ms(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` back-to-back calls, by CUDA events, after
    one call to warm up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
