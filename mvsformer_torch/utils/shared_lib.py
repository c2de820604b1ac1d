"""Build and load the port's shared libraries: the CUDA kernels
(`ops/cuda_build.py`, nvcc) and the host JPEG decoder (`utils/jpeg.py`, the
host C++ compiler).

A library's file name carries a hash of what it is built from, so an edited
source rebuilds, and each compiler writes a temporary file that an atomic
`os.replace` moves into place: processes or threads that build the same
library at once never see half a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path


def hashed_path(build_dir: Path, stem: str, *parts: bytes) -> Path:
    """`build_dir/lib<stem>-<hash of parts>.so`."""
    digest = hashlib.sha1()
    for part in parts:
        digest.update(part)
    return build_dir / f"lib{stem}-{digest.hexdigest()[:16]}.so"


def compile_all(jobs: dict) -> dict:
    """Compile every job whose library is missing, all at once.

    `jobs` maps a name to (compiler command without output or source,
    source path, library path); each runs as `command -o <tmp> source`.
    Returns {name: {"seconds": wall time or 0.0 if cached, "stderr": the
    compiler's stderr}}. Raises RuntimeError naming the source on a failed
    build.
    """
    running, report = {}, {}
    t0 = time.perf_counter()
    for name, (cmd, src, out) in jobs.items():
        if out.exists():
            report[name] = {"seconds": 0.0, "stderr": ""}
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen([*cmd, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[name] = (proc, src, tmp, out)
    for name, (proc, src, tmp, out) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(proc.args[0]).name} failed for {src}:\n{stdout}\n{stderr}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "stderr": stderr}
    return report


_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def library(name: str, path, source: Path, command, signatures: dict) -> ctypes.CDLL:
    """The library `name`, loaded once per process with `signatures`.

    On first use `path()` gives its file; if that is missing it is built
    from `source` by `command()` (the compiler command without output or
    source, asked for only then). A lock makes threads that ask at once
    build and load it once.
    """
    lib = _LOADED.get(name)
    if lib is None:
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                out = path()
                if not out.exists():
                    compile_all({name: (command(), source, out)})
                lib = _LOADED[name] = load(out, signatures)
    return lib


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load `path` and give each exported function its argument types
    (`signatures`: name -> list of ctypes types) and an int result."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
