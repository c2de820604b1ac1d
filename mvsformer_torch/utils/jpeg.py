"""The port's JPEG decoder: `csrc/host/jpeg_decode.cpp`, host C++ that the
source's header comment describes (baseline and extended sequential
Huffman JPEG, decoded bit for bit as libjpeg-turbo and so `cv2.imdecode`
decode it; what it refuses).

It is built at first use by the host C++ compiler (`$CXX`, else `c++` or
`g++` on PATH) with `-O2 -std=c++17 -shared -fPIC` into
`build/host/libjpeg_decode-<hash>.so` at the root of the checkout, and
called through ctypes, which releases the GIL: threads decode at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np

from mvsformer_torch.utils import shared_lib

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "jpeg_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
COMPILERS = ("c++", "g++")
_ERR_BYTES = 512

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32P = ctypes.POINTER(ctypes.c_int32)
SIGNATURES = {
    "jpeg_header": [ctypes.c_char_p, _I64, _I32P, _I32P, _I32P, ctypes.c_char_p, _I64],
    "jpeg_decode": [ctypes.c_char_p, _I64, ctypes.c_int32, _P, _I64, ctypes.c_char_p, _I64],
}

def compiler() -> str:
    """`$CXX`, else the first of `COMPILERS` on PATH."""
    cxx = os.environ.get("CXX") or next(filter(None, map(shutil.which, COMPILERS)), None)
    if not cxx:
        raise RuntimeError(f"no host C++ compiler for the JPEG decoder: $CXX is unset and "
                           f"none of {', '.join(COMPILERS)} is on PATH")
    return cxx


def lib_path() -> Path:
    return shared_lib.hashed_path(BUILD_DIR, "jpeg_decode", SOURCE.read_bytes(),
                                  " ".join(CXX_FLAGS).encode())


def library() -> ctypes.CDLL:
    """The loaded decoder, built on first use."""
    return shared_lib.library("jpeg_decode", lib_path, SOURCE, lambda: [compiler(), *CXX_FLAGS],
                              SIGNATURES)


def decode_jpeg(data: bytes, gray: bool = False) -> np.ndarray:
    """A JPEG stream -> RGB uint8 [H, W, 3], or the grey plane [H, W] with
    `gray` (the Y plane of a YCbCr stream, as cv2.IMREAD_GRAYSCALE gives it).
    Raises ValueError, with the decoder's message, on a stream it refuses."""
    lib = library()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                       err, _ERR_BYTES):
        raise ValueError(err.value.decode())
    out = np.empty((h.value, w.value) if gray else (h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode(data, len(data), int(gray), out.ctypes.data, out.nbytes, err, _ERR_BYTES):
        raise ValueError(err.value.decode())
    return out
