"""Host library of the port: a JPEG decoder in C++ (`jpeg.cpp`), loaded with
ctypes.

The machine with the card has no PIL, and the datasets (COCO, VQAv2,
CC3M / CC12M, ImageNet) are JPEG. `decode_jpeg` returns what Pillow's
`Image.open(f).convert("RGB")` returns, bit for bit, with
`ImageFile.LOAD_TRUNCATED_IMAGES = True`, for every JPEG that Pillow
decodes: baseline, progressive, arithmetic-coded and lossless files, and
files cut short (a progressive one smoothed as libjpeg smooths it, an
arithmetic one with the rows Pillow keeps when libjpeg stops). Where
Pillow yields no pixels (12-bit, hierarchical, lossless arithmetic, 2
components, ...) it raises `ValueError` naming the feature; the note at the
top of `jpeg.cpp` lists what is replicated and what is refused.

The library is built with `g++ -O3` at first use into `build/host/` at the
repo root. Its file name carries a hash of the source and the flags, so an
edited source rebuilds; the build writes a temporary file and renames it
into place, since test workers and loader processes may build at once.
There is no fallback: a missing `g++` or a failed build raises.

The foreign calls release the GIL, so thread workers decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("jpeg.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_ERR_LEN = 256


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libprismer_jpeg_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if the current source has none yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    args = (ctypes.c_char_p, ctypes.c_size_t)
    lib.prismer_jpeg_shape.argtypes = (*args, ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_char_p, ctypes.c_size_t)
    lib.prismer_jpeg_decode.argtypes = (*args, ctypes.c_void_p,
                                        ctypes.c_size_t, ctypes.c_char_p,
                                        ctypes.c_size_t)
    lib.prismer_jpeg_shape.restype = ctypes.c_int
    lib.prismer_jpeg_decode.restype = ctypes.c_int
    return lib


def _check(rc: int, err) -> None:
    if rc == 1:
        raise ValueError(err.value.decode(errors="replace"))
    if rc != 0:
        raise RuntimeError(err.value.decode(errors="replace"))


def decode_jpeg_shape(data: bytes) -> Tuple[int, int]:
    """(height, width) from the frame header."""
    hw = (ctypes.c_int * 2)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().prismer_jpeg_shape(data, len(data), hw, err, _ERR_LEN),
           err)
    return hw[0], hw[1]


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) RGB; `ValueError` for a stream the
    decoder refuses (the message names the feature) or finds corrupt."""
    h, w = decode_jpeg_shape(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().prismer_jpeg_decode(
        data, len(data), out.ctypes.data, out.nbytes, err, _ERR_LEN), err)
    return out
