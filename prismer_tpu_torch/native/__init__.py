"""Host library of the port: image decoders in C++ (`jpeg.cpp`, `webp.cpp`,
`gif.cpp`), loaded with ctypes.

The machine with the card has no PIL, and the datasets hold JPEG files
(COCO, VQAv2, ImageNet) and, among the web-scraped captions of CC3M / CC12M
/ SBU, also WebP and GIF files under `.jpg` names, which Pillow opens by
their first bytes. Each decoder returns what Pillow 12's
`Image.open(f).convert("RGB")` returns, bit for bit, with
`ImageFile.LOAD_TRUNCATED_IMAGES = True`, and with no mode the array of
Pillow's own mode:

  * `decode_jpeg`: every JPEG that Pillow decodes (baseline, progressive,
    arithmetic-coded and lossless files, and files cut short, a progressive
    one smoothed as libjpeg smooths it). Where Pillow yields no pixels
    (12-bit, hierarchical, lossless arithmetic, 2 components, ...) it
    raises; the note at the top of `jpeg.cpp` lists what is replicated and
    what is refused.
  * `decode_webp`: lossy (VP8) and lossless (VP8L) files, with ALPH alpha,
    and the first frame of an animation on its canvas, as Pillow's
    WebPAnimDecoder gives it ("RGB" or "RGBA"). A file cut short, or one
    that libwebp cannot decode, raises, as Pillow does; see `webp.cpp`.
  * `decode_gif`: the first frame ("P", or "L" without a palette), cut
    files decoded as far as Pillow decodes them; see `gif.cpp`.

BMP is read by numpy (`data/bmp.py`) and PNG by zlib (`data/png.py`).
Refusals raise `ValueError` naming the feature.

The library is built with `g++ -O3` at first use into `build/host/` at the
repo root, one compiler process a source, all started together, then
linked. Its file name carries a hash of the sources and the flags, so an
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
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCES = tuple(Path(__file__).resolve().with_name(f"{name}.cpp")
                for name in ("jpeg", "webp", "gif"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC")
_ERR_LEN = 256


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + ("-shared",)).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libprismer_host_{h.hexdigest()[:16]}.so"


def _run(cmds) -> None:
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the library if the current sources have none yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [out.with_name(f"{out.stem}.{src.stem}.{tag}.o") for src in SOURCES]
    tmp = out.with_suffix(f".{tag}.tmp")
    try:
        _run([["g++", *CXX_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(SOURCES, objs)])
        _run([["g++", "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for path in objs + [tmp]:
            path.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    data = (ctypes.c_char_p, ctypes.c_size_t)
    err = (ctypes.c_char_p, ctypes.c_size_t)
    ints = ctypes.POINTER(ctypes.c_int)
    buf = (ctypes.c_void_p, ctypes.c_size_t)
    for name, args in (("prismer_jpeg_shape", (*data, ints, *err)),
                       ("prismer_jpeg_decode", (*data, *buf, *err)),
                       ("prismer_webp_info", (*data, ints, *err)),
                       ("prismer_webp_decode", (*data, *buf, *err)),
                       ("prismer_gif_info", (*data, ints, *err)),
                       ("prismer_gif_decode", (*data, *buf, *buf, *err))):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, err) -> None:
    if rc == 1:
        raise ValueError(err.value.decode(errors="replace"))
    if rc != 0:
        raise RuntimeError(err.value.decode(errors="replace"))


def _call(name: str, *args) -> None:
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(getattr(library(), name)(*args, err, _ERR_LEN), err)


def _check_mode(mode: Optional[str]) -> None:
    if mode not in (None, "RGB"):
        raise ValueError(f"mode {mode!r} is not None or 'RGB'")


def decode_jpeg_shape(data: bytes) -> Tuple[int, int]:
    """(height, width) from the frame header."""
    hw = (ctypes.c_int * 2)()
    _call("prismer_jpeg_shape", data, len(data), hw)
    return hw[0], hw[1]


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) RGB; `ValueError` for a stream the
    decoder refuses (the message names the feature) or finds corrupt."""
    h, w = decode_jpeg_shape(data)
    out = np.empty((h, w, 3), np.uint8)
    _call("prismer_jpeg_decode", data, len(data), out.ctypes.data, out.nbytes)
    return out


def webp_info(data: bytes) -> Tuple[int, int, str]:
    """(height, width, Pillow's mode "RGB" or "RGBA") of a WebP file."""
    info = (ctypes.c_int * 3)()
    _call("prismer_webp_info", data, len(data), info)
    return info[0], info[1], "RGBA" if info[2] else "RGB"


def decode_webp(data: bytes, mode: Optional[str] = None) -> np.ndarray:
    """WebP bytes -> uint8 (H, W, 3) for mode "RGB"; with no mode, Pillow's
    own mode: (H, W, 3) "RGB" or (H, W, 4) "RGBA"."""
    _check_mode(mode)
    h, w, own = webp_info(data)
    out = np.empty((h, w, 4), np.uint8)
    _call("prismer_webp_decode", data, len(data), out.ctypes.data, out.nbytes)
    keep = 4 if mode is None and own == "RGBA" else 3
    return np.ascontiguousarray(out[..., :keep])


def gif_info(data: bytes) -> Tuple[int, int, str]:
    """(height, width, Pillow's mode "P" or "L") of a GIF's first frame."""
    info = (ctypes.c_int * 4)()
    _call("prismer_gif_info", data, len(data), info)
    return info[0], info[1], "P" if info[2] else "L"


def decode_gif(data: bytes, mode: Optional[str] = None) -> np.ndarray:
    """GIF bytes -> uint8 (H, W, 3) for mode "RGB" (indices through the
    palette; entries past a short table are black); with no mode, Pillow's
    own mode: (H, W) palette indices ("P") or grey levels ("L")."""
    _check_mode(mode)
    info = (ctypes.c_int * 4)()
    _call("prismer_gif_info", data, len(data), info)
    h, w, is_p, npal = info
    out = np.empty((h, w), np.uint8)
    palette = np.zeros(npal, np.uint8)
    _call("prismer_gif_decode", data, len(data), out.ctypes.data, out.nbytes,
          palette.ctypes.data, palette.nbytes)
    if mode is None:
        return out
    if not is_p:
        return np.repeat(out[..., None], 3, -1)
    table = np.zeros((256, 3), np.uint8)
    entries = palette[:npal // 3 * 3].reshape(-1, 3)[:256]
    table[:len(entries)] = entries
    return table[out]
