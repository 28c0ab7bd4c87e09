"""JPEG decoding without cv2 or PIL: the port's baseline decoder
(`csrc/jpeg_decode.cc`) through ctypes.

`decode_jpeg` returns what `cv2.imread(path, IMREAD_COLOR)` returns for a
baseline or extended-sequential Huffman-coded 8-bit file, bit for bit: the
decoder follows libjpeg-turbo's accurate integer IDCT, fancy upsampling and
YCbCr -> BGR tables, grey is replicated to three channels, and the EXIF
orientation (tags 2-8) is applied as `cv2.imread` applies it. Progressive,
lossless, hierarchical, arithmetic-coded and 12-bit files raise
`ValueError` naming the file and the mode.

The C++ source is compiled with g++ at first use into `_build/`
(`utils.cxx.build_library`); a failed build or load raises.
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from ..utils import cxx

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "jpeg_decode.cc"
BUILD_DIR = cxx.BUILD_DIR
_ERRLEN = 256

_lib = None


def build() -> pathlib.Path:
    """Compile the decoder unless a build of this source exists; returns
    its path."""
    return cxx.build_library(SOURCE, BUILD_DIR)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
        lib.jpeg_header.argtypes = [u8p, ctypes.c_long, ip, ip, ip, ctypes.c_char_p,
                                    ctypes.c_int]
        lib.jpeg_header.restype = ctypes.c_int
        lib.jpeg_decode_bgr.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long,
                                        ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_decode_bgr.restype = ctypes.c_int
        _lib = lib
    return _lib


def apply_orientation(image: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation as `cv2.imread` applies it (2 flips
    horizontally, 3 rotates 180, 4 flips vertically, 5 transposes, 6
    rotates 90 clockwise, 7 transverses, 8 rotates 90 counter-clockwise)."""
    if orientation in (5, 6, 7, 8):
        image = image.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flip:
        image = np.flip(image, flip)
    return np.ascontiguousarray(image)


def decode_jpeg(data: bytes, path: str = "<jpeg>") -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) BGR uint8, oriented by its EXIF tag."""
    lib = _library()
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h, orient = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_header(src, len(buf), ctypes.byref(w), ctypes.byref(h), ctypes.byref(orient),
                       err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode_bgr(src, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           out.size, err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return apply_orientation(out, orient.value)
