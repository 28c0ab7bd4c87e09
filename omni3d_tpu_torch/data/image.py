"""Image files and resizing without OpenCV or PIL.

The card's machine has neither `cv2` nor `PIL`, so the port reads images
and resizes them itself, in numpy and the standard library:

  * `read_image_bgr` returns BGR uint8 (H, W, 3), as `cv2.imread(path,
    IMREAD_COLOR)` does, bit for bit. It decodes binary PPM (P6, maxval
    255), 8-bit non-interlaced PNG (grey, RGB, palette, grey+alpha, RGBA;
    alpha is dropped, as OpenCV drops it) with `zlib` and the five PNG row
    filters, and baseline / extended-sequential Huffman-coded JPEG with the
    port's own decoder (`data.jpeg`, EXIF orientation applied). Anything
    else, progressive JPEG included, raises `ValueError` naming the file.
  * `resize_bilinear_uint8` is PIL's `Image.resize(..., BILINEAR)` on uint8
    images (the resize detectron2's ResizeTransform applies), bit for bit:
    PIL's `ImagingResample` with its coefficients normalised in double,
    then 22-bit fixed point, a horizontal and then a vertical pass, each
    rounding and clipping to uint8. It is antialiased on downscale.
  * `write_png` / `write_ppm` write the formats the reader reads.
"""
from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

from .jpeg import decode_jpeg

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type -> samples per pixel
PRECISION_BITS = 32 - 8 - 2                         # PIL Resample.c


# ------------------------------ reading ------------------------------

def read_image_bgr(path: str) -> np.ndarray:
    """(H, W, 3) BGR uint8 image of a PPM, PNG or JPEG file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        return decode_png(data, path)
    if data[:2] == b"P6":
        return decode_ppm(data, path)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: unknown image format (read: binary PPM, 8-bit PNG, "
                     "baseline JPEG)")


def decode_ppm(data: bytes, path: str = "<ppm>") -> np.ndarray:
    """Binary PPM (P6) with maxval 255 -> BGR uint8."""
    fields, i = [], 2
    while len(fields) < 3:
        while data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":              # comment to the end of the line
            i = data.index(b"\n", i) + 1
            continue
        j = i
        while not data[j:j + 1].isspace():
            j += 1
        fields.append(int(data[i:j]))
        i = j
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"{path}: PPM maxval {maxval}; only 255 is read")
    i += 1                                     # the one whitespace byte after maxval
    rgb = np.frombuffer(data, np.uint8, h * w * 3, i).reshape(h, w, 3)
    return np.ascontiguousarray(rgb[..., ::-1])


def decode_png(data: bytes, path: str = "<png>") -> np.ndarray:
    """8-bit non-interlaced PNG -> BGR uint8 (alpha dropped, grey replicated,
    palette expanded)."""
    pos, idat, palette, header = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG bit depth {depth}, colour type {color}, interlace "
                         f"{interlace}; only 8-bit non-interlaced PNG is read")
    bpp = _PNG_CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    px = unfilter_png(raw, h, w * bpp, bpp).reshape(h, w, bpp)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        rgb = palette[px[..., 0]]
    elif color in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def unfilter_png(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth) of `h` rows of `stride` bytes each -> (h, stride) uint8. None,
    Sub and Up are vectorised; Average and Paeth depend on the decoded byte
    to their left, so they run along the row in Python integers."""
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:                        # Sub: a running sum per byte lane, mod 256
            cur = np.empty(stride, np.uint8)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp], dtype=np.uint8)
        elif kind == 2:                        # Up
            cur = line + prior
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(kind, line.tobytes(), prior.tobytes(),
                                                     bpp), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} unknown")
        out[y] = cur
        prior = out[y]
    return out


def _unfilter_sequential(kind: int, line: bytes, prior: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    if kind == 3:                              # Average
        for i in range(len(cur)):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + prior[i]) >> 1)) & 0xFF
        return bytes(cur)
    for i in range(len(cur)):                  # Paeth
        if i >= bpp:
            a, c = cur[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return bytes(cur)


# ------------------------------ writing ------------------------------

def write_ppm(path: str, image_bgr: np.ndarray) -> None:
    h, w = image_bgr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(image_bgr[..., ::-1]).tobytes())


def write_png(path: str, image_bgr: np.ndarray, filters=(0,)) -> None:
    """8-bit RGB PNG of a BGR uint8 image; row y uses the row filter
    filters[y % len(filters)] (0-4)."""
    rgb = np.ascontiguousarray(image_bgr[..., ::-1])
    h, w = rgb.shape[:2]
    rows = rgb.reshape(h, w * 3).astype(np.int16)
    out = bytearray()
    prior = np.zeros(w * 3, np.int16)
    for y in range(h):
        kind = filters[y % len(filters)]
        line = rows[y]
        left = np.concatenate([np.zeros(3, np.int16), line[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int16), prior[:-3]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(kind)
        out += ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = line

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(out), 6)) + chunk(b"IEND", b""))


# ------------------------------ resizing ------------------------------

@functools.lru_cache(maxsize=256)
def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the bilinear
    filter (support 1): per output index the first input index, and int32
    fixed-point weights of shape (out_size, ksize), zero past each window."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            ws.append(1.0 - t if t < 1.0 else 0.0)
        ww = 0.0
        for w in ws:                           # in order, as PIL sums
            ww += w
        for x, w in enumerate(ws):
            w = w / ww if ww != 0.0 else w
            kk[xx, x] = int((-0.5 if w < 0 else 0.5) + w * (1 << PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One PIL 8-bit resampling pass along `axis` (0 rows, 1 columns), in
    int32 as PIL sums: the bilinear weights are non-negative and sum to
    ~2^22, so 255 x their sum stays below 2^31."""
    xmins, kk = _bilinear_coeffs(img.shape[axis], out_size)
    idx = np.minimum(xmins[:, None] + np.arange(kk.shape[1]), img.shape[axis] - 1)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    for k in range(kk.shape[1]):
        acc += np.take(img, idx[:, k], axis=axis).astype(np.int32) * kk[:, k].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_uint8(image: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """PIL `Image.fromarray(image).resize((out_w, out_h), BILINEAR)` on an
    (H, W, C) uint8 array, bit for bit."""
    h, w = image.shape[:2]
    out = image
    if out_w != w:
        out = _resample_axis(out, out_w, 1)
    if out_h != h:
        out = _resample_axis(out, out_h, 0)
    return np.ascontiguousarray(out) if out is not image else image.copy()
