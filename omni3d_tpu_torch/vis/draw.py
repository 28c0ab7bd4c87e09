"""Drawing primitives on numpy canvases, without cv2 (absent where the port
runs on the card): the counterparts of the cv2 calls the visualisation
makes.

`line`, `rectangle` and `polylines` follow OpenCV's drawing code
(imgproc/drawing.cpp) for 8-connected lines with integer end points:
thickness 1 walks the line with `LineIterator` (left to right, 8-connected
Bresenham) after `clip_line` (cv2.clipLine) cuts it to the canvas;
thicker lines are clipped to the canvas grown by the thickness, then
fill the quadrilateral around the segment in 16-bit fixed point
(`FillConvexPoly` with its `Line2` edges) and round its caps with filled
circles. Both are bit-equal to cv2 5.0 on this repo's tests. They draw on (H, W, C) canvases of any dtype (uint8 and the
float64 canvas of the novel view alike), the colour cast to the canvas.

`put_text` is not cv2.putText: cv2's Hershey glyph data comes with cv2,
which the port does not use. It draws the port's own 3 x 5 bitmap font (upper-case letters,
digits and common punctuation; lower case is drawn upper-case, other
characters as a box), scaled to cv2's FONT_HERSHEY_SIMPLEX metrics at the
same scale, so the text stays inside the box `cv2.getTextSize` gives at
the same origin. It is solid, not anti-aliased.
"""
from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _hline(img, y, x1, x2, color):
    img[y, x1:x2 + 1] = color


def _color(img, color):
    c = np.asarray(color, np.float64).reshape(-1)[: img.shape[2]]
    return c.astype(img.dtype) if img.dtype != np.uint8 else np.clip(np.rint(c), 0, 255).astype(
        np.uint8)


def clip_line(width: int, height: int, p1, p2):
    """cv2.clipLine((0, 0, width, height), p1, p2): (inside, p1, p2) with
    the end points moved onto the canvas where the segment crosses it."""
    x1, y1 = int(p1[0]), int(p1[1])
    x2, y2 = int(p2[0]), int(p2[1])
    if width <= 0 or height <= 0:
        return False, (x1, y1), (x2, y2)
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(width: int, height: int, p1, p2):
    """(xs, ys) of the pixels cv2.line(..., thickness=1, LINE_8) sets,
    after clipping (OpenCV's LineIterator, left to right)."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if not (0 <= x1 < width and 0 <= x2 < width and 0 <= y1 < height and 0 <= y2 < height):
        ok, (x1, y1), (x2, y2) = clip_line(width, height, (x1, y1), (x2, y2))
        if not ok:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # The iterator's error term starts at dx - 2dy, loses 2dy per pixel and
    # gains 2dx per minor-axis step, taken when it is negative: before pixel
    # k it has made ceil((2dy k - dx) / 2dx) minor steps (none below zero).
    major = np.arange(dx + 1, dtype=np.int64)
    minor = np.maximum(0, -((dx - 2 * dy * major) // (2 * dx))) if dy else np.zeros_like(major)
    if vert:
        return x1 + minor, y1 + sy * major
    return x1 + major, y1 + sy * minor


def _line1(img, p1, p2, color):
    xs, ys = line_pixels(img.shape[1], img.shape[0], p1, p2)
    img[ys, xs] = color


def _line2(img, p1, p2, color):
    """OpenCV's Line2: an 8-connected line between 16-bit fixed-point end
    points, clipped to the canvas."""
    h, w = img.shape[:2]
    ok, (x1, y1), (x2, y2) = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    pts = [((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)]
    i = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + i
        ys = (y1 + y_step * i) >> XY_SHIFT
    else:
        xs = (x1 + x_step * i) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + i
    xs = np.concatenate([[pts[0][0]], xs])
    ys = np.concatenate([[pts[0][1]], ys])
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _fill_convex_poly(img, v, color, shift):
    """OpenCV's FillConvexPoly for 8-connected drawing: the outline with
    Line2, then the scanlines between the two edge walkers."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    delta1 = delta2 = XY_ONE >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        p = (x << (XY_SHIFT - shift), y << (XY_SHIFT - shift))
        if shift == 0:
            _line1(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT), (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT),
                   color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    y = ymin
    edges = npts
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = (idx0 + di) % npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta1) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _circle_filled(img, cx, cy, radius, color):
    """OpenCV's Circle with fill: the midpoint circle's spans."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            if 0 <= y11 < h:
                _hline(img, y11, x11, x12, color)
            if 0 <= y12 < h:
                _hline(img, y12, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                if 0 <= y21 < h:
                    _hline(img, y21, x21, x22, color)
                if 0 <= y22 < h:
                    _hline(img, y22, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img, p0, p1, color, thickness, flags):
    """OpenCV's ThickLine for 8-connected lines of integer end points; a
    thick segment is first clipped to the canvas grown by the thickness on
    every side (OpenCV 5)."""
    if thickness <= 1:
        _line1(img, p0, p1, color)
        return
    h, w = img.shape[:2]
    m = thickness
    ok, p0, p1 = clip_line(w + 2 * m, h + 2 * m, (int(p0[0]) + m, int(p0[1]) + m),
                           (int(p1[0]) + m, int(p1[1]) + m))
    if not ok:
        return
    p0, p1 = (p0[0] - m, p0[1] - m), (p1[0] - m, p1[1] - m)
    p0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    p1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > 2.220446049250313e-16:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        pts = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
               (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, pts, color, XY_SHIFT)
    for i in range(2):
        if flags & (i + 1):
            cx = (p0[0] + (XY_ONE >> 1)) >> XY_SHIFT
            cy = (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT
            _circle_filled(img, cx, cy, (thickness + (XY_ONE >> 1)) >> XY_SHIFT, color)
        p0 = p1


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p1, p2, color, thickness) with LINE_8, in place."""
    _thick_line(img, p1, p2, _color(img, color), int(thickness), 3)
    return img


def polylines(img: np.ndarray, pts, is_closed: bool, color, thickness: int = 1) -> np.ndarray:
    """cv2.polylines(img, [pts], is_closed, color, thickness) with LINE_8
    for one polygon of integer points, in place."""
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    if not v:
        return img
    c = _color(img, color)
    i = len(v) - 1 if is_closed else 0
    flags = 2 + (not is_closed)
    p0 = v[i]
    for i in range(int(not is_closed), len(v)):
        _thick_line(img, p0, v[i], c, int(thickness), flags)
        p0 = v[i]
        flags = 2
    return img


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.rectangle(img, p1, p2, color, thickness) with LINE_8 (outline;
    a negative thickness fills), in place."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness < 0:
        _fill_convex_poly(img, pts, _color(img, color), 0)
        return img
    return polylines(img, pts, True, color, thickness)


# ------------------------------ text ------------------------------
# cv2's FONT_HERSHEY_SIMPLEX (OpenCV 5) at scale 1: the advance of each
# printable ASCII character 32..126 in hundredths of a pixel, and the text
# height. cv2.getTextSize's width of a string is at least ~0.79 of the sum of
# its advances (the outer bearings are left out), so characters are laid out
# at 0.75 of their advance and stay inside that width.
_ADVANCE = (
    746, 705, 1078, 2012, 1783, 2197, 2006, 627, 1786, 1786, 1286, 1795, 720, 1399, 726, 1390,
    1786, 1786, 1786, 1786, 1786, 1786, 1786, 1786, 1786, 1786, 740, 783, 1419, 1645, 1416, 1535,
    2402, 1934, 1931, 1925, 1989, 1752, 1688, 1966, 2061, 786, 1830, 1737, 1624, 2295, 2006, 1957,
    1856, 1957, 1893, 1798, 1671, 2026, 1890, 2312, 1830, 1867, 1734, 939, 1390, 939, 1246, 2159,
    974, 1596, 1720, 1596, 1720, 1619, 1110, 1723, 1757, 697, 734, 1492, 702, 2570, 1749, 1656,
    1723, 1723, 1096, 1474, 1130, 1737, 1598, 2315, 1558, 1593, 1468, 1064, 671, 1064, 1619)
TEXT_HEIGHT = 27.0
PITCH = 0.75

# 3 x 5 glyphs, one row per 3-bit group from the top (bit 2 = left column).
_GLYPHS = {
    " ": (0, 0, 0, 0, 0), "!": (2, 2, 2, 0, 2), '"': (5, 5, 0, 0, 0), "#": (5, 7, 5, 7, 5),
    "%": (5, 1, 2, 4, 5), "'": (2, 2, 0, 0, 0), "(": (1, 2, 2, 2, 1), ")": (4, 2, 2, 2, 4),
    "*": (0, 5, 2, 5, 0), "+": (0, 2, 7, 2, 0), ",": (0, 0, 0, 2, 4), "-": (0, 0, 7, 0, 0),
    ".": (0, 0, 0, 0, 2), "/": (1, 1, 2, 4, 4), ":": (0, 2, 0, 2, 0), ";": (0, 2, 0, 2, 4),
    "<": (1, 2, 4, 2, 1), "=": (0, 7, 0, 7, 0), ">": (4, 2, 1, 2, 4), "?": (7, 1, 2, 0, 2),
    "_": (0, 0, 0, 0, 7), "[": (3, 2, 2, 2, 3), "]": (6, 2, 2, 2, 6),
    "0": (7, 5, 5, 5, 7), "1": (2, 6, 2, 2, 7), "2": (7, 1, 7, 4, 7), "3": (7, 1, 7, 1, 7),
    "4": (5, 5, 7, 1, 1), "5": (7, 4, 7, 1, 7), "6": (7, 4, 7, 5, 7), "7": (7, 1, 1, 2, 2),
    "8": (7, 5, 7, 5, 7), "9": (7, 5, 7, 1, 7),
    "A": (2, 5, 7, 5, 5), "B": (6, 5, 6, 5, 6), "C": (3, 4, 4, 4, 3), "D": (6, 5, 5, 5, 6),
    "E": (7, 4, 6, 4, 7), "F": (7, 4, 6, 4, 4), "G": (3, 4, 5, 5, 3), "H": (5, 5, 7, 5, 5),
    "I": (7, 2, 2, 2, 7), "J": (1, 1, 1, 5, 2), "K": (5, 5, 6, 5, 5), "L": (4, 4, 4, 4, 7),
    "M": (5, 7, 7, 5, 5), "N": (6, 5, 5, 5, 5), "O": (2, 5, 5, 5, 2), "P": (6, 5, 6, 4, 4),
    "Q": (2, 5, 5, 6, 3), "R": (6, 5, 6, 5, 5), "S": (3, 4, 2, 1, 6), "T": (7, 2, 2, 2, 2),
    "U": (5, 5, 5, 5, 7), "V": (5, 5, 5, 5, 2), "W": (5, 5, 7, 7, 5), "X": (5, 5, 2, 5, 5),
    "Y": (5, 5, 2, 2, 2), "Z": (7, 1, 2, 4, 7),
}
_BOX = (7, 5, 5, 5, 7)


def put_text(img: np.ndarray, text: str, org, scale: float, color, thickness: int = 1):
    """Draw `text` with its baseline's left end at `org`: each character a
    3 x 5 glyph in the left 60% of a cell PITCH x its FONT_HERSHEY_SIMPLEX
    advance wide and 3/4 of the font's height tall above the baseline
    (`thickness` is ignored), in place."""
    h, w = img.shape[:2]
    c = _color(img, color)
    cap = max(int(0.75 * TEXT_HEIGHT * scale), 5)
    x0, base = float(org[0]), int(org[1])
    for ch in text:
        pitch = (_ADVANCE[ord(ch) - 32] if 32 <= ord(ch) < 127 else _ADVANCE[31]) / 100 * scale * PITCH
        glyph = _GLYPHS.get(ch.upper(), _BOX)
        cell_w = max(int(0.6 * pitch), 3)
        left = int(x0)
        for r, bits in enumerate(glyph):
            ya = max(base - cap + r * cap // 5, 0)
            yb = min(base - cap + (r + 1) * cap // 5, h)
            for col in range(3):
                if bits >> (2 - col) & 1:
                    xa = max(left + col * cell_w // 3, 0)
                    xb = min(left + (col + 1) * cell_w // 3, w)
                    if ya < yb and xa < xb:
                        img[ya:yb, xa:xb] = c
        x0 += pitch
    return img
