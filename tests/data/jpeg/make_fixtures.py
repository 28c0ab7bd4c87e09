"""Write the JPEG fixtures of tests/test_torch_jpeg.py with cv2, each with
its `cv2.imread(path, IMREAD_COLOR)` decode beside it as PNG.

    python tests/data/jpeg/make_fixtures.py

The scenes are drawn from a seed: flat shapes on a coarse gradient with one
small noisy patch, so the JPEG files carry real AC content while the PNG
decodes stay small.
"""
import os
import struct

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def scene(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 4 // w * 40 + 40, y * 4 // h * 40 + 40, np.full((h, w), 90)], -1)
    img = img.astype(np.uint8)
    for _ in range(4):
        c = tuple(int(v) for v in rng.integers(0, 256, 3))
        p = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        if rng.random() < 0.5:
            q = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            cv2.rectangle(img, p, q, c, -1)
        else:
            cv2.circle(img, p, int(rng.integers(2, max(3, min(h, w) // 4))), c, -1)
    ph, pw = max(h // 12, 1), max(w // 12, 1)
    img[:ph, -pw:] = rng.integers(0, 256, (ph, pw, 3))
    return img


def exif_orientation(data: bytes, orientation: int) -> bytes:
    """`data` with an APP1 Exif segment (little-endian TIFF, one IFD entry:
    the orientation) after SOI."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    seg = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + data[2:]


S = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}") for s in ("420", "422", "444")}
# name: (height, width, quality, sampling, extra imwrite params, grey)
FIXTURES = {
    "q95_420_640x480": (480, 640, 95, "420", [], False),
    "q75_420_1242x375": (375, 1242, 75, "420", [], False),
    "q95_444_37x53": (37, 53, 95, "444", [], False),
    "q75_422_37x53": (37, 53, 75, "422", [], False),
    "q30_420_37x53": (37, 53, 30, "420", [], False),
    "q75_420_37x53": (37, 53, 75, "420", [], False),
    "q75_grey_37x53": (37, 53, 75, None, [], True),
    "q75_420_restart_37x53": (37, 53, 75, "420", [cv2.IMWRITE_JPEG_RST_INTERVAL, 2], False),
}


def main():
    for i, (name, (h, w, q, samp, extra, grey)) in enumerate(FIXTURES.items()):
        img = scene(h, w, i)
        if grey:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        params = [cv2.IMWRITE_JPEG_QUALITY, q] + extra
        if samp:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S[samp]]
        path = os.path.join(HERE, name + ".jpg")
        cv2.imwrite(path, img, params)
        cv2.imwrite(os.path.join(HERE, name + ".png"), cv2.imread(path, cv2.IMREAD_COLOR),
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])
    ok, enc = cv2.imencode(".jpg", scene(37, 53, 20), [cv2.IMWRITE_JPEG_QUALITY, 75])
    path = os.path.join(HERE, "q75_420_orient6_37x53.jpg")
    with open(path, "wb") as f:
        f.write(exif_orientation(enc.tobytes(), 6))
    cv2.imwrite(path[:-4] + ".png", cv2.imread(path, cv2.IMREAD_COLOR),
                [cv2.IMWRITE_PNG_COMPRESSION, 9])
    cv2.imwrite(os.path.join(HERE, "progressive_37x53.jpg"), scene(37, 53, 21),
                [cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])


if __name__ == "__main__":
    main()
