"""The port's JPEG decoder (`omni3d_tpu_torch.data.jpeg`, csrc/jpeg_decode.cc)
against `cv2.imread(path, IMREAD_COLOR)`: bit-equal (tolerance 0) on the
committed fixtures (tests/data/jpeg/, written by its make_fixtures.py with
cv2 and each beside its cv2 decode as PNG), on every EXIF orientation and
on seeded encodings at every sampling factor cv2 writes. Progressive files,
damaged files and a failed g++ build raise."""
import os
import pathlib
import struct

import cv2
import numpy as np
import pytest

from omni3d_tpu_torch.data import image as timage
from omni3d_tpu_torch.data import jpeg as tjpeg

DATA = pathlib.Path(__file__).resolve().parent / "data" / "jpeg"
FIXTURES = sorted(p.stem for p in DATA.glob("*.jpg") if not p.stem.startswith("progressive"))


def test_fixture_set_covers_the_cases():
    names = set(FIXTURES)
    assert {"q30_420_37x53", "q75_420_37x53", "q95_444_37x53", "q75_422_37x53", "q75_grey_37x53",
            "q95_420_640x480", "q75_420_1242x375", "q75_420_restart_37x53",
            "q75_420_orient6_37x53"} <= names
    assert (DATA / "progressive_37x53.jpg").exists()
    assert sum(p.stat().st_size for p in DATA.iterdir()) <= 400_000


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_cv2(name):
    jpg = str(DATA / f"{name}.jpg")
    got = timage.read_image_bgr(jpg)
    np.testing.assert_array_equal(got, cv2.imread(jpg, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(got, cv2.imread(str(DATA / f"{name}.png"), cv2.IMREAD_COLOR))


def test_small_png_fixture_reads_through_the_port():
    """The committed decodes read back through the port's own PNG reader
    (what chip_smoke.py compares against on the card)."""
    png = str(DATA / "q75_420_37x53.png")
    np.testing.assert_array_equal(timage.read_image_bgr(png), cv2.imread(png, cv2.IMREAD_COLOR))


def _with_exif(data: bytes, orientation: int, little_endian: bool) -> bytes:
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    seg = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + data[2:]


@pytest.mark.parametrize("little_endian", [True, False])
def test_exif_orientations_as_cv2(tmp_path, little_endian):
    data = (DATA / "q75_420_37x53.jpg").read_bytes()
    for orientation in range(1, 9):
        path = tmp_path / f"o{orientation}.jpg"
        path.write_bytes(_with_exif(data, orientation, little_endian))
        got = timage.read_image_bgr(str(path))
        np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_COLOR),
                                      err_msg=f"orientation {orientation}")


@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444"])
def test_seeded_encodings_as_cv2(sampling):
    """Seeded noisy images at odd sizes, three qualities, with and without a
    restart interval."""
    rng = np.random.default_rng(int(sampling))
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for h, w in ((1, 1), (2, 3), (9, 17), (16, 16), (37, 53), (61, 30)):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        for q in (30, 75, 95):
            for extra in ([], [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]):
                ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q,
                                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
                                       + extra)
                assert ok
                np.testing.assert_array_equal(tjpeg.decode_jpeg(enc.tobytes()),
                                              cv2.imdecode(enc, cv2.IMREAD_COLOR),
                                              err_msg=f"{h}x{w} q{q} {extra}")
    grey = rng.integers(0, 256, (37, 53), np.uint8)
    ok, enc = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, 75])
    np.testing.assert_array_equal(tjpeg.decode_jpeg(enc.tobytes()),
                                  cv2.imdecode(enc, cv2.IMREAD_COLOR))


def test_unreadable_files_raise(tmp_path):
    with pytest.raises(ValueError, match="progressive_37x53.jpg: progressive JPEG"):
        timage.read_image_bgr(str(DATA / "progressive_37x53.jpg"))
    data = (DATA / "q75_420_37x53.jpg").read_bytes()
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:200])
    with pytest.raises(ValueError, match="cut.jpg: "):
        timage.read_image_bgr(str(cut))
    with pytest.raises(ValueError, match="x.jpg: not a JPEG"):
        tjpeg.decode_jpeg(b"\x00" * 16, "x.jpg")


def test_failed_build_raises(tmp_path, monkeypatch):
    fake = tmp_path / "bin"
    fake.mkdir()
    gxx = fake / "g++"
    gxx.write_text("#!/bin/sh\necho broken compiler >&2\nexit 3\n")
    gxx.chmod(0o755)
    monkeypatch.setattr(tjpeg, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tjpeg, "_lib", None)
    monkeypatch.setenv("PATH", str(fake))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed on jpeg_decode.cc \(3\)"):
        timage.read_image_bgr(str(DATA / "q75_420_37x53.jpg"))
    assert not list((tmp_path / "build").glob("*.so*"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        tjpeg.build()
    monkeypatch.setenv("PATH", os.environ["PATH"])
