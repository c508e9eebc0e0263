#!/usr/bin/env python3
"""Write the JPEG fixture set, ``tests/data/jpeg/``, with OpenCV's encoder.

    python3 scripts/make_jpeg_fixtures.py

A dozen small JPEG files made from seeded numpy images, one of each kind the port's
decoder must read as OpenCV's libjpeg-turbo does (progressive, the five samplings,
restart intervals, optimised tables, grey, a quality-100 noise image, an EXIF
orientation), and ``manifest.json``: each file's shape and the SHA-256 of
``cv2.imdecode``'s RGB bytes without (``IMREAD_IGNORE_ORIENTATION``) and with the EXIF
orientation. ``tests/test_torch_jpeg.py`` recomputes the manifest against OpenCV, so it
cannot go stale; ``chip_smoke.py``'s ``jpeg`` phase holds the port's decoder to it on the
card's machine, which has no OpenCV.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIR = os.path.join(REPO, "tests", "data", "jpeg")
sys.path.insert(0, REPO)

from distributed_training_pytorch_tpu_torch.data.jpeg import with_orientation  # noqa: E402


def image(h: int, w: int, seed: int, kind: str = "smooth") -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([120 + 90 * np.sin(xx / 6 + yy / 9), 128 + 80 * np.cos(yy / 5), 40 + xx * 180 / w], -1)
    return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)


def fixtures(cv2) -> "dict[str, bytes]":
    def enc(img, **opts):
        params = []
        for k, v in opts.items():
            params += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
        ok, data = cv2.imencode(".jpg", img, params)
        assert ok
        return data.tobytes()

    f = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411
    return {
        "baseline_420_q90_odd.jpg": enc(image(37, 53, 0), quality=90),
        "progressive_420_q75.jpg": enc(image(48, 40, 1), quality=75, progressive=1),
        "progressive_444_q95_noise.jpg": enc(image(17, 23, 2, "noise"), quality=95, progressive=1,
                                             sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "sampling_422.jpg": enc(image(33, 45, 3), quality=85, sampling_factor=f[0]),
        "sampling_440.jpg": enc(image(41, 30, 4), quality=85, sampling_factor=f[1]),
        "sampling_411.jpg": enc(image(29, 61, 5), quality=85, sampling_factor=f[2]),
        "sampling_444.jpg": enc(image(25, 27, 6), quality=80, sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "restart_2.jpg": enc(image(40, 56, 7), quality=70, rst_interval=2),
        "optimized.jpg": enc(image(36, 44, 8), quality=60, optimize=1),
        "grey.jpg": enc(image(31, 39, 9)[..., 0], quality=90),
        "noise_q100.jpg": enc(image(32, 32, 10, "noise"), quality=100),
        "tiny_1x1.jpg": enc(image(1, 1, 11), quality=50),
        "exif_orientation_6.jpg": with_orientation(enc(image(37, 53, 12), quality=90), 6),
    }


def manifest(cv2, files: "dict[str, bytes]") -> dict:
    out = {}
    for name, data in sorted(files.items()):
        buf = np.frombuffer(data, np.uint8)
        plain = cv2.imdecode(buf, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)[..., ::-1]
        turned = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
        out[name] = {"shape": list(plain.shape), "sha256": hashlib.sha256(plain.tobytes()).hexdigest(),
                     "oriented_shape": list(turned.shape),
                     "sha256_oriented": hashlib.sha256(np.ascontiguousarray(turned).tobytes()).hexdigest()}
    return {"decoder": f"OpenCV {cv2.__version__}", "files": out}


def main() -> int:
    import cv2

    os.makedirs(DIR, exist_ok=True)
    files = fixtures(cv2)
    for name, data in files.items():
        with open(os.path.join(DIR, name), "wb") as f:
            f.write(data)
    with open(os.path.join(DIR, "manifest.json"), "w") as f:
        json.dump(manifest(cv2, files), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(files)} files, {sum(map(len, files.values()))} bytes, to {DIR}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
