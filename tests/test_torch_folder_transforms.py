"""The image-folder train chain's transforms and the port's decoders, held against the JAX
package's transforms (``distributed_training_pytorch_tpu/data/transforms.py``, which call
OpenCV) and against ``cv2.imread`` on the CPU.

The card's machine has no OpenCV, PIL or codec library, so the port reproduces each piece
in ``csrc/dtp_native.cpp`` (``data/native.py``): the PNG scanline unfilter, ``cv2.blur``,
``cv2.medianBlur``, CLAHE over LAB, and the JPEG re-encoding's lossy arithmetic. The JAX
package's ``data`` package needs the ``data.streaming`` stand-in, so its transforms run
in a subprocess started here (as ``tests/test_torch_trainer_cifar10.py`` does), under the
same ``philox_key`` as the port's.

Tolerances (measured on the CPU against OpenCV 5.0 with libjpeg-turbo 3.1.2 and libpng 1.6):

* rotate90, the flips, brightness/contrast, gamma, median blur: bit-equal;
* box blur (k 3, 5, 7): bit-equal (integer window sums, rounded; k^2 is odd, no ties);
* CLAHE at 224x224 and 50x70 (and 37x53): bit-equal, so the mean |delta| and its
  99.9th percentile are both 0, and the test holds them to 0;
* the JPEG round trip at q 80, 90, 100 and 224x224 and 37x53 (and every size from 1x1 to
  19x19): bit-equal, so the share of differing pixels is 0 and the largest difference 0;
* ``train_transform`` over 64 records: the same Philox draws in the same order (so the
  same transforms fire with the same parameters), and bit-equal outputs where the resize
  is the identity;
* the PNG decoder (filters 0-4, color types 0/2/3/4/6, bit depths 1/2/4/8/16, and
  ``cv2.imwrite`` output) and the BMP decoder (24-bit, 8-bit palette, and ``cv2.imwrite``
  output): byte-equal to ``cv2.imread(path)[..., ::-1]``.
"""

import json
import os
import struct
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest

from distributed_training_pytorch_tpu_torch.data import dataset, native
from distributed_training_pytorch_tpu_torch.data import transforms as T

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, EPOCH = 11, 2

# name, transform, kwargs, image, record indices (each its own Philox key)
CASES = [
    ("rot90", "random_rotate90", {"p": 1.0}, "rand224", [0, 1, 2, 3, 4, 5]),
    ("hflip", "horizontal_flip", {"p": 0.5}, "rand37", list(range(8))),
    ("vflip", "vertical_flip", {"p": 0.5}, "rand37", list(range(8))),
    ("bc", "random_brightness_contrast", {"p": 1.0}, "smooth224", [0, 1, 2, 3]),
    ("bc37", "random_brightness_contrast", {"p": 0.5}, "rand37", list(range(6))),
    ("gamma", "random_gamma", {"p": 1.0}, "smooth224", [0, 1, 2, 3]),
    ("gamma50", "random_gamma", {"p": 1.0}, "rand50", [4, 5]),
    ("median", "median_blur", {"p": 1.0}, "rand224", list(range(6))),
    ("median50", "median_blur", {"p": 1.0}, "smooth50", list(range(4))),
    ("blur", "blur", {"p": 1.0}, "rand224", list(range(8))),
    ("blur37", "blur", {"p": 1.0}, "smooth37", list(range(8))),
    ("clahe224", "clahe", {"p": 1.0}, "smooth224", [0]),
    ("clahe224r", "clahe", {"p": 1.0}, "rand224", [0]),
    ("clahe50", "clahe", {"p": 1.0}, "smooth50", [0]),
    ("clahe37", "clahe", {"p": 1.0}, "rand37", [0]),
] + [
    (f"jpeg{q}_{img}", "image_compression", {"p": 1.0, "quality_range": [q, q]}, img, [0])
    for q in (80, 90, 100) for img in ("rand224", "smooth224", "rand37", "smooth37")
] + [("jpeg_any", "image_compression", {"p": 0.5}, "smooth50", list(range(8)))]

CHAIN_RECORDS = 64

_JAX_SIDE = textwrap.dedent(
    """
    import json, sys, types
    import numpy as np

    stub = types.ModuleType("distributed_training_pytorch_tpu.data.streaming")
    def _unavailable(*a, **k):
        raise RuntimeError("data/streaming is not in this tree")
    for name in ("DecodePool", "ReaderState", "StreamingLoader", "shard_array_source"):
        setattr(stub, name, _unavailable)
    sys.modules[stub.__name__] = stub
    from distributed_training_pytorch_tpu.data import transforms as T

    inputs, out, cases, seed, epoch, n_chain = sys.argv[1:7]
    seed, epoch, n_chain, cases = int(seed), int(epoch), int(n_chain), json.loads(cases)
    images = dict(np.load(inputs))
    {LOGGED}
    res, logs = {}, {}
    for name, fn, kw, image, indices in cases:
        for i in indices:
            rng = Logged(seed, epoch, i)
            res[f"{name}/{i}"] = np.ascontiguousarray(getattr(T, fn)(**kw)(images[image], rng))
            logs[f"{name}/{i}"] = rng.log
    for size_name, (h, w) in (("same", (48, 48)), ("resized", (40, 56))):
        chain = T.train_transform(h, w, seed=seed)
        for i in range(n_chain):
            rng = Logged(seed, epoch, i)
            img = images[f"chain{i % 4}"]
            for t in chain.transforms:
                img = t(img, rng)
            res[f"chain_{size_name}/{i}"] = np.ascontiguousarray(img)
            logs[f"chain_{size_name}/{i}"] = rng.log
    np.savez(out, **{k.replace("/", "__"): v for k, v in res.items()})
    with open(out + ".json", "w") as f:
        json.dump(logs, f)
    """
)

# A generator that logs every draw, so the two sides' draw sequences can be compared.
_LOGGED = textwrap.dedent(
    """
    class Logged:
        def __init__(self, seed, epoch, index):
            self.g = np.random.Generator(np.random.Philox(key=T.philox_key(seed, epoch, index)))
            self.log = []
        def random(self):
            v = self.g.random(); self.log.append(["random", float(v)]); return v
        def integers(self, *a):
            v = self.g.integers(*a); self.log.append(["integers", list(map(int, a)), int(v)]); return v
        def uniform(self, *a):
            v = self.g.uniform(*a); self.log.append(["uniform", list(map(float, a)), float(v)]); return v
    """
)
exec(_LOGGED)  # the port side's Logged, over the port's transforms module


def _images():
    rng = np.random.RandomState(5)

    def smooth(h, w):
        small = (rng.rand(6, 6, 3) * 256).astype(np.uint8)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)

    images = {
        "rand224": (rng.rand(224, 224, 3) * 256).astype(np.uint8),
        "smooth224": smooth(224, 224),
        "rand37": (rng.rand(37, 53, 3) * 256).astype(np.uint8),
        "smooth37": smooth(37, 53),
        "rand50": (rng.rand(50, 70, 3) * 256).astype(np.uint8),
        "smooth50": smooth(50, 70),
    }
    for i, (h, w) in enumerate([(48, 48), (48, 48), (61, 33), (30, 77)]):
        images[f"chain{i}"] = smooth(h, w) if i % 2 else (rng.rand(h, w, 3) * 256).astype(np.uint8)
    return images


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_transforms")
    images = _images()
    np.savez(tmp / "inputs.npz", **images)
    out = str(tmp / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    script = _JAX_SIDE.replace("{LOGGED}", _LOGGED)
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp / "inputs.npz"), out, json.dumps(CASES), str(SEED), str(EPOCH),
         str(CHAIN_RECORDS)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out + ".json") as f:
        logs = json.load(f)
    ref = {k.replace("__", "/"): v for k, v in np.load(out).items()}
    return images, ref, logs


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_transform_is_bit_equal_to_the_jax_transform(jax_side, case):
    images, ref, logs = jax_side
    name, fn, kw, image, indices = case
    for i in indices:
        rng = Logged(SEED, EPOCH, i)  # noqa: F821 (defined by the exec above)
        got = np.ascontiguousarray(getattr(T, fn)(**kw)(images[image], rng))
        want = ref[f"{name}/{i}"]
        assert rng.log == logs[f"{name}/{i}"], f"{name} record {i}: the draws differ"
        assert got.shape == want.shape and got.dtype == want.dtype
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        # CLAHE and the JPEG round trip: the share of differing pixels, the mean |delta|
        # and its 99.9th percentile, each held to the 0 measured.
        assert (diff != 0).mean() == 0.0 and diff.mean() == 0.0 and np.percentile(diff, 99.9) == 0.0, (
            f"{name} record {i}: {(diff != 0).mean():.4%} of values differ, by up to {diff.max()}")


@pytest.mark.parametrize("quality", [80, 90, 100])
def test_jpeg_round_trip_is_bit_equal_to_cv2_at_every_small_size(quality):
    """Every size from 1x1 to 19x19: the edges of 4:2:0 (odd sizes, partial blocks, and
    libjpeg-turbo's plain 2x2 chroma replication where a chroma row is 2 samples or less)."""
    rng = np.random.RandomState(quality)
    for h in range(1, 20):
        for w in range(1, 20):
            img = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
            ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[:, :, ::-1]), [int(cv2.IMWRITE_JPEG_QUALITY), quality])
            assert ok
            want = cv2.imdecode(enc, cv2.IMREAD_COLOR)[:, :, ::-1]
            np.testing.assert_array_equal(native.jpeg_roundtrip(img, quality), want, err_msg=f"{h}x{w}")


def test_random_transforms_fire_and_are_counted(jax_side):
    images, _, logs = jax_side
    before = dict(T.FIRED)
    for name, fn, kw, image, indices in CASES:
        for i in indices:
            getattr(T, fn)(**kw)(images[image], Logged(SEED, EPOCH, i))  # noqa: F821
    fired = {k: T.FIRED[k] - before.get(k, 0) for k in T.FIRED}
    # a transform fired where its first draw was below p
    for fn in {c[1] for c in CASES}:
        expect = sum(logs[f"{c[0]}/{i}"][0][1] < c[2]["p"] for c in CASES if c[1] == fn for i in c[4])
        assert fired.get(fn, 0) == expect > 0, fn


@pytest.mark.parametrize("size", ["same", "resized"])
def test_train_transform_fires_the_same_transforms_as_the_jax_chain(jax_side, size):
    images, ref, logs = jax_side
    h, w = (48, 48) if size == "same" else (40, 56)
    chain = T.train_transform(h, w, seed=SEED)
    assert len(chain.transforms) == 11  # ten steps, then normalise
    fired_any = set()
    for i in range(CHAIN_RECORDS):
        rng = Logged(SEED, EPOCH, i)  # noqa: F821
        img = images[f"chain{i % 4}"]
        for t in chain.transforms:
            img = t(img, rng)
        assert rng.log == logs[f"chain_{size}/{i}"], f"record {i}: the draws differ"
        want = ref[f"chain_{size}/{i}"]
        assert img.shape == want.shape == (h, w, 3) or img.shape == want.shape == (w, h, 3)
        if size == "same" and i % 4 < 2:  # 48x48 records into a 48x48 chain: the resize is the identity
            np.testing.assert_array_equal(img, want)
        fired_any.update(j for j, d in enumerate(rng.log) if d[0] == "random" and d[1] < 0.5)
    assert len(fired_any) > 0


def test_the_chain_is_keyed_by_seed_epoch_and_index():
    img = _images()["smooth50"]
    chain = T.train_transform(32, 32, seed=3)
    a = chain(img, epoch=1, index=5)
    assert np.array_equal(a, chain(img, epoch=1, index=5))
    assert not np.array_equal(a, chain(img, epoch=2, index=5)) or not np.array_equal(a, chain(img, epoch=1, index=6))
    assert a.dtype == np.float32 and a.shape == (32, 32, 3)


# ----------------------------------------------------------------------------- decoders


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def write_png(path, rows, width, height, depth, color, palette=None, interlace=0):
    """A PNG of raw scanline bytes, row ``y`` filtered with filter type ``y % 5`` (so every
    type 0-4 occurs)."""
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth // 8)
    stream, prev = b"", bytes(len(rows[0]))
    for y, row in enumerate(rows):
        f, enc = y % 5, bytearray()
        for i, v in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            enc.append((v - [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]) & 255)
        stream += bytes([f]) + bytes(enc)
        prev = row
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette)
    data += _chunk(b"IDAT", zlib.compress(stream)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _pack(samples, depth):
    if depth == 8:
        return [bytes(r.astype(np.uint8)) for r in samples]
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in samples]
    bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth :].reshape(len(samples), -1)
    bits = np.pad(bits, ((0, 0), (0, (-bits.shape[1]) % 8)))
    return [bytes(np.packbits(r)) for r in bits]


PNG_KINDS = [(c, d) for c, ds in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
             for d in ds]


@pytest.mark.parametrize("color, depth", PNG_KINDS, ids=[f"type{c}-{d}bit" for c, d in PNG_KINDS])
def test_png_decoder_is_byte_equal_to_cv2(tmp_path, color, depth):
    rng = np.random.RandomState(color * 100 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for h, w in ((7, 13), (16, 16), (1, 5), (11, 3)):
        palette = None
        if color == 3:
            n = min(1 << depth, 200)
            samples = rng.randint(0, n, size=(h, w))
            palette = bytes(rng.randint(0, 256, size=n * 3).astype(np.uint8))
        else:
            samples = rng.randint(0, 1 << depth, size=(h, w * channels))
        path = str(tmp_path / f"{h}x{w}.png")
        write_png(path, _pack(samples, depth), w, h, depth, color, palette)
        want = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
        np.testing.assert_array_equal(dataset.decode_image(path), want)


def write_bmp(path, rgb, bits=24, palette=None):
    """An uncompressed bottom-up BMP: 24-bit BGR rows padded to 4 bytes, or 8-bit indices
    (``rgb`` is then [H, W] indices into ``palette``, [n, 3] RGB)."""
    h, w = rgb.shape[:2]
    if bits == 24:
        rows = rgb[::-1, :, ::-1].reshape(h, w * 3)
        table = b""
    else:
        rows = rgb[::-1].astype(np.uint8)
        table = np.concatenate([palette[:, ::-1], np.zeros((len(palette), 1), np.uint8)], 1).tobytes()
    stride = (w * bits // 8 + 3) // 4 * 4
    pixels = np.zeros((h, stride), np.uint8)
    pixels[:, : rows.shape[1]] = rows
    offset = 14 + 40 + len(table)
    header = struct.pack("<2sIHHI", b"BM", offset + pixels.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, pixels.size, 2835, 2835,
                       len(table) // 4 if bits == 8 else 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + table + pixels.tobytes())


def test_bmp_decoder_is_byte_equal_to_cv2(tmp_path):
    rng = np.random.RandomState(2)
    for h, w in ((9, 13), (16, 16), (1, 3), (5, 1)):
        rgb = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
        write_bmp(str(tmp_path / "a.bmp"), rgb)
        np.testing.assert_array_equal(dataset.decode_image(str(tmp_path / "a.bmp")), rgb)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.bmp"))[:, :, ::-1], rgb)
        palette = rng.randint(0, 256, size=(37, 3)).astype(np.uint8)
        index = rng.randint(0, 37, size=(h, w))
        write_bmp(str(tmp_path / "p.bmp"), index, bits=8, palette=palette)
        want = cv2.imread(str(tmp_path / "p.bmp"))[:, :, ::-1]
        np.testing.assert_array_equal(want, palette[index])
        np.testing.assert_array_equal(dataset.decode_image(str(tmp_path / "p.bmp")), want)


@pytest.mark.parametrize("ext", [".png", ".bmp", ".jpg", "gray.png", "gray.bmp", "rgba.png", "rgba.bmp", "16.png"])
def test_decoders_read_what_cv2_writes(tmp_path, ext):
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, size=(33, 47, 3)).astype(np.uint8)
    if ext.startswith("gray"):
        img = img[:, :, 0]
    elif ext.startswith("rgba"):
        img = np.dstack([img, img[:, :, :1]])
    elif ext.startswith("16"):
        img = img.astype(np.uint16) * 257 + rng.randint(0, 256, size=img.shape).astype(np.uint16)
    path = str(tmp_path / f"x{ext}")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(dataset.decode_image(path), cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1])


def test_undecodable_files_raise_naming_the_file_and_a_jpeg_decodes_without_codecs(tmp_path, monkeypatch):
    """Adam7 PNG, WebP and a cut PNG or JPEG raise a ``DecodeError`` naming the file; a
    JPEG decodes through the port's own decoder on a library built without codecs (the
    card's machine), byte-equal to ``cv2.imread``."""
    interlaced = str(tmp_path / "adam7.png")
    write_png(interlaced, [bytes(6)] * 2, 2, 2, 8, 2, interlace=1)
    with pytest.raises(native.DecodeError, match=r"adam7\.png.*Adam7"):
        dataset.decode_image(interlaced)
    webp = tmp_path / "x.webp"
    webp.write_bytes(b"RIFF\x00\x00\x00\x00WEBPVP8 ")
    with pytest.raises(native.DecodeError, match=r"x\.webp.*WebP"):
        dataset.decode_image(str(webp))
    jpg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpg, np.random.RandomState(4).randint(0, 256, size=(11, 13, 3)).astype(np.uint8))
    monkeypatch.setattr(native, "_codecs_installed", lambda workdir: False)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "lib" / "libdtp_native.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available(), native.build_error()
    assert not native.codecs_available()
    np.testing.assert_array_equal(dataset.decode_image(jpg), cv2.imread(jpg, cv2.IMREAD_COLOR)[:, :, ::-1])
    cut = tmp_path / "cut.jpg"
    with open(jpg, "rb") as f:
        cut.write_bytes(f.read()[:-40])
    with pytest.raises(native.DecodeError, match=r"cut\.jpg.*truncated"):
        dataset.decode_image(str(cut))
    truncated = tmp_path / "t.png"
    write_png(str(truncated), [bytes(12)] * 4, 4, 4, 8, 2)
    data = truncated.read_bytes()
    body = zlib.compress(zlib.decompress(data[41:-12 - 4])[:10])
    truncated.write_bytes(data[:33] + _chunk(b"IDAT", body) + _chunk(b"IEND", b""))
    with pytest.raises(native.DecodeError, match=r"t\.png.*truncated"):
        dataset.decode_image(str(truncated))


def test_the_five_entry_points_build_and_run_without_codecs(monkeypatch, tmp_path):
    """The card's machine builds the library with ``-DDTP_NO_CODECS``: the five per-image
    entry points (and the folder sources' resize + normalise) are there, and give the same
    bytes as a build with codecs."""
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, size=(37, 53, 3)).astype(np.uint8)
    png = str(tmp_path / "a.png")
    write_png(png, _pack(rng.randint(0, 256, size=(9, 21)), 8), 7, 9, 8, 2)

    def run():
        return [native.box_blur(img, 5), native.median_blur(img, 3), native.clahe(img, 4.0, 8),
                native.jpeg_roundtrip(img, 85), dataset.decode_image(png),
                native.resize_normalize(img, 16, 24, T.IMAGENET_MEAN, T.IMAGENET_STD)]

    with_codecs = run()
    monkeypatch.setattr(native, "_codecs_installed", lambda workdir: False)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "lib" / "libdtp_native.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available(), native.build_error()
    assert not native.codecs_available()
    for got, want in zip(run(), with_codecs, strict=True):
        np.testing.assert_array_equal(got, want)


def test_entry_points_refuse_bad_arguments():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="refused"):
        native.median_blur(img, 7)
    with pytest.raises(ValueError, match="refused"):
        native.box_blur(img, 4)
    with pytest.raises(ValueError, match="refused"):
        native.jpeg_roundtrip(img, 0)
    with pytest.raises(ValueError, match="3 channels"):
        native.clahe(np.zeros((8, 8, 1), np.uint8))
    with pytest.raises(ValueError, match="bit depth 16 with color type 3"):
        native.png_unfilter(bytes(40), 2, 2, 16, 3)
