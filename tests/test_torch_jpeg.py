"""The port's JPEG decoder and encoder (``csrc/dtp_native.cpp`` through ``data/native.py``)
and its EXIF orientation (``data/jpeg.py``), held against OpenCV on the CPU.

The card's machine has no OpenCV and no libjpeg, so the port decodes JPEG with its own
decoder, in both builds of its library (with libpng, and ``-DDTP_NO_CODECS`` as the card
builds it; one codec-free build is shared by the module). The oracle is ``cv2`` here
(OpenCV 5.0 with libjpeg-turbo 3.1.2, whose SIMD islow IDCT saturates the range limit).

Tolerances:

* the decoder byte-equal to ``cv2.imdecode(..., IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION)
  [..., ::-1]`` over files ``cv2.imencode`` writes from seeded noise and smooth images:
  every square size 1-19 and odd non-square ones, qualities 1-100, samplings 4:4:4, 4:2:2,
  4:4:0, 4:1:1, 4:2:0 and grey, progressive, restart intervals and optimised tables;
* F8: ``dataset.decode_image`` and ``records.decode_image_bytes`` byte-equal to
  ``cv2.imread`` / ``cv2.imdecode`` with ``IMREAD_COLOR`` for every EXIF orientation in
  both byte orders and for broken EXIF data; the native batch routes unrotated;
* the encoder: ``cv2.imdecode(encode(x, q))`` byte-equal to ``native.jpeg_roundtrip(x, q)``
  at 4:2:0, and the file byte-equal to ``cv2.imencode``'s at 4:2:0, 4:4:4 and grey;
* each refused kind a ``DecodeError`` naming the file and the reason, and seeded
  corruptions of the fixtures an image or a ``DecodeError``, never a crash;
* the fixture set's manifest recomputed with ``cv2`` equal to the committed one.
"""

import hashlib
import json
import os
import struct

import numpy as np
import pytest

from distributed_training_pytorch_tpu_torch.data import NativeImageFolderSource, NativeRecordTrainSource, native
from distributed_training_pytorch_tpu_torch.data import dataset, jpeg, records, transforms

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
IGNORE = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
}
SIZES = [(s, s) for s in range(1, 20)] + [(17, 1), (1, 23), (2, 1), (3, 40), (40, 3), (333, 500), (257, 129)]
QUALITIES = [1, 10, 50, 75, 90, 95, 100]


@pytest.fixture(scope="module")
def codec_free_library(tmp_path_factory):
    """The native library as the card's machine builds it (without libpng), built once for
    the module."""
    library = tmp_path_factory.mktemp("codec_free") / "libdtp_native.so"
    patch = pytest.MonkeyPatch()
    try:
        patch.setattr(native, "_codecs_installed", lambda workdir: False)
        patch.setattr(native, "LIBRARY", library)
        native._build()
    finally:
        patch.undo()
    return library


@pytest.fixture(params=["codecs", "codec_free"])
def build(request, monkeypatch):
    """Each test on both builds of the library."""
    if request.param == "codec_free":
        monkeypatch.setattr(native, "LIBRARY", request.getfixturevalue("codec_free_library"))
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_error", None)
    assert native.available(), native.build_error()
    assert native.codecs_available() == (request.param == "codecs")
    return request.param


def _image(h, w, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 5 + yy / 7), 128 + 90 * np.cos(yy / 4), 60 + xx * 190 / w], -1)
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


def _encode(img, quality, sampling="420", **opts):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    for key, value in opts.items():
        params += [getattr(cv2, f"IMWRITE_JPEG_{key.upper()}"), value]
    ok, data = cv2.imencode(".jpg", img, params)
    assert ok
    return data.tobytes()


def _assert_decodes_as_cv2(data, tag):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), IGNORE)[..., ::-1]
    got = native.jpeg_decode(data, str(tag))
    assert got.shape == want.shape and np.array_equal(got, want), tag


def test_decoder_is_byte_equal_to_cv2_at_every_size_and_sampling(build):
    """Every square size 1-19 and odd non-square ones (the edge columns and rows of the
    last block; a 1x1 image; chroma 2 samples wide or less), at every sampling and grey."""
    for i, (h, w) in enumerate(SIZES):
        for kind in ("noise", "smooth"):
            img = _image(h, w, i, kind)
            for sampling in SAMPLING:
                _assert_decodes_as_cv2(_encode(img, 75, sampling), (h, w, kind, sampling))
            _assert_decodes_as_cv2(_encode(img[..., 0], 75), (h, w, kind, "grey"))


def test_decoder_is_byte_equal_to_cv2_at_every_quality(build):
    """Qualities 1-100 on noise (quality 100 reaches the range limit) and smooth images."""
    for h, w in [(13, 17), (37, 53)]:
        for kind in ("noise", "smooth"):
            img = _image(h, w, h, kind)
            for quality in QUALITIES:
                for sampling in SAMPLING:
                    _assert_decodes_as_cv2(_encode(img, quality, sampling), (h, w, kind, quality, sampling))
                _assert_decodes_as_cv2(_encode(img[..., 0], quality), (h, w, kind, quality, "grey"))


@pytest.mark.parametrize("mode", ["progressive", "restart", "optimize"])
def test_decoder_is_byte_equal_to_cv2_on_progressive_restart_and_optimized_files(build, mode):
    """Progressive files (DC first and refine, AC first with EOB runs, AC refine with its
    correction bits) at several qualities, restart intervals of 1 and 3 MCUs (with and
    without progression), and optimised Huffman tables."""
    opts = {"progressive": [{"progressive": 1}, {"progressive": 1, "rst_interval": 2}],
            "restart": [{"rst_interval": 1}, {"rst_interval": 3}],
            "optimize": [{"optimize": 1}, {"optimize": 1, "progressive": 1}]}[mode]
    for i, (h, w) in enumerate([(1, 1), (7, 9), (16, 16), (17, 33), (19, 2), (64, 48)]):
        for kind in ("noise", "smooth"):
            img = _image(h, w, 100 + i, kind)
            for quality in (10, 50, 75, 95, 100):
                for extra in opts:
                    for sampling in ("420", "422", "444"):
                        _assert_decodes_as_cv2(_encode(img, quality, sampling, **extra), (h, w, quality, sampling, extra))
                    _assert_decodes_as_cv2(_encode(img[..., 0], quality, **extra), (h, w, quality, "grey", extra))


def _oriented(img, orientation):
    """What ``cv2.imdecode`` gives for an EXIF orientation (``ApplyExifOrientation``)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: 1, 3: -1, 4: 0, 6: 1, 7: -1, 8: 0}.get(orientation)
    return img if flip is None else cv2.flip(np.ascontiguousarray(img), flip)


@pytest.mark.parametrize("order", [b"II", b"MM"])
def test_exif_orientation_follows_cv2_and_the_native_routes_ignore_it(tmp_path, order):
    """F8: the port's decoder applied no EXIF orientation where ``cv2.imread`` and
    ``cv2.imdecode`` (the JAX package's folder and record routes) apply it. Every value
    1-8 (and 0 and 9, which are ignored), in both byte orders; the native batch routes stay
    unrotated, as the JAX native routes (libjpeg, no orientation) give them."""
    base = _encode(_image(37, 53, 1, "smooth"), 90)
    plain = cv2.imdecode(np.frombuffer(base, np.uint8), IGNORE)
    for orientation in range(10):
        data = jpeg.with_orientation(base, orientation, order)
        path = tmp_path / f"o{orientation}.jpg"
        path.write_bytes(data)
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        assert np.array_equal(want, _oriented(plain, orientation)), orientation  # the oracle's own mapping
        np.testing.assert_array_equal(dataset.decode_image(str(path)), want[..., ::-1], err_msg=str(orientation))
        np.testing.assert_array_equal(records.decode_image_bytes(data), cv2.imdecode(np.frombuffer(data, np.uint8),
                                                                                     cv2.IMREAD_COLOR)[..., ::-1])
    # the native routes: a folder of the eight files and their record shards, at the images' own size
    root = tmp_path / "folder"
    (root / "x").mkdir(parents=True)
    for orientation in range(1, 9):
        (root / "x" / f"{orientation}.jpg").write_bytes(jpeg.with_orientation(base, orientation, order))
    folder = NativeImageFolderSource(str(root), ["x"], 37, 53, mean=np.zeros(3), std=np.ones(3))
    batch = folder.load_batch(np.arange(8), 0)["image"]
    assert np.array_equal(batch, np.repeat(plain[None, ..., ::-1] / np.float32(255), 8, 0))
    shards = records.pack_image_folder(str(root), ["x"], str(tmp_path / "rec" / "train"), num_shards=2)
    source = NativeRecordTrainSource(os.path.dirname(shards[0]), 37, 53, train=False)
    assert np.array_equal(source.load_batch(np.arange(8), 0)["image"], np.repeat(plain[None, ..., ::-1], 8, 0))


def _exif_variants(base):
    """Broken or unusual EXIF data beside a good segment, as ``(name, file bytes)``."""
    le = lambda fmt, *a: struct.pack("<" + fmt, *a)  # noqa: E731
    good = jpeg.exif_segment(6)[10:]  # the TIFF data

    def app1(body, magic=b"Exif\x00\x00"):
        return b"\xff\xe1" + struct.pack(">H", len(body) + len(magic) + 2) + magic + body

    def splice(*segments):
        return base[:2] + b"".join(segments) + base[2:]

    def ifd(entries, count=None):
        body = b"II" + le("HIH", 42, 8, len(entries) if count is None else count)
        return body + b"".join(le("HHIHH", tag, kind, 1, value, 0) for tag, kind, value in entries) + le("I", 0)

    xmp = b"http://ns.adobe.com/xap/1.0/\x00<x/>"
    dht = base.index(b"\xff\xc4")  # the Huffman tables follow the frame header
    return [
        ("cut in the value", splice(app1(good[:19]))),
        ("cut after the value", splice(app1(good[:20]))),
        ("bad TIFF magic", splice(app1(b"II" + le("H", 43) + good[4:]))),
        ("IFD offset past the end", splice(app1(b"II" + le("HI", 42, 1000) + good[8:]))),
        ("an APP1 that is not Exif", splice(app1(good, magic=b"Abcd\x00\x00"))),
        ("XMP before Exif", splice(b"\xff\xe1" + struct.pack(">H", len(xmp) + 2) + xmp, app1(good))),
        ("two Exif segments", splice(app1(good), jpeg.exif_segment(3))),
        ("another tag first", splice(app1(ifd([(0x010F, 2, 5), (0x0112, 3, 8)])))),
        ("LONG type", splice(app1(ifd([(0x0112, 4, 5)])))),
        ("count past the end", splice(app1(ifd([(0x0112, 3, 7)], count=9)))),
        ("two orientation entries", splice(app1(ifd([(0x0112, 3, 2), (0x0112, 3, 4)])))),
        ("byte order XX read big-endian", splice(app1(b"XX" + jpeg.exif_segment(6, b"MM")[12:]))),
        ("after the frame header", base[:dht] + jpeg.exif_segment(6) + base[dht:]),
        ("after the scan", base[:-2] + jpeg.exif_segment(6) + base[-2:]),
    ]


def test_broken_exif_data_is_read_as_cv2_reads_it():
    """A truncated or malformed segment leaves the image as it is, as in OpenCV; what
    OpenCV still reads (a value before the cut, another byte order) is read alike."""
    base = _encode(_image(21, 34, 2, "smooth"), 85)
    for name, data in _exif_variants(base):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(records.decode_image_bytes(data), want, err_msg=name)


def test_encoder_round_trips_as_cv2_and_writes_cv2s_bytes(build):
    """At 4:2:0, ``cv2.imdecode(encode(x, q))`` equals ``native.jpeg_roundtrip(x, q)``; at
    4:2:0, 4:4:4 and grey, with and without restart intervals, the file is
    ``cv2.imencode``'s, byte for byte, and the port's decoder reads it back."""
    for i, (h, w) in enumerate([(1, 1), (7, 9), (16, 16), (17, 33), (37, 53), (120, 90)]):
        for kind in ("noise", "smooth"):
            img = _image(h, w, 200 + i, kind)
            for quality in (1, 25, 75, 90, 100):
                data = native.jpeg_encode(img, quality)
                decoded = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
                assert np.array_equal(decoded, native.jpeg_roundtrip(img, quality)), (h, w, kind, quality)
                assert np.array_equal(native.jpeg_decode(data), decoded)
                for sampling, rst in (("420", 0), ("420", 2), ("444", 0), ("444", 1), ("grey", 0), ("grey", 3)):
                    x = img[..., 0] if sampling == "grey" else img
                    mine = native.jpeg_encode(x, quality, subsampling="4:4:4" if sampling == "444" else "4:2:0",
                                              restart_interval=rst)
                    bgr = x if sampling == "grey" else x[..., ::-1]
                    theirs = _encode(bgr, quality, "444" if sampling == "444" else "420", rst_interval=rst)
                    assert mine == theirs, (h, w, kind, quality, sampling, rst)
    with pytest.raises(ValueError, match="refused"):
        native.jpeg_encode(np.zeros((4, 4, 3), np.uint8), 0)


def _sof(data):
    for marker in (b"\xff\xc0", b"\xff\xc2"):
        if marker in data:
            return data.index(marker)
    raise AssertionError("no frame header")


def _refused():
    """Files the decoder refuses, each with the reason it must name."""
    base = _encode(_image(24, 40, 3, "smooth"), 80)
    prog = _encode(_image(24, 40, 4, "noise"), 80, progressive=1)
    sof = _sof(base)

    def patched(offset, value, data=base):
        return data[:offset] + bytes(value) + data[offset + len(value):]

    scans = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    cases = {
        "arithmetic": (patched(sof + 1, [0xC9]), "arithmetic"),
        "lossless": (patched(sof + 1, [0xC3]), "lossless"),
        "hierarchical": (patched(sof + 1, [0xC5]), "hierarchical"),
        "12-bit": (patched(sof + 4, [12]), "8-bit precision"),
        "cmyk": (base[:sof] + b"\xff\xc0\x00\x14\x08\x00\x18\x00\x28\x04" + b"\x01\x11\x00\x02\x11\x01\x03\x11\x01\x04\x11\x01"
                 + base[sof + 2 + 17:], "CMYK"),
        "dnl height": (patched(sof + 5, [0, 0]), "DNL"),
        "too large": (patched(sof + 5, [0xFF, 0xDC, 0xFF, 0xDC]), "2\\^30 pixels"),
        "no image": (base[:sof] + b"\xff\xd9", "without a frame"),
        "incomplete progressive": (prog[:scans[3]] + b"\xff\xd9", "incomplete"),
    }
    for cut in (len(base) // 2, 200, 20, len(base) - 2):
        cases[f"cut at {cut}"] = (base[:cut], "truncated")
    for cut in (len(prog) // 2, scans[2] + 4):
        cases[f"progressive cut at {cut}"] = (prog[:cut], "truncated")
    return cases


def test_refused_files_raise_a_decode_error_naming_the_file(tmp_path, build):
    """Arithmetic, lossless, hierarchical, 12-bit, CMYK, DNL-defined height, more than 2^30
    pixels (refused from the header, before any allocation), an incomplete progressive file
    (which libjpeg would smooth) and cuts anywhere: a ``DecodeError`` naming the file and
    the reason, from ``decode_image`` and from a record source. ``cv2`` gives no image for
    a cut file either (the JAX routes raise a ``ValueError``)."""
    for name, (data, reason) in _refused().items():
        path = tmp_path / f"{name.replace(' ', '_')}.jpg"
        path.write_bytes(data)
        if "cut" in name:
            assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None, name
        with pytest.raises(native.DecodeError, match=rf"{path.name}.*{reason}"):
            dataset.decode_image(str(path))
        with pytest.raises(native.DecodeError, match=rf"record 0 \(.*\).*{reason}"):
            records.RecordFileSource(str(_one_shard(tmp_path, name, data)))[0]
    with pytest.raises(native.DecodeError, match="no start-of-image"):
        native.jpeg_decode(b"\xff\xd9\xff\xd8")


def _one_shard(tmp_path, name, data):
    shard = tmp_path / "shards" / f"{name.replace(' ', '_')}-00000-of-00001.rec"
    shard.parent.mkdir(exist_ok=True)
    with records.RecordFileWriter(str(shard)) as w:
        w.append(data, 0)
    return shard


def test_a_refused_payload_in_a_batch_names_the_record_and_the_reason(tmp_path, build):
    base = _encode(_image(24, 40, 5, "smooth"), 80)
    shards = records.write_shards(str(tmp_path / "train"), [(base, 0), (base[:100], 1), (base, 2)], num_shards=1)
    source = NativeRecordTrainSource(shards[0], 16, 16, train=False)
    with pytest.raises(records.CorruptRecordError, match=r"record 1 \(.*#1\).*truncated"):
        source.load_batch(np.arange(3), 0)
    source.skip_corrupt = True
    batch = source.load_batch(np.arange(3), 0)
    assert source.corrupt_skipped == 1 and batch["label"].tolist() == [0, 2, 2]


def test_the_fixture_manifest_is_what_cv2_decodes_and_what_the_port_decodes(build):
    """The committed files under ``tests/data/jpeg/`` (``scripts/make_jpeg_fixtures.py``)
    still hash, through ``cv2``, to the committed manifest, and through the port's decoder
    to the same hashes (``chip_smoke.py``'s ``jpeg`` phase holds the card's build to them)."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".jpg"))
    assert names == sorted(manifest) and len(names) >= 12
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES)) < 100_000
    for name in names:
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        entry = manifest[name]
        plain = cv2.imdecode(np.frombuffer(data, np.uint8), IGNORE)[..., ::-1]
        turned = np.ascontiguousarray(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
        assert [list(plain.shape), hashlib.sha256(plain.tobytes()).hexdigest()] == [entry["shape"], entry["sha256"]]
        assert hashlib.sha256(turned.tobytes()).hexdigest() == entry["sha256_oriented"], name
        assert hashlib.sha256(native.jpeg_decode(data).tobytes()).hexdigest() == entry["sha256"], name
        assert hashlib.sha256(dataset.decode_image(path).tobytes()).hexdigest() == entry["sha256_oriented"], name


def test_fused_entries_decode_jpeg_in_both_builds(build):
    """The fused batch entries take JPEG payloads in both builds, as the decoder alone
    gives them (then resized, normalised or cropped as any payload)."""
    payloads = [_encode(_image(h, w, h, "smooth"), 90, s) for (h, w), s in [((30, 40), "420"), ((41, 27), "444"),
                                                                             ((33, 33), "411")]]
    for p in payloads:
        h, w = native.jpeg_header(p)
        assert np.array_equal(native.decode_resize_u8_bytes([p], h, w)[0], native.jpeg_decode(p))
    decoded = [native.jpeg_decode(p) for p in payloads]
    idx = np.array([4, 9, 2])
    assert np.array_equal(native.decode_rrc_flip_u8_bytes(payloads, 24, 24, idx, seed=1, epoch=3),
                          native.rrc_flip_u8_batch(decoded, 24, 24, idx, seed=1, epoch=3))
    mean, std = transforms.IMAGENET_MEAN, transforms.IMAGENET_STD
    want = np.stack([native.resize_normalize(d, 20, 24, mean, std) for d in decoded])
    assert np.array_equal(native.decode_resize_normalize_bytes(payloads, 20, 24, mean, std), want)


def test_mutated_files_decode_or_raise_a_decode_error(build):
    """Seeded corruptions of every fixture (bit flips, overwritten, inserted and cut bytes)
    either decode to an image of the header's shape or raise a ``DecodeError``: the
    decoder runs on loader threads, where a crash would take the process down. Headers of
    more than 2^22 pixels are only queried, not decoded."""
    rng = np.random.default_rng(12)
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".jpg"))
    decoded = refused = 0
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            base = np.frombuffer(f.read(), np.uint8)
        for _ in range(150):
            data = base.copy()
            kind = rng.integers(4)
            for pos in rng.integers(0, len(data), rng.integers(1, 9)):
                if kind == 0:
                    data[pos] ^= np.uint8(1 << rng.integers(8))
                elif kind == 1:
                    data[pos] = rng.integers(256)
                elif kind == 2:
                    data = data[: max(2, min(pos, len(data)))]
                else:
                    data = np.insert(data, min(pos, len(data)), rng.integers(256))
            payload = data.tobytes()
            try:
                h, w = native.jpeg_header(payload)
                if h * w > 1 << 22:
                    refused += 1
                    continue
                image = native.jpeg_decode(payload)
            except native.DecodeError:
                refused += 1
                continue
            assert image.shape == (h, w, 3)
            decoded += 1
    assert decoded and refused
