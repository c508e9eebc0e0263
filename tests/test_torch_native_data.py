"""The port's host data runtime (``distributed_training_pytorch_tpu_torch/data/native.py``
over its own ``csrc/dtp_native.cpp``) held against the JAX package's
(``distributed_training_pytorch_tpu/data/native.py`` over ``csrc/dtp_native.cpp``).

The JAX package's ``data/`` package does not import in this tree (its ``data/streaming/``
was never committed), so its library runs in a subprocess that first installs a stand-in
``data.streaming`` module whose names raise when used, as ``tests/test_torch_trainer_lm.py``
does. That subprocess builds the JAX library with ``make`` under a file lock, so that test
processes running at once do not write it together.

Tolerance: every output bit-equal (the same C++ on the same inputs; the Philox key is
``(seed, epoch << 40 | index)`` on both sides).
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from distributed_training_pytorch_tpu_torch.data import ArrayDataSource, ShardedLoader, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = [0.4914, 0.4822, 0.4465]
STD = [0.2470, 0.2435, 0.2616]
# name, seed, epoch, pad, hflip, indices
AUGMENT_CASES = [
    ("a", 0, 0, 4, True, list(range(12))),
    ("b", 7, 3, 4, True, [5, 2**39 + 3, 11, 0, 1023, 7, 8, 9, 10, 4, 6, 2]),
    ("c", 1, 1, 2, False, list(range(100, 112))),
    ("d", 5, 2, 0, True, list(range(12))),
]

JAX_SIDE = textwrap.dedent(
    """
    import fcntl, json, os, sys, types
    import numpy as np

    stub = types.ModuleType("distributed_training_pytorch_tpu.data.streaming")
    def _unavailable(*a, **k):
        raise RuntimeError("data/streaming is not in this tree")
    for name in ("DecodePool", "ReaderState", "StreamingLoader", "shard_array_source"):
        setattr(stub, name, _unavailable)
    sys.modules[stub.__name__] = stub

    from distributed_training_pytorch_tpu.data import native
    os.makedirs("build", exist_ok=True)
    with open("build/.jax_native_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one make at a time across test processes
        assert native.available(), "the JAX package's native library did not build"

    out, cases, mean, std = sys.argv[1], json.loads(sys.argv[2]), *map(json.loads, sys.argv[3:5])
    mean, std = np.float32(mean), np.float32(std)
    images = np.random.RandomState(3).randint(0, 256, size=(12, 32, 24, 3)).astype(np.uint8)
    res = {}
    for name, seed, epoch, pad, hflip, indices in cases:
        idx = np.asarray(indices, np.int64)
        res[f"u8/{name}"] = native.augment_crop_flip_u8(images, idx, pad=pad, seed=seed, epoch=epoch, hflip=hflip)
        res[f"f32/{name}"] = native.augment_crop_flip(images, idx, pad=pad, seed=seed, epoch=epoch, mean=mean,
                                                      std=std, hflip=hflip)
        res[f"cls_u8/{name}"] = native.NativeCropFlipU8(pad=pad, seed=seed).batch_apply(images, idx, epoch)
        res[f"cls_f32/{name}"] = native.NativeCropFlipNormalize(mean, std, pad=pad, seed=seed).batch_apply(
            images, idx, epoch)
    res["normalize"] = native.normalize(images, mean, std)
    res["eval_u8"] = native.NativeCropFlipU8(train=False).batch_apply(images, np.arange(12), 0)
    res["eval_f32"] = native.NativeCropFlipNormalize(mean, std, train=False).batch_apply(images, np.arange(12), 0)

    import cv2
    payloads = [cv2.imencode(".png", images[0])[1].tobytes(), cv2.imencode(".jpg", images[1])[1].tobytes(),
                cv2.imencode(".png", np.ascontiguousarray(images[2][:20, :17]))[1].tobytes()]
    paths = []
    for i, p in enumerate(payloads):
        paths.append(os.path.join(os.path.dirname(out), f"img{i}" + (".jpg" if i == 1 else ".png")))
        with open(paths[-1], "wb") as f:
            f.write(p)
    res["decode_u8"] = native.decode_resize_u8_bytes(payloads, 28, 20)
    res["decode_f32"] = native.decode_resize_normalize_bytes(payloads, 28, 20, mean, std)
    res["decode_rrc"] = native.decode_rrc_flip_u8_bytes(payloads, 16, 16, np.array([3, 2**38, 9]), seed=4, epoch=2)
    res["decode_paths"] = native.decode_resize_normalize(paths, 30, 30, mean, std)
    np.savez(out, images=images, **{k.replace("/", "__"): v for k, v in res.items()})
    with open(out + ".json", "w") as f:
        json.dump({"paths": paths, "payloads": [p.hex() for p in payloads]}, f)
    """
)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    pytest.importorskip("cv2")
    out = str(tmp_path_factory.mktemp("jax_native") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, out, json.dumps(AUGMENT_CASES), json.dumps(MEAN), json.dumps(STD)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out + ".json") as f:
        meta = json.load(f)
    ref = dict(np.load(out))
    return ref, meta


def test_the_library_builds_here():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native.codecs_available()
    assert native.LIBRARY.is_file() and native.LIBRARY.parent.name == "torch_native"


@pytest.mark.parametrize("case", AUGMENT_CASES, ids=[c[0] for c in AUGMENT_CASES])
def test_augmenters_are_bit_equal_to_the_jax_library(jax_side, case):
    ref, _ = jax_side
    name, seed, epoch, pad, hflip, indices = case
    images, idx = ref["images"], np.asarray(indices, np.int64)
    mean, std = np.float32(MEAN), np.float32(STD)
    got = {
        "u8": native.augment_crop_flip_u8(images, idx, pad=pad, seed=seed, epoch=epoch, hflip=hflip),
        "f32": native.augment_crop_flip(images, idx, pad=pad, seed=seed, epoch=epoch, mean=mean, std=std,
                                        hflip=hflip),
        "cls_u8": native.NativeCropFlipU8(pad=pad, seed=seed).batch_apply(images, idx, epoch),
        "cls_f32": native.NativeCropFlipNormalize(mean, std, pad=pad, seed=seed).batch_apply(images, idx, epoch),
    }
    for kind, value in got.items():
        want = ref[f"{kind}__{name}"]
        assert value.dtype == want.dtype and value.shape == want.shape, kind
        assert np.array_equal(value, want), kind
    if pad:  # the crops really move pixels
        assert not np.array_equal(got["u8"], images)
    # one record through the per-record protocol is that record's row of the batch call
    row = native.NativeCropFlipU8(pad=pad, seed=seed)(images[4], epoch=epoch, index=int(idx[4]))
    assert np.array_equal(row, got["u8"][4])


def test_normalize_and_eval_paths_are_bit_equal_to_the_jax_library(jax_side):
    ref, _ = jax_side
    images = ref["images"]
    mean, std = np.float32(MEAN), np.float32(STD)
    assert np.array_equal(native.normalize(images, mean, std), ref["normalize"])
    assert np.array_equal(native.NativeCropFlipU8(train=False).batch_apply(images, np.arange(12), 0), ref["eval_u8"])
    got = native.NativeCropFlipNormalize(mean, std, train=False).batch_apply(images, np.arange(12), 0)
    assert np.array_equal(got, ref["eval_f32"])


def test_decoders_are_bit_equal_to_the_jax_library(jax_side):
    ref, meta = jax_side
    payloads = [bytes.fromhex(p) for p in meta["payloads"]]
    mean, std = np.float32(MEAN), np.float32(STD)
    assert np.array_equal(native.decode_resize_u8_bytes(payloads, 28, 20), ref["decode_u8"])
    assert np.array_equal(native.decode_resize_normalize_bytes(payloads, 28, 20, mean, std), ref["decode_f32"])
    got = native.decode_rrc_flip_u8_bytes(payloads, 16, 16, np.array([3, 2**38, 9]), seed=4, epoch=2)
    assert np.array_equal(got, ref["decode_rrc"])
    assert np.array_equal(native.decode_resize_normalize(meta["paths"], 30, 30, mean, std), ref["decode_paths"])
    with pytest.raises(native.DecodeError) as err:
        native.decode_resize_u8_bytes([payloads[0], b"not an image"], 8, 8)
    assert err.value.index == 1


@pytest.mark.parametrize("num_workers", [0, 8])
def test_native_crop_flip_through_the_loader_equals_a_direct_call(num_workers):
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, size=(70, 32, 32, 3)).astype(np.uint8)
    labels = np.arange(70, dtype=np.int32)
    source = ArrayDataSource(transform=native.NativeCropFlipU8(pad=4, seed=3), image=images, label=labels)
    loader = ShardedLoader(source, 16, seed=3, num_workers=num_workers, process_index=1, process_count=2)
    assert loader._batch_fast_path() == "arrays"
    loader.set_epoch(2)
    batches = list(loader)
    assert len(batches) == 4
    for batch in batches:
        rows = batch["label"].astype(np.int64)
        direct = native.augment_crop_flip_u8(images[rows], rows, pad=4, seed=3, epoch=2)
        assert batch["image"].dtype == np.uint8 and np.array_equal(batch["image"], direct)


@pytest.mark.parametrize("fault", ["missing", "syntax"])
def test_build_error_reports_a_broken_build(monkeypatch, tmp_path, fault):
    source = tmp_path / "dtp_native.cpp"
    if fault == "syntax":
        source.write_text('extern "C" int dtp_normalize( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", source)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "lib" / "libdtp_native.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    message = native.build_error()
    assert message and "dtp_native.cpp" in message
    assert ("No such file" in message) if fault == "missing" else ("error" in message)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.normalize(np.zeros((1, 4, 4, 3), np.uint8), np.zeros(3), np.ones(3))


def test_a_build_without_codecs_augments_the_same_and_decodes_jpeg_but_not_png(monkeypatch, tmp_path):
    """The card's machine has no libpng: there the library is built with
    ``-DDTP_NO_CODECS``, and its crop/flip must still be the same bytes. Its decode entries
    take a JPEG (the library's own decoder, in both builds) and refuse a PNG, naming the
    missing libpng and its position in the batch."""
    cv2 = pytest.importorskip("cv2")
    images = np.random.RandomState(1).randint(0, 256, size=(6, 32, 32, 3)).astype(np.uint8)
    with_codecs = native.augment_crop_flip_u8(images, np.arange(6), pad=4, seed=2, epoch=1)
    monkeypatch.setattr(native, "_codecs_installed", lambda workdir: False)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "libdtp_native.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available(), native.build_error()
    assert not native.codecs_available()
    assert np.array_equal(native.augment_crop_flip_u8(images, np.arange(6), pad=4, seed=2, epoch=1), with_codecs)
    jpeg = cv2.imencode(".jpg", images[0])[1].tobytes()
    decoded = native.decode_resize_u8_bytes([jpeg], 32, 32)  # at its own size: no resampling
    assert np.array_equal(decoded[0], cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
    png = cv2.imencode(".png", images[0])[1].tobytes()
    with pytest.raises(native.DecodeError, match="#1: a PNG payload, and the library was built without libpng"):
        native.decode_resize_u8_bytes([jpeg, png], 8, 8)


def test_concurrent_first_calls_load_one_library(monkeypatch, tmp_path):
    """Loader workers may make the first call together: one build, one library."""
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "libdtp_native.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    seen = []
    threads = [threading.Thread(target=lambda: seen.append(native._load())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(seen) == 4 and seen[0] is not None and all(lib is seen[0] for lib in seen)


def test_a_library_that_will_not_load_is_rebuilt_here(monkeypatch, tmp_path):
    """A library built on another machine (against a libjpeg this one lacks) fails to
    load: it is rebuilt from the source, not reported as the build's failure."""
    library = tmp_path / "libdtp_native.so"
    library.write_bytes(b"not a shared object")
    monkeypatch.setattr(native, "LIBRARY", library)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    os.utime(library, (native.SOURCE.stat().st_mtime + 10,) * 2)  # newer than the source
    assert native.available(), native.build_error()
    assert library.read_bytes()[:4] == b"\x7fELF"


def test_sizes_are_checked_before_the_pointers_are_passed():
    images = np.zeros((4, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="expected 4 indices"):
        native.augment_crop_flip_u8(images, np.arange(3), pad=2, seed=0, epoch=0)
    with pytest.raises(ValueError, match="expected 3 channel means"):
        native.normalize(images, np.zeros(2), np.ones(3))
    with pytest.raises(ValueError, match="3 channels"):
        native.augment_crop_flip_u8(np.zeros((4, 8, 8, 1), np.uint8), np.arange(4), pad=2, seed=0, epoch=0)
