"""The port's record files (``distributed_training_pytorch_tpu_torch/data/records.py``),
its loader's ``skip_corrupt``/``load_delay_s``, the records entry (``examples/
train_records.py``) and the ImageNet entry's ``IMAGENET_RECORDS``/``VAL_RECORDS`` path,
held against the JAX package's (``data/records.py``, ``examples/train_records.py``,
``examples/train_imagenet.py``) on the CPU.

The JAX side runs once for the module, in a subprocess with a stand-in
``data.streaming`` module (as ``tests/test_torch_image_folder.py`` runs it), over trees
and shards this module writes first: an image folder of PNG (OpenCV's encoder), JPEG and
BMP files of several sizes, the shards the port packs from it, a copy with one PNG
payload's bytes after its signature overwritten by garbage, and a small digits tree.

Tolerances:

* shard files byte-equal; the record sources' batches bit-equal to the JAX sources'
  native path (the same C++ on the same decoded pixels; the decoders are byte-equal to
  OpenCV's); a BMP payload, which the JAX package resizes with OpenCV, within 1 level;
* the codec-free route (a build without libpng, the card's machine) bit-equal to the fused
  entries for PNG payloads, and its JPEG payloads (the port's own decoder, in both builds)
  bit-equal to the JAX sources';
* the records entry (ResNet18Slim, f32, 2 epochs of 3 steps on 60 digits, validation on 30)
  per-epoch train and val CE within 1e-4 and accuracies equal; the ImageNet entry on
  record shards (``resnet50`` recipe on ResNet18Slim, 32x32, rrc) within 1e-5 and equal,
  as its synthetic path is held.
"""

import glob
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from distributed_training_pytorch_tpu_torch.data import (
    ArrayDataSource,
    CorruptRecordError,
    NativeRecordFileSource,
    NativeRecordTrainSource,
    RecordFileSource,
    ShardedLoader,
    native,
    pack_image_folder,
)
from distributed_training_pytorch_tpu_torch.data.png import rgb_png
from distributed_training_pytorch_tpu_torch.data import transforms
from distributed_training_pytorch_tpu_torch.data.transforms import Compose, resize
from distributed_training_pytorch_tpu_torch.examples import digits_data, train_imagenet, train_records
from distributed_training_pytorch_tpu_torch.models import resnet_params_from_jax

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ["a", "b", "c"]
COUNTS = {"train": 8, "val": 3}
SIZES = [(40, 30), (37, 52), (32, 32), (45, 45)]
ROWS = [5, 0, 23, 11, 2, 17, 2, 9, 8, 21]  # a repeated row, as a padded batch has; 8 and 21 are JPEG
DIGITS_COUNTS = {"train": 6, "test": 3}  # per label
DIGITS_BATCH, INET_BATCH, EPOCHS = 16, 8, 2

_JAX_SIDE = textwrap.dedent(
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
    from distributed_training_pytorch_tpu.data import records as R

    out, folder, port_shards, corrupt, digits_records = sys.argv[1:6]
    rows = np.asarray(json.loads(sys.argv[6]), np.int64)
    res, meta = {}, {}
    meta["shards"] = R.pack_image_folder(os.path.join(folder, "train"), ["a", "b", "c"],
                                         os.path.join(os.path.dirname(out), "jax_shards", "train"), num_shards=3)
    pattern = os.path.join(port_shards, "train-*.rec")
    src = R.RecordFileSource(pattern)
    for i in range(len(src)):
        res[f"record_{i}"] = src[i]["image"]
    res["labels"] = np.asarray([src[i]["label"] for i in range(len(src))])
    res["val"] = R.NativeRecordFileSource(pattern, 20, 24).load_batch(rows, 0)["image"]
    res["pad_crop"] = R.NativeRecordTrainSource(pattern, 24, 24, seed=3).load_batch(rows, 2)["image"]
    res["no_aug"] = R.NativeRecordTrainSource(pattern, 24, 20, train=False).load_batch(rows, 2)["image"]
    res["rrc"] = R.NativeRecordTrainSource(pattern, 16, 16, aug="rrc", seed=5).load_batch(rows, 1)["image"]
    bad = R.NativeRecordTrainSource(os.path.join(corrupt, "train-*.rec"), 24, 24, seed=3)
    bad.skip_corrupt = True
    b = bad.load_batch(rows, 2)
    res["skip_images"], res["skip_labels"], meta["skipped"] = b["image"], b["label"], bad.corrupt_skipped

    import jax.numpy as jnp
    from collections.abc import Mapping
    import examples.train_imagenet as inet
    import examples.train_records as tr

    def flatten(tree, prefix=""):
        if isinstance(tree, Mapping):
            return {k: v for name, sub in tree.items() for k, v in flatten(sub, f"{prefix}{name}/").items()}
        return {prefix[:-1]: np.asarray(tree)}

    def recorded(base):
        class Recorded(base):
            def train_epoch(self, epoch):
                self.record["train"].append({k: float(v) for k, v in super().train_epoch(epoch).items()})
                return self.record["train"][-1]

            def validate(self):
                self.record["val"].append({k: float(v) for k, v in super().validate().items()})
                return self.record["val"][-1]
        Recorded.record = {"train": [], "val": []}
        return Recorded

    epochs = int(sys.argv[7])
    # validation before every epoch; one save, at the end (the saves are not compared)
    common = dict(max_epoch=epochs, have_validate=True, save_period=1, last_save_period=epochs, progress=False,
                  num_workers=0, async_checkpoint=False)
    Digits = recorded(tr.RecordsDigitsTrainer)
    t = Digits(train_pattern=os.path.join(digits_records, "train-*.rec"),
               val_pattern=os.path.join(digits_records, "test-*.rec"), base_lr=0.1, batch_size=int(sys.argv[8]),
               save_folder=os.path.join(os.path.dirname(out), "jax_records_run"), **common)
    digits_vars = flatten({"params": t.state.params, **t.state.model_state})
    t.train()
    meta["records_run"] = Digits.record

    inet.RECIPES["resnet18_slim"] = dict(inet.RECIPES["resnet50"])
    Inet = recorded(inet.ImageNetTrainer)
    t = Inet(model_name="resnet18_slim", image_size=32, base_lr=0.1, batch_size=int(sys.argv[9]),
             save_folder=os.path.join(os.path.dirname(out), "jax_inet_run"), **common)
    inet_vars = flatten({"params": t.state.params, **t.state.model_state})
    t.train()
    meta["inet_run"] = Inet.record
    np.savez(out, **res, **{f"digits::{k}": v for k, v in digits_vars.items()},
             **{f"inet::{k}": v for k, v in inet_vars.items()})
    with open(out + ".json", "w") as f:
        json.dump(meta, f)
    """
)


def _write_folder(root):
    """``train``/``val`` x 3 labels of class-coloured images of ``SIZES``: PNG through
    OpenCV, and in each label one JPEG and one 24-bit BMP."""
    rng = np.random.RandomState(7)
    for split, n in COUNTS.items():
        for li, label in enumerate(LABELS):
            os.makedirs(os.path.join(root, split, label))
            for i in range(n):
                h, w = SIZES[(i + li) % len(SIZES)]
                base = np.array([60 + 70 * li, 200 - 60 * li, 90 + 30 * li], np.float32)
                img = np.clip(base + rng.randn(h, w, 3) * 30, 0, 255).astype(np.uint8)
                ext = {1: ".jpg", 4: ".bmp"}.get(i, ".png")
                assert cv2.imwrite(os.path.join(root, split, label, f"{i:02d}{ext}"), img)


def _write_digits(root):
    """The first ``DIGITS_COUNTS`` images of each digit of the shipped corpus as a digits
    tree (``digits_data.materialize``'s files and scaling)."""
    images, targets = digits_data.load_digits()
    for split, n in DIGITS_COUNTS.items():
        for d in range(10):
            os.makedirs(os.path.join(root, split, str(d)))
            members = np.flatnonzero(targets == d)
            members = members[:n] if split == "train" else members[-n:]
            for i in members:
                img = np.clip(images[i] * (255.0 / 16.0), 0, 255).astype(np.uint8).repeat(4, 0).repeat(4, 1)
                with open(os.path.join(root, split, str(d), f"{i:04d}.png"), "wb") as f:
                    f.write(rgb_png(np.repeat(img[:, :, None], 3, axis=2)))


def _corrupt_copy(shard_dir, out_dir):
    """A copy of the shards with one PNG payload's bytes after its signature garbled;
    returns that record's index."""
    shutil.copytree(shard_dir, out_dir)
    src = RecordFileSource(os.path.join(out_dir, "train-*.rec"))
    index = next(i for i in ROWS if src.read_record(i)[0][:4] == b"\x89PNG")
    shard, local = src._locate(index)
    offset = int(src._shard_offsets[shard][local]) + 16
    payload, _ = src.read_record(index)
    with open(src.paths[shard], "r+b") as f:
        f.seek(offset + 8)
        f.write(np.random.RandomState(0).randint(0, 256, len(payload) - 8).astype(np.uint8).tobytes())
    return index


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    base = tmp_path_factory.mktemp("records")
    folder, shards = str(base / "folder"), str(base / "port_shards")
    _write_folder(folder)
    paths = pack_image_folder(os.path.join(folder, "train"), LABELS, os.path.join(shards, "train"), num_shards=3)
    pack_image_folder(os.path.join(folder, "val"), LABELS, os.path.join(shards, "val"), num_shards=2)
    corrupt_index = _corrupt_copy(shards, str(base / "corrupt"))
    # the ImageNet entry's rrc: the JAX package crops a BMP payload with other draws (see
    # test_native_sources_are_bit_equal_to_the_jax_native_path), so its shards hold none
    inet = str(base / "inet_shards")
    for split in COUNTS:
        no_bmp = str(base / "no_bmp" / split)
        shutil.copytree(os.path.join(folder, split), no_bmp, ignore=shutil.ignore_patterns("*.bmp"))
        pack_image_folder(no_bmp, LABELS, os.path.join(inet, split), num_shards=2)
    digits = str(base / "digits")
    _write_digits(digits)
    patterns = train_records.pack_digits(digits, os.path.join(digits, "records"))
    out = str(base / "jax" / "ref.npz")
    os.makedirs(os.path.dirname(out))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1",
               DTYPE="fp32", NUM_CLASSES="3", SHIP_UINT8="1",
               IMAGENET_RECORDS=os.path.join(inet, "train-*.rec"), VAL_RECORDS=os.path.join(inet, "val-*.rec"))
    for knob in ("PYTHONPATH", "PALLAS", "MODEL", "ACCUM", "STEPS_PER_EPOCH", "RECORDS_NATIVE", "MESH", "TELEMETRY"):
        env.pop(knob, None)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, out, folder, shards, str(base / "corrupt"), os.path.join(digits, "records"),
         json.dumps(ROWS), str(EPOCHS), str(DIGITS_BATCH), str(INET_BATCH)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out + ".json") as f:
        meta = json.load(f)
    return {"ref": dict(np.load(out)), "meta": meta, "folder": folder, "shards": shards, "paths": paths,
            "corrupt": str(base / "corrupt"), "corrupt_index": corrupt_index, "patterns": patterns, "inet": inet}


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


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


def _use_codec_free(monkeypatch, library):
    monkeypatch.setattr(native, "LIBRARY", library)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available(), native.build_error()
    assert not native.codecs_available()


@pytest.fixture
def codec_free(monkeypatch, codec_free_library):
    _use_codec_free(monkeypatch, codec_free_library)


def test_shards_are_byte_equal_to_the_jax_writer(sides):
    jax_paths = sides["meta"]["shards"]
    assert [os.path.basename(p) for p in sides["paths"]] == [os.path.basename(p) for p in jax_paths]
    for mine, theirs in zip(sides["paths"], jax_paths, strict=True):
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), mine


def test_record_file_source_decodes_as_opencv(sides):
    ref = sides["ref"]
    src = RecordFileSource(os.path.join(sides["shards"], "train-*.rec"))
    assert len(src) == len(LABELS) * COUNTS["train"]
    for i in range(len(src)):
        rec = src[i]
        assert np.array_equal(rec["image"], ref[f"record_{i}"]), i
        assert rec["label"] == ref["labels"][i]
    assert re.fullmatch(r"record 9 \(.*train-00001-of-00003\.rec #1\)", src.describe(9))  # 8 a shard


def _bmp_rows(src):
    return [p for p, i in enumerate(ROWS) if src.read_record(i)[0][:2] == b"BM"]


@pytest.mark.parametrize("kind", ["val", "pad_crop", "no_aug", "rrc"])
def test_native_sources_are_bit_equal_to_the_jax_native_path(sides, kind):
    pattern = os.path.join(sides["shards"], "train-*.rec")
    made = {
        "val": lambda: NativeRecordFileSource(pattern, 20, 24).load_batch(np.asarray(ROWS), 0),
        "pad_crop": lambda: NativeRecordTrainSource(pattern, 24, 24, seed=3).load_batch(np.asarray(ROWS), 2),
        "no_aug": lambda: NativeRecordTrainSource(pattern, 24, 20, train=False).load_batch(np.asarray(ROWS), 2),
        "rrc": lambda: NativeRecordTrainSource(pattern, 16, 16, aug="rrc", seed=5).load_batch(np.asarray(ROWS), 1),
    }
    got, want = made[kind]()["image"], sides["ref"][kind]
    assert got.dtype == want.dtype and got.shape == want.shape
    src = RecordFileSource(pattern)
    bmp = _bmp_rows(src)
    assert bmp, "the rows hold a BMP payload"
    other = [p for p in range(len(ROWS)) if p not in bmp]
    assert np.array_equal(got[other], want[other])
    if kind == "rrc":
        # the JAX package crops a payload its library cannot decode with the Python
        # random-resized crop, whose draws differ; the port crops every payload alike
        images = [src[ROWS[p]]["image"] for p in bmp]
        mine = native.rrc_flip_u8_batch(images, 16, 16, np.asarray(ROWS)[bmp], seed=5, epoch=1)
        assert np.array_equal(got[bmp], mine)
        return
    # the JAX package resizes a BMP payload with OpenCV's fixed point, the port with its library
    level = 1.0 if got.dtype == np.uint8 else 1.0 / 255 / float(np.min(transforms.IMAGENET_STD))
    assert np.abs(got[bmp].astype(np.float64) - want[bmp].astype(np.float64)).max() <= level + 1e-6


@pytest.mark.parametrize("kind", ["val", "pad_crop", "rrc"])
def test_the_codec_free_route_is_bit_equal_to_the_fused_entries(sides, kind, monkeypatch, codec_free_library):
    """PNG payloads through the port's decoder and the uint8 entries equal the fused
    decode entries, byte for byte (both routes run here, one library built each way)."""
    png = os.path.join(sides["folder"], "png_only")
    for split_label in glob.glob(os.path.join(sides["folder"], "train", "*")):
        dst = os.path.join(png, os.path.basename(split_label))
        os.makedirs(dst, exist_ok=True)
        for f in glob.glob(os.path.join(split_label, "*.png")):
            shutil.copy(f, dst)
    prefix = os.path.join(sides["folder"], f"png_shards_{kind}", "train")
    pack_image_folder(png, LABELS, prefix, num_shards=2)
    rows = np.array([3, 0, 7, 3, 12, 1])

    def batch():
        pattern = prefix + "-*.rec"
        return {
            "val": lambda: NativeRecordFileSource(pattern, 20, 24).load_batch(rows, 0),
            "pad_crop": lambda: NativeRecordTrainSource(pattern, 24, 24, seed=3).load_batch(rows, 2),
            "rrc": lambda: NativeRecordTrainSource(pattern, 16, 16, aug="rrc", seed=5).load_batch(rows, 1),
        }[kind]()["image"]

    fused = batch()
    _use_codec_free(monkeypatch, codec_free_library)
    free = batch()
    assert np.array_equal(free, fused)


def test_a_jpeg_payload_without_codecs_decodes_as_the_jax_sources(sides, codec_free):
    """On the card's build (no libpng) the JPEG payloads take the fused entries, through
    the port's own decoder: ``RecordFileSource`` as the JAX source's ``cv2.imdecode``, and
    the native sources' batches bit-equal to the JAX native path for every JPEG and PNG
    row."""
    pattern = os.path.join(sides["shards"], "train-*.rec")
    ref = sides["ref"]
    src = RecordFileSource(pattern)
    jpeg = [i for i in range(len(src)) if src.read_record(i)[0][:2] == b"\xff\xd8"]
    assert jpeg and set(jpeg) & set(ROWS)
    for i in jpeg:
        assert np.array_equal(src[i]["image"], ref[f"record_{i}"]), i
    rows = np.asarray(ROWS)
    made = {
        "val": lambda: NativeRecordFileSource(pattern, 20, 24).load_batch(rows, 0),
        "pad_crop": lambda: NativeRecordTrainSource(pattern, 24, 24, seed=3).load_batch(rows, 2),
        "no_aug": lambda: NativeRecordTrainSource(pattern, 24, 20, train=False).load_batch(rows, 2),
        "rrc": lambda: NativeRecordTrainSource(pattern, 16, 16, aug="rrc", seed=5).load_batch(rows, 1),
    }
    bmp = _bmp_rows(src)
    other = [p for p in range(len(ROWS)) if p not in bmp]
    for kind, make in made.items():
        assert np.array_equal(make()["image"][other], ref[kind][other]), kind


def test_a_corrupt_payload_is_skipped_and_counted_or_named(sides):
    pattern = os.path.join(sides["corrupt"], "train-*.rec")
    bad = sides["corrupt_index"]
    strict = NativeRecordTrainSource(pattern, 24, 24, seed=3)
    with pytest.raises(native.DecodeError, match=rf"failed to decode record {bad} \(.*\.rec #\d+\)") as err:
        strict.load_batch(np.asarray(ROWS), 2)
    assert isinstance(err.value, CorruptRecordError)
    loader = ShardedLoader(NativeRecordTrainSource(pattern, 24, 24, seed=3), 8, shuffle=False, num_workers=0,
                           skip_corrupt=True)
    assert loader.source.skip_corrupt
    got = loader.source.load_batch(np.asarray(ROWS), 2)
    ref = sides["ref"]
    assert loader.corrupt_skipped == sides["meta"]["skipped"] == 1
    assert np.array_equal(got["label"], ref["skip_labels"])
    bmp = _bmp_rows(RecordFileSource(pattern))
    other = [p for p in range(len(ROWS)) if p not in bmp]
    assert np.array_equal(got["image"][other], ref["skip_images"][other])
    # the per-record path: the loader substitutes the next record and counts it
    per_record = ShardedLoader(RecordFileSource(pattern, transform=Compose([resize(24, 24)])), 4, shuffle=False,
                               num_workers=2, skip_corrupt=True)
    images = [b["image"] for b in per_record]
    assert per_record.corrupt_skipped == 1 and len(images) == len(per_record)
    with pytest.raises(CorruptRecordError, match=rf"record {bad} "):
        RecordFileSource(pattern)[bad]


def test_load_delay_s_sleeps_once_a_batch():
    source = ArrayDataSource(image=np.zeros((8, 2, 2, 3), np.uint8), label=np.zeros(8, np.int32))
    loader = ShardedLoader(source, 2, shuffle=False, num_workers=0)
    loader.load_delay_s = 0.05
    t0 = time.perf_counter()
    assert len(list(loader)) == 4
    assert time.perf_counter() - t0 >= 4 * 0.05


def _c_signatures():
    text = open(native.SOURCE).read()
    found = {}
    for name, params in re.findall(r"int64_t (dtp_\w+)\(([^)]*)\)\s*\{", text):
        found[name] = [re.sub(r"\s*\*\s*", "*", " ".join(p.split()[:-1])) for p in params.split(",")]
    return found


_C_TYPES = {
    "const char*const*": "strs", "int64_t": "i64", "int": "i32", "uint64_t": "u64", "float": "f32",
    "double": "f64", "const float*": "fptr", "float*": "fptr", "const uint8_t*": "u8ptr", "uint8_t*": "u8ptr",
    "const int64_t*": "i64ptr", "int64_t*": "i64ptr", "const uint8_t*const*": "ptrs",
}


def test_every_native_entry_point_has_matching_ctypes_argtypes():
    """ctypes converts each argument by ``native.ARGTYPES`` alone: every ``extern "C"``
    entry of ``csrc/dtp_native.cpp`` has a row, with the C signature's count and types."""
    import ctypes

    py = {
        id(ctypes.POINTER(ctypes.c_char_p)): "strs", id(ctypes.c_int64): "i64", id(ctypes.c_int): "i32",
        id(ctypes.c_uint64): "u64", id(ctypes.c_float): "f32", id(ctypes.c_double): "f64",
        id(ctypes.POINTER(ctypes.c_void_p)): "ptrs",
    }

    def kind(t):
        if id(t) in py:
            return py[id(t)]
        return {np.float32: "fptr", np.uint8: "u8ptr", np.int64: "i64ptr"}[t._dtype_.type]

    sigs = _c_signatures()
    assert sorted(sigs) == sorted(native.ARGTYPES)
    for name, types in sigs.items():
        got = [kind(t) for t in native.ARGTYPES[name]]
        want = [_C_TYPES[t] for t in types]
        # a pointer to const uint8_t arrays is passed as c_char_p (payload bytes) or as
        # c_void_p (decoded images)
        want = ["strs" if (w == "ptrs" and g == "strs") else w for g, w in zip(got, want, strict=True)]
        assert got == want, name


class _Recorded:
    def train_epoch(self, epoch):
        self.record["train"].append(super().train_epoch(epoch))
        return self.record["train"][-1]

    def validate(self):
        self.record["val"].append(super().validate())
        return self.record["val"][-1]


def _assert_tracks(got, ref, ce_atol):
    assert len(got["train"]) == len(ref["train"]) == EPOCHS == len(got["val"]) == len(ref["val"])
    for epoch in range(EPOCHS):
        for split in ("train", "val"):
            g, r = got[split][epoch], ref[split][epoch]
            np.testing.assert_allclose(g["ce_loss"], r["ce_loss"], atol=ce_atol, err_msg=f"{split} {epoch}")
            np.testing.assert_allclose(g["accuracy"], r["accuracy"], atol=1e-6, err_msg=f"{split} {epoch}")
        np.testing.assert_allclose(got["train"][epoch]["lr"], ref["train"][epoch]["lr"], rtol=1e-6)


def test_records_entry_tracks_the_jax_entry(sides, tmp_path, monkeypatch):
    monkeypatch.setenv("DTYPE", "fp32")
    for knob in ("PALLAS", "MESH", "TELEMETRY", "SNAPSHOT"):
        monkeypatch.delenv(knob, raising=False)

    class Trainer(_Recorded, train_records.RecordsDigitsTrainer):
        record = {"train": [], "val": []}

    trainer = train_records.build_trainer(
        sides["patterns"], str(tmp_path), "cpu", max_epoch=EPOCHS, batch_size=DIGITS_BATCH, save_period=1,
        last_save_period=EPOCHS, save_best_for=None, logger=None)
    trainer.__class__ = Trainer
    flat = {k.split("::", 1)[1]: v for k, v in sides["ref"].items() if k.startswith("digits::")}
    trainer.model.load_state_dict(resnet_params_from_jax(_unflatten(flat)))
    assert len(trainer.train_dataloader) == 10 * DIGITS_COUNTS["train"] // DIGITS_BATCH
    trainer.train()
    _assert_tracks(Trainer.record, sides["meta"]["records_run"], 1e-4)


def test_imagenet_entry_on_records_tracks_the_jax_entry(sides, tmp_path, monkeypatch):
    for key, value in {"IMAGE_SIZE": "32", "NUM_CLASSES": "3", "DTYPE": "fp32", "SHIP_UINT8": "1",
                       "IMAGENET_RECORDS": os.path.join(sides["inet"], "train-*.rec"),
                       "VAL_RECORDS": os.path.join(sides["inet"], "val-*.rec")}.items():
        monkeypatch.setenv(key, value)
    for knob in ("PALLAS", "STEPS_PER_EPOCH", "RECORDS_NATIVE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setitem(train_imagenet.RECIPES, "resnet18_slim", dict(train_imagenet.RECIPES["resnet50"]))

    class Trainer(_Recorded, train_imagenet.ImageNetTrainer):
        record = {"train": [], "val": []}

    trainer = Trainer(model_name="resnet18_slim", image_size=32, base_lr=0.1, max_epoch=EPOCHS,
                      batch_size=INET_BATCH, have_validate=True, save_period=1, last_save_period=EPOCHS,
                      save_folder=str(tmp_path), device="cpu")
    assert isinstance(trainer.train_dataset, NativeRecordTrainSource) and trainer.train_dataset.aug == "rrc"
    assert isinstance(trainer.val_dataset, NativeRecordFileSource)
    flat = {k.split("::", 1)[1]: v for k, v in sides["ref"].items() if k.startswith("inet::")}
    trainer.model.load_state_dict(resnet_params_from_jax(_unflatten(flat)))
    trainer.train()
    _assert_tracks(Trainer.record, sides["meta"]["inet_run"], 1e-5)


def test_steps_per_epoch_keeps_the_record_fast_path(sides, tmp_path, monkeypatch):
    for key, value in {"IMAGE_SIZE": "32", "NUM_CLASSES": "3", "STEPS_PER_EPOCH": "1",
                       "IMAGENET_RECORDS": os.path.join(sides["corrupt"], "train-*.rec")}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setitem(train_imagenet.RECIPES, "resnet18_slim", dict(train_imagenet.RECIPES["resnet50"]))
    trainer = train_imagenet.ImageNetTrainer(model_name="resnet18_slim", image_size=32, base_lr=0.1, max_epoch=1,
                                             batch_size=24, save_folder=str(tmp_path), device="cpu",
                                             skip_corrupt_records=True)
    loader = trainer.train_dataloader
    assert len(loader) == 1 and loader._batch_fast_path() == "source"
    assert loader.source.source.skip_corrupt  # reached the record source through the cap
    batch = next(iter(loader))
    assert batch["image"].shape == (24, 32, 32, 3) and batch["image"].dtype == np.uint8
    assert loader.corrupt_skipped == 1
    monkeypatch.setenv("RECORDS_NATIVE", "0")
    monkeypatch.setenv("IMAGENET_RECORDS", os.path.join(sides["shards"], "train-*.rec"))
    per_record = train_imagenet.ImageNetTrainer(model_name="resnet18_slim", image_size=32, base_lr=0.1,
                                                max_epoch=1, batch_size=8, save_folder=str(tmp_path / "p"),
                                                device="cpu")
    assert type(per_record.train_dataset.source) is RecordFileSource
    assert next(iter(per_record.train_dataloader))["image"].shape == (8, 32, 32, 3)
