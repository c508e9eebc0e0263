"""The port's folder sources (``distributed_training_pytorch_tpu_torch/data/dataset.py``:
``ImageFolderDataSource``, ``NativeImageFolderSource``) held against the JAX package's
(``distributed_training_pytorch_tpu/data/dataset.py:25-136``) on the CPU.

The JAX side runs in a subprocess with the ``data.streaming`` stand-in (its ``data``
package does not import without it), building its native library under the same lock
as ``tests/test_torch_native_data.py``. Both read one tree of PNG, JPEG and BMP files of
several sizes (an upper-case extension and a non-image file among them).

Tolerances: the records, labels and error messages equal; decoded records byte-equal
(JPEG through the port's own decoder against the JAX side's OpenCV, with the library built
with libpng and without); batches of
``load_batch`` bit-equal for the JPEG and PNG records, whose resize is the native
library's on both sides, and within one pixel level (1/255/std after normalising) for the
BMP records, which the JAX source resizes with OpenCV.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from distributed_training_pytorch_tpu_torch.data import ImageFolderDataSource, NativeImageFolderSource, native
from distributed_training_pytorch_tpu_torch.data import ShardedLoader
from distributed_training_pytorch_tpu_torch.data.dataset import decode_image
from distributed_training_pytorch_tpu_torch.data.transforms import IMAGENET_STD, eval_transform

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ["cat", "dog", "snake"]
ROWS = [0, 5, 3, 8, 8, 1, 2, 7, 4, 4]  # repeats, as a padded batch has
H, W = 24, 32

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
        fcntl.flock(lock, fcntl.LOCK_EX)
        assert native.available(), "the JAX package's native library did not build"
    from distributed_training_pytorch_tpu.data.dataset import ImageFolderDataSource, NativeImageFolderSource

    out, root, labels, rows, h, w = sys.argv[1], sys.argv[2], *map(json.loads, sys.argv[3:5]), *map(int, sys.argv[5:7])
    src = ImageFolderDataSource(root, labels)
    res = {f"record{i}": src[i]["image"] for i in range(len(src))}
    meta = {"records": src.records, "labels": [int(src[i]["label"]) for i in range(len(src))], "errors": {}}
    for name, args in (("missing", (root, labels + ["lizard"])), ("empty", (os.path.join(root, "empty"), ["x"]))):
        try:
            ImageFolderDataSource(*args)
        except Exception as e:
            meta["errors"][name] = [type(e).__name__, str(e)]
    batch = NativeImageFolderSource(root, labels, h, w).load_batch(np.asarray(rows), 0)
    res["batch"], res["batch_labels"] = batch["image"], batch["label"]
    np.savez(out, **res)
    with open(out + ".json", "w") as f:
        json.dump(meta, f)
    """
)


def _write_tree(root):
    rng = np.random.RandomState(8)
    sizes = [(30, 40), (24, 32), (41, 27)]
    n = 0
    for li, label in enumerate(LABELS):
        os.makedirs(os.path.join(root, label))
        for i, ext in enumerate([".png", ".jpg", ".bmp"]):
            h, w = sizes[(i + li) % 3]
            img = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
            name = f"{i}{ext.upper() if li == 1 and i == 0 else ext}"
            assert cv2.imwrite(os.path.join(root, label, name), img)
            n += 1
    with open(os.path.join(root, "cat", "notes.txt"), "w") as f:
        f.write("not an image")
    os.makedirs(os.path.join(root, "empty", "x"))
    return n


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("folder"))
    n = _write_tree(root)
    out = str(tmp_path_factory.mktemp("jax_folder") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, out, root, json.dumps(LABELS), json.dumps(ROWS), str(H), str(W)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out + ".json") as f:
        meta = json.load(f)
    return root, n, dict(np.load(out)), meta


def test_records_labels_and_decoded_images_equal_the_jax_source(tree):
    root, n, ref, meta = tree
    src = ImageFolderDataSource(root, LABELS)
    assert len(src) == n == len(meta["records"])
    assert [list(r) for r in src.records] == meta["records"]
    for i in range(len(src)):
        rec = src[i]
        assert int(rec["label"]) == meta["labels"][i] and rec["label"].dtype == np.int32
        np.testing.assert_array_equal(rec["image"], ref[f"record{i}"], err_msg=src.records[i][0])


def test_errors_equal_the_jax_source(tree):
    root, _, _, meta = tree
    for name, args in (("missing", (root, LABELS + ["lizard"])), ("empty", (os.path.join(root, "empty"), ["x"]))):
        with pytest.raises((FileNotFoundError, ValueError)) as info:
            ImageFolderDataSource(*args)
        assert [type(info.value).__name__, str(info.value)] == meta["errors"][name]


def test_native_source_batches_match_the_jax_source(tree):
    root, _, ref, _ = tree
    src = NativeImageFolderSource(root, LABELS, H, W)
    batch = src.load_batch(np.asarray(ROWS), 0)
    np.testing.assert_array_equal(batch["label"], ref["batch_labels"])
    assert batch["image"].shape == (len(ROWS), H, W, 3) and batch["image"].dtype == np.float32
    for p, i in enumerate(ROWS):
        path = src.records[i][0]
        if path.lower().endswith(".bmp"):
            np.testing.assert_array_less(np.abs(batch["image"][p] - ref["batch"][p]), 1 / 255 / IMAGENET_STD.min() + 1e-5)
        else:
            np.testing.assert_array_equal(batch["image"][p], ref["batch"][p], err_msg=path)


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


def test_native_source_without_codecs_decodes_the_jpeg(tree, monkeypatch, codec_free_library):
    """On a library built without codecs the JPEG files decode through the port's own
    decoder: the records as the JAX source's ``cv2.imread``, and ``load_batch`` bit-equal
    to the JAX native source for the JPEG and PNG records (a BMP within a level)."""
    root, _, ref, _ = tree
    monkeypatch.setattr(native, "LIBRARY", codec_free_library)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available(), native.build_error()
    assert not native.codecs_available()
    src = NativeImageFolderSource(root, LABELS, H, W)
    jpeg = [i for i, (p, _) in enumerate(src.records) if p.lower().endswith(".jpg")]
    assert jpeg and set(jpeg) & set(ROWS)
    for i in jpeg:
        np.testing.assert_array_equal(src[i]["image"], ref[f"record{i}"], err_msg=src.records[i][0])
    batch = src.load_batch(np.asarray(ROWS), 0)["image"]
    for p, i in enumerate(ROWS):
        path = src.records[i][0]
        if path.lower().endswith(".bmp"):
            np.testing.assert_array_less(np.abs(batch[p] - ref["batch"][p]), 1 / 255 / IMAGENET_STD.min() + 1e-5)
        else:
            np.testing.assert_array_equal(batch[p], ref["batch"][p], err_msg=path)


@pytest.mark.parametrize("num_workers", [0, 3])
def test_the_loader_pads_and_masks_a_folder(tree, num_workers):
    root, n, ref, _ = tree
    src = ImageFolderDataSource(root, LABELS, transform=eval_transform(H, W))
    loader = ShardedLoader(src, 4, shuffle=False, drop_last=False, pad_final=True, num_workers=num_workers)
    batches = list(loader)
    real_last = n - 4 * (len(batches) - 1)
    assert len(batches) == -(-n // 4) and loader.global_real_count(len(batches) - 1) == real_last
    assert batches[-1]["mask"].tolist() == [1.0] * real_last + [0.0] * (4 - real_last)
    labels = np.concatenate([b["label"] for b in batches])[:n]
    np.testing.assert_array_equal(labels, [r[1] for r in src.records])


@pytest.mark.parametrize("kind", ["png", "bmp"])
def test_a_truncated_file_raises_a_decode_error_naming_it(tmp_path, kind):
    """F7: a PNG cut inside its header raised ``struct.error``, which is no ``ValueError``,
    where the JAX source raises a ``ValueError`` (``cv2.imread`` gives None), so a loader
    that skips corrupt records (which catches ``ValueError``) stopped on it."""
    ok = cv2.imencode(f".{kind}", np.zeros((6, 5, 3), np.uint8))[1].tobytes()
    path = tmp_path / f"cut.{kind}"
    path.write_bytes(ok[: 20 if kind == "png" else 30])
    with pytest.raises(native.DecodeError, match="cut") as err:
        decode_image(str(path))
    assert isinstance(err.value, ValueError)
