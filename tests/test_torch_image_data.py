"""The port's image data path held against the JAX package's: the transforms
(``distributed_training_pytorch_tpu_torch/data/transforms.py``), the ImageNet entry's
``synthetic_source``, the loader with a per-record transform (F2), and the metrics
(``ops/metrics.py``).

The JAX package's ``data/`` package does not import in this tree (its ``data/streaming/``
was never committed), so its transforms, loader and ImageNet entry run in a subprocess
that first installs a stand-in ``data.streaming`` module whose names raise when used, as
``tests/test_torch_trainer_lm.py`` does; nothing of it reaches this process.

Tolerances: crop boxes, flips, synthetic bytes and loader batches byte-equal; resized
pixels within 1 of OpenCV's ``INTER_LINEAR`` (the port resizes in f32 and rounds; OpenCV
in fixed point); metrics within 1e-7.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.ops import metrics as jax_metrics
from distributed_training_pytorch_tpu_torch.data import ArrayDataSource, ShardedLoader
from distributed_training_pytorch_tpu_torch.data import transforms as T
from distributed_training_pytorch_tpu_torch.examples import train_imagenet
from distributed_training_pytorch_tpu_torch.ops import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = 24  # images of the transform cases
LOADER_CASES = [  # seed, epoch, process_count, phase
    (0, 0, 1, "train"), (3, 2, 2, "train"), (5, 1, 2, "val"),
]

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

    out, n, cases = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
    from distributed_training_pytorch_tpu.data import ArrayDataSource, ShardedLoader
    from distributed_training_pytorch_tpu.data import transforms as T
    import examples.train_imagenet as entry

    rng = np.random.RandomState(11)
    images = [rng.randint(0, 256, size=(rng.randint(20, 60), rng.randint(20, 60), 3)).astype(np.uint8) for _ in range(n)]
    arrays = {f"image/{i}": img for i, img in enumerate(images)}
    rrc, flip = T.random_resized_crop(32, 24), T.Compose([T.horizontal_flip()], seed=3)
    boxes = T.Compose([T.random_resized_crop(32, 24)], seed=3)
    real_cv2 = T._cv2
    for i, img in enumerate(images):
        for epoch in (0, 1):
            arrays[f"rrc/{i}/{epoch}"] = T.Compose([rrc, T.horizontal_flip()], seed=3)(img, epoch=epoch, index=i)
            arrays[f"flip/{i}/{epoch}"] = flip(img, epoch=epoch, index=i)
            arrays[f"eval/{i}/{epoch}"] = T.eval_transform(40, 30)(img, epoch=epoch, index=i)
    # The crop boxes alone: OpenCV's resize replaced by the identity.
    T._cv2 = lambda: types.SimpleNamespace(INTER_LINEAR=1, resize=lambda img, size, interpolation: img.copy())
    for i, img in enumerate(images):
        arrays[f"box/{i}"] = boxes(img, epoch=1, index=i)
    T._cv2 = real_cv2

    src = entry.synthetic_source(70, 16, 10, None, seed=5)
    arrays["synthetic/image"], arrays["synthetic/label"] = src.arrays["image"], src.arrays["label"]

    data = rng.randint(0, 256, size=(37, 6, 5, 3)).astype(np.uint8)
    source = ArrayDataSource(transform=T.Compose([T.horizontal_flip(), T.normalize()], seed=9), image=data,
                             label=np.arange(37, dtype=np.int32))
    arrays["loader/data"] = data
    for ci, (seed, epoch, count, phase) in enumerate(cases):
        for rank in range(count):
            loader = ShardedLoader(source, 8, shuffle=phase == "train", seed=seed, num_workers=0,
                                   drop_last=phase == "train", pad_final=phase == "val",
                                   process_index=rank, process_count=count)
            loader.set_epoch(epoch)
            for b, batch in enumerate(loader):
                for key, value in batch.items():
                    arrays[f"loader/{ci}/{rank}/{b}/{key}"] = value
    np.savez(out, **arrays)
    """
)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_side") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, out, str(RECORDS), json.dumps(LOADER_CASES)],
        cwd=REPO, env=env, check=True, capture_output=True, text=True, timeout=300,
    )
    return dict(np.load(out))


def test_crop_boxes_and_flips_are_the_jax_draws(jax_side, monkeypatch):
    boxes = T.Compose([T.random_resized_crop(32, 24)], seed=3)
    flip = T.Compose([T.horizontal_flip()], seed=3)
    for i in range(RECORDS):
        img = jax_side[f"image/{i}"]
        for epoch in (0, 1):
            got = flip(img, epoch=epoch, index=i)
            assert got.tobytes() == jax_side[f"flip/{i}/{epoch}"].tobytes(), (i, epoch)
    monkeypatch.setattr(T, "_resize_image", lambda img, height, width: img.copy())
    for i in range(RECORDS):
        got = boxes(jax_side[f"image/{i}"], epoch=1, index=i)
        want = jax_side[f"box/{i}"]
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), i


def test_resized_pixels_within_one_of_opencv(jax_side):
    rrc = T.Compose([T.random_resized_crop(32, 24), T.horizontal_flip()], seed=3)
    worst = 0
    for i in range(RECORDS):
        img = jax_side[f"image/{i}"]
        for epoch in (0, 1):
            got = rrc(img, epoch=epoch, index=i)
            want = jax_side[f"rrc/{i}/{epoch}"]
            assert got.dtype == np.uint8 and got.shape == want.shape == (32, 24, 3)
            worst = max(worst, int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()))
            ev = T.eval_transform(40, 30)(img, epoch=epoch, index=i)
            # normalised: 1 pixel level is 1 / (255 * std) <= 0.0175
            np.testing.assert_allclose(ev, jax_side[f"eval/{i}/{epoch}"], atol=1.0 / (255 * 0.224) + 1e-6)
    assert worst <= 1


def test_synthetic_source_bytes_equal_the_jax_entry(jax_side, monkeypatch):
    monkeypatch.setattr(train_imagenet, "SYNTHETIC_CHUNK", 32)  # 70 images: 32 + 32 + 6
    src = train_imagenet.synthetic_source(70, 16, 10, None, seed=5)
    assert src.arrays["image"].tobytes() == jax_side["synthetic/image"].tobytes()
    assert src.arrays["label"].tobytes() == jax_side["synthetic/label"].tobytes()


def test_loader_applies_the_transform_as_the_jax_loader(jax_side):
    """F2: the loader applies the source's transform per record, keyed by (epoch, index);
    the batches equal the JAX loader's byte for byte."""
    data = jax_side["loader/data"]
    source = ArrayDataSource(
        transform=T.Compose([T.horizontal_flip(), T.normalize()], seed=9), image=data,
        label=np.arange(37, dtype=np.int32),
    )
    for ci, (seed, epoch, count, phase) in enumerate(LOADER_CASES):
        for rank in range(count):
            loader = ShardedLoader(
                source, 8, shuffle=phase == "train", seed=seed, drop_last=phase == "train",
                pad_final=phase == "val", process_index=rank, process_count=count,
            )
            loader.set_epoch(epoch)
            batches = list(loader)
            assert batches and all(b["image"].dtype == np.float32 for b in batches)
            for b, batch in enumerate(batches):
                for key, value in batch.items():
                    ref = jax_side[f"loader/{ci}/{rank}/{b}/{key}"]
                    assert value.dtype == ref.dtype and value.tobytes() == ref.tobytes(), (ci, rank, b, key)
    capped = train_imagenet._LimitedSource(source, 16)
    assert len(capped) == 16 and capped.transform is source.transform
    assert len(ShardedLoader(capped, 8)) == 2


@pytest.mark.parametrize("k", [1, 3])
def test_metrics_match_the_jax_metrics(k):
    rng = np.random.RandomState(6)
    logits = rng.randn(33, 7).astype(np.float32)
    labels = rng.randint(0, 7, size=(33,)).astype(np.int32)
    mask = (rng.rand(33) > 0.3).astype(np.float32)
    lt, yt, mt = torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask)
    for weights, w in ((None, None), (mt, jnp.asarray(mask))):
        np.testing.assert_allclose(
            float(metrics.accuracy(lt, yt, weights)), float(jax_metrics.accuracy(logits, labels, w)), atol=1e-7
        )
        np.testing.assert_allclose(
            float(metrics.top_k_accuracy(lt, yt, k, weights)),
            float(jax_metrics.top_k_accuracy(logits, labels, k, w)), atol=1e-7,
        )
    assert int(metrics.correct_count(lt, yt)) == int(jax_metrics.correct_count(logits, labels))
