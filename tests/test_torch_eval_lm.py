"""The port's offline LM entries (``distributed_training_pytorch_tpu_torch/examples/eval_lm.py``
and ``make_lm_corpus.py``) held against the repository's ``examples/eval_lm.py`` and
``examples/make_lm_corpus.py``.

The JAX ``evaluate`` imports ``examples/train_lm.py``, which imports the JAX package's
``data/``; that does not import in this tree (its ``data/streaming/`` was never
committed). So the JAX side runs in one module-scoped subprocess that first installs a
stand-in ``distributed_training_pytorch_tpu.data.streaming`` whose names raise when used
(``load_windows`` uses none of them). The port side runs here, on the CPU, on the JAX
run's weights (``models/convert.py::params_from_jax``).

Tolerances: the NLL within 1e-5 of the JAX ``evaluate`` in f32 (the same forward and
log-softmax, summed in other orders), the window counts equal; the corpus byte-equal.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
from distributed_training_pytorch_tpu_torch.examples import eval_lm, make_lm_corpus
from distributed_training_pytorch_tpu_torch.models import LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.train import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, CORPUS_BYTES = 32, 8, 700  # 21 windows: two full batches and a tail of 5

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

    out, corpus, seq, batch = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    import jax
    import jax.numpy as jnp
    from flax import traverse_util
    from distributed_training_pytorch_tpu.models import LMTiny
    sys.path.insert(0, "examples")
    import eval_lm

    model = LMTiny(vocab_size=256, dtype=jnp.float32, max_len=128)
    params = model.init(jax.random.key(0), jnp.zeros((1, seq), jnp.int32))["params"]
    result = eval_lm.evaluate("", corpus, size="tiny", seq_len=seq, batch=batch, loaded=(model, params))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params), sep="/")
    np.savez(out, **flat)
    with open(out + ".json", "w") as f:
        json.dump(result, f)
    """
)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "corpus.bin"
    text = b"".join(b"line %d: the quick brown fox jumps over the lazy dog\n" % i for i in range(40))
    path.write_bytes(text[:CORPUS_BYTES])
    return str(path)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, corpus):
    out = str(tmp_path_factory.mktemp("jax_side") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1")
    env.pop("PYTHONPATH", None)
    subprocess.run([sys.executable, "-c", _JAX_SIDE, out, corpus, str(SEQ), str(BATCH)], cwd=REPO, env=env,
                   check=True, capture_output=True, text=True, timeout=600)
    with open(out + ".json") as f:
        result = json.load(f)
    return _unflatten(dict(np.load(out))), result


@pytest.fixture(scope="module")
def loaded(jax_side):
    model = LMTiny(vocab_size=256, max_len=128, device="cpu")
    model.load_state_dict(params_from_jax(jax_side[0]))
    return model.eval(), model.state_dict()


def test_evaluate_matches_the_jax_evaluate(jax_side, corpus, loaded):
    ref = jax_side[1]
    got = eval_lm.evaluate("", corpus, size="tiny", seq_len=SEQ, batch=BATCH, loaded=loaded)
    assert got["n_windows"] == ref["n_windows"] == 21  # the tail batch is kept
    assert abs(got["nll"] - ref["nll"]) < 1e-5
    assert got["ppl"] == pytest.approx(np.exp(got["nll"]))


def test_load_params_restores_a_train_lm_checkpoint(tmp_path, corpus):
    model = eval_lm.build_model("tiny", SEQ, device="cpu")
    torch.nn.init.normal_(model.pos_embed, std=0.5, generator=torch.Generator().manual_seed(3))
    manager = CheckpointManager(tmp_path / "weights")
    manager.save("last", TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1)), epoch=2)
    restored, params = eval_lm.load_params(str(tmp_path / "weights" / "last"), "tiny", SEQ, device="cpu")
    assert restored.dtype == torch.bfloat16 and not restored.training
    for name, value in model.state_dict().items():
        torch.testing.assert_close(params[name], value, rtol=0, atol=0)
    by_path = eval_lm.evaluate(str(tmp_path / "weights" / "last"), corpus, size="tiny", seq_len=SEQ, batch=BATCH,
                               device="cpu")
    assert by_path == eval_lm.evaluate("", corpus, size="tiny", seq_len=SEQ, batch=BATCH, loaded=(model, None))
    (tmp_path / "orbax" / "params").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        eval_lm.load_params(str(tmp_path / "orbax"), "tiny", SEQ, device="cpu")
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        eval_lm.build_model("tiny", SEQ, moe_every=2, device="cpu")


def test_short_corpus_raises(tmp_path, loaded):
    short = tmp_path / "short.bin"
    short.write_bytes(b"abc")
    with pytest.raises(ValueError, match="too short for SEQ_LEN=32"):
        eval_lm.evaluate("", str(short), size="tiny", seq_len=SEQ, loaded=loaded)


def test_sample_keeps_the_prompt_and_decode_benchmark_rows(loaded):
    timings: dict = {}
    out = eval_lm.sample("", b"hello ", size="tiny", seq_len=SEQ, gen_steps=6, temperature=0.7, loaded=loaded,
                         timings=timings)
    assert set(out) == {"greedy", "t=0.7"}
    for text in out.values():
        assert text.startswith(b"hello ") and len(text) == len(b"hello ") + 6
    assert timings["decode_steps"] == 5 + 6 and timings["gen_steps"] == 6
    assert timings["decode_tok_per_s"] == pytest.approx(11 / timings["seconds"])
    assert timings["new_tok_per_s"] == pytest.approx(6 / timings["seconds"])
    rows = eval_lm.decode_benchmark(loaded[0], prompt_len=4, gen_steps=5, batches=(1, 3))
    assert [r["batch"] for r in rows] == [1, 3] and not any(r["graph"] for r in rows)  # the CPU: eager
    for r in rows:
        assert r["tok_per_s"] == pytest.approx(r["batch"] * r["tok_per_s_per_stream"])
        assert r["new_tok_per_s"] == pytest.approx(r["tok_per_s"] * 5 / 8)
        assert r["step_ms"] == pytest.approx(1e3 / r["tok_per_s_per_stream"])


def test_entry_prints_the_jax_entrys_lines(tmp_path, corpus, loaded, monkeypatch, capsys):
    manager = CheckpointManager(tmp_path / "weights")
    manager.save("best", TrainState(model=loaded[0], optimizer=torch.optim.SGD(loaded[0].parameters(), lr=0.1)),
                 epoch=1)
    monkeypatch.setenv("LM_SIZE", "tiny")
    monkeypatch.setenv("SEQ_LEN", str(SEQ))
    monkeypatch.setenv("EVAL_BATCH", str(BATCH))
    monkeypatch.setenv("GEN_STEPS", "5")
    monkeypatch.setenv("DECODE_BATCHES", "1,2")
    monkeypatch.setenv("DECODE_GEN_STEPS", "4")
    report = eval_lm.main([str(tmp_path / "weights" / "best"), corpus], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("VALIDATION: nll=") and lines[0].endswith("(21 windows)")
    assert lines[1] == "--- greedy ---" and lines[3] == "--- t=0.8 ---"
    assert lines[5].startswith("DECODE: ") and lines[5].endswith("(greedy, batch 1, 8 single-token steps)")
    assert lines[6].startswith("DECODE_NEW: ")
    assert [line[:17] for line in lines[7:]] == ["DECODE_BATCH    1", "DECODE_BATCH    2"]
    assert report["samples"]["greedy"].startswith("the ")


def test_corpus_is_byte_equal_to_the_repository_script(tmp_path, capsys):
    sys.path.insert(0, REPO)
    try:
        from examples import make_lm_corpus as reference
    finally:
        sys.path.remove(REPO)
    data = make_lm_corpus.collect(2_000_000)
    assert len(data) == 2_000_000
    assert data == reference.collect(2_000_000)
    out = make_lm_corpus.main([str(tmp_path / "c.txt"), "1.5"])
    assert (tmp_path / "c.txt").read_bytes() == data[:1_500_000]
    assert out["bytes"] == 1_500_000 and f"sha256 {out['sha256']}" in capsys.readouterr().out
