"""SIGTERM preemption, mid-epoch resume and ``nan_policy="restore_last_good"`` in the port's
``Trainer``, on the CPU, against the JAX ``Trainer``.

* The SIGTERM plan (10 steps an epoch, batch 8, ``chain_steps=2``, ``log_every=2``,
  periodic saves every epoch, no validation): a ``sigterm`` fault at epoch 1 step 5,
  inside the window [4, 6). The port side drives its LM entry
  (``examples/train_lm.py::build_trainer``, LMTiny, f32, T=32) in a subprocess, where the
  plan's SIGTERM is a real signal to that process; the JAX side runs a JAX ``Trainer`` of
  10 steps an epoch (a small MLP) in a subprocess with a stand-in ``data.streaming`` module
  (as ``tests/test_torch_trainer_lm.py`` runs it): the rule under test, where the loop stops
  and how the save is labelled, is the trainer's, not the model's. Both stop preempted with
  the same ``last``: resume epoch 1, ``step_in_epoch`` 5, step 15.
* In the same port process, a resume from ``"latest_valid"`` runs to the end and its params
  and optimizer state are bit-exact against an uninterrupted run.
* ``restore_last_good`` with no checkpoint yet (a ``nan_loss`` fault at epoch 0 step 1,
  float features, a small MLP on both sides): the step is skipped and counted, nothing is
  rolled back, and the port logs JAX's warning word for word.
* ``restore_last_good`` with a checkpoint (port): the NaN at epoch 1 step 2 rolls the state
  back to ``checkpoint_epoch_1`` (params, moments, step) at the next sync point, and counts
  one rollback.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
from distributed_training_pytorch_tpu_torch.fault import FaultPlan
from distributed_training_pytorch_tpu_torch.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, WINDOWS, EPOCHS = 32, 8, 90, 2  # 85 train windows: 10 steps an epoch
PLAN = [("sigterm", 1, 5)]
KNOBS = dict(seq_len=SEQ, base_lr=1e-3, size="tiny", moe_every=0, max_epoch=EPOCHS, batch_size=BATCH,
             chain_steps=2, log_every=2, have_validate=False, save_period=1, num_workers=0)
NAN_PLAN = [("nan_loss", 0, 1)]

_JAX_SIDE = textwrap.dedent(
    """
    import json, os, sys, types

    stub = types.ModuleType("distributed_training_pytorch_tpu.data.streaming")
    def _unavailable(*a, **k):
        raise RuntimeError("data/streaming is not in this tree")
    for name in ("DecodePool", "ReaderState", "StreamingLoader", "shard_array_source"):
        setattr(stub, name, _unavailable)
    sys.modules[stub.__name__] = stub

    import numpy as np
    import optax
    from flax import linen as nn
    from distributed_training_pytorch_tpu.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu.data import ArrayDataSource
    from distributed_training_pytorch_tpu.fault import FaultPlan
    from distributed_training_pytorch_tpu.ops import cross_entropy_loss
    from distributed_training_pytorch_tpu.trainer import Trainer

    out, knobs, plans = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x, *, train: bool = False):
            return nn.Dense(3)(nn.relu(nn.Dense(16)(x)))

    class Tiny(Trainer):
        def build_train_dataset(self):
            rng = np.random.RandomState(0)
            return ArrayDataSource(image=rng.randn(80, 6).astype(np.float32), label=rng.randint(0, 3, 80))

        def build_model(self):
            return Net()

        def build_criterion(self):
            def criterion(logits, batch):
                loss = cross_entropy_loss(logits, batch["label"])
                return loss, {"ce": loss}
            return criterion

        def build_optimizer(self, schedule):
            return optax.adamw(schedule)

        def build_scheduler(self):
            return 1e-2

    class Lines:
        def __init__(self):
            self.lines = []
        def log(self, msg, log_type="info"):
            self.lines.append([log_type, msg])

    record = {}
    for name, plan_spec, extra in (("sigterm", plans[0], {}), ("nan", plans[1], {"nan_policy": "restore_last_good"})):
        plan = FaultPlan()
        for kind, epoch, step in plan_spec:
            plan.add(kind, epoch=epoch, step=step)
        logger = Lines()
        save = os.path.join(os.path.dirname(out), name)
        trainer = Tiny(max_epoch=knobs["max_epoch"], batch_size=knobs["batch_size"], save_folder=save,
                       chain_steps=knobs["chain_steps"], log_every=knobs["log_every"], save_period=1,
                       num_workers=0, fault_plan=plan, logger=logger, progress=False, **extra)
        trainer.train()
        rec = {"preempted": trainer._preempted, "step": int(trainer.state.step),
               "nonfinite_steps": trainer.nonfinite_steps, "rollbacks": trainer.nonfinite_rollbacks,
               "warnings": [m for t, m in logger.lines if "non-finite" in m]}
        if trainer._preempted:
            meta = CheckpointManager(os.path.join(save, "weights")).read_meta("last")
            rec.update(epoch=meta["epoch"], loop=meta.get("loop"))
        record[name] = rec
    with open(out, "w") as f:
        json.dump(record, f)
    """
)

_PORT_SIDE = textwrap.dedent(
    """
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu_torch.examples import train_lm
    from distributed_training_pytorch_tpu_torch.fault import FaultPlan

    out, knobs, plan_spec, n_windows = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]), int(sys.argv[4])
    windows = train_lm.load_windows(knobs["seq_len"])[:n_windows]
    train_lm.load_windows = lambda seq_len, path=None: windows
    os.environ.update(DTYPE="fp32", LM_SIZE="tiny", SEQ_LEN=str(knobs["seq_len"]), BATCH=str(knobs["batch_size"]),
                      EPOCHS=str(knobs["max_epoch"]), CHAIN_STEPS=str(knobs["chain_steps"]))

    class Lines:
        def __init__(self):
            self.lines = []
        def log(self, msg, log_type="info"):
            self.lines.append([log_type, msg])

    def run(save_dir, kinds, snapshot=None):
        plan = FaultPlan()
        for kind, epoch, step in plan_spec:
            if kind in kinds:
                plan.add(kind, epoch=epoch, step=step)
        logger = Lines()

        class Planned(train_lm.LMTrainer):
            def __init__(self, **kw):
                kw.update(have_validate=False, save_period=1, log_every=knobs["log_every"], num_workers=0,
                          fault_plan=plan, logger=logger, snapshot_path=snapshot)
                super().__init__(**kw)

        os.environ["SAVE_DIR"] = save_dir
        trainer = train_lm.build_trainer("cpu", Planned)
        trainer.train()
        return trainer, logger

    root = os.path.dirname(out)
    cut, logger = run(os.path.join(root, "cut"), ("sigterm",))
    meta = CheckpointManager(os.path.join(root, "cut", "weights")).read_meta("last")
    record = {"preempted": cut.preempted, "epoch": meta["epoch"], "loop": meta.get("loop"), "step": cut.state.step,
              "nonfinite_steps": cut.nonfinite_steps, "rollbacks": cut.nonfinite_rollbacks,
              "warnings": [m for t, m in logger.lines if "non-finite" in m]}
    resumed, _ = run(os.path.join(root, "cut"), (), snapshot="latest_valid")
    whole, _ = run(os.path.join(root, "whole"), ())
    record["resumed_preempted"] = resumed.preempted
    record["resumed_step"], record["whole_step"] = resumed.state.step, whole.state.step
    record["params_equal"] = all(torch.equal(a, b) for a, b in zip(
        resumed.model.state_dict().values(), whole.model.state_dict().values(), strict=True))
    record["moments_equal"] = all(
        torch.equal(sa[k], sb[k])
        for sa, sb in zip(resumed.optimizer.state.values(), whole.optimizer.state.values(), strict=True) for k in sa)
    with open(out, "w") as f:
        json.dump(record, f)
    """
)


def _sides(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1")
    env.pop("PYTHONPATH", None)
    jax_out, port_out = tmp_path / "jax" / "out.json", tmp_path / "port" / "out.json"
    jax_out.parent.mkdir()
    port_out.parent.mkdir()
    procs = [
        subprocess.Popen([sys.executable, "-c", _JAX_SIDE, str(jax_out), json.dumps(KNOBS), json.dumps([PLAN, NAN_PLAN])], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        subprocess.Popen([sys.executable, "-c", _PORT_SIDE, str(port_out), json.dumps(KNOBS), json.dumps(PLAN), str(WINDOWS)],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [log[-3000:] for log in logs]
    return json.loads(jax_out.read_text()), json.loads(port_out.read_text())


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return _sides(tmp_path_factory.mktemp("preemption"))


def test_sigterm_save_and_resume_match_jax_and_are_bit_exact(sides):
    ref, got = sides
    ref = ref["sigterm"]
    assert ref["preempted"] and got["preempted"]
    assert (got["epoch"], got["loop"], got["step"]) == (ref["epoch"], ref["loop"], ref["step"]) == (
        1, {"step_in_epoch": 5}, 15)
    assert not got["resumed_preempted"]
    assert got["resumed_step"] == got["whole_step"] == EPOCHS * 10
    assert got["params_equal"] and got["moments_equal"]


def test_restore_last_good_without_a_checkpoint_warns_and_skips_as_jax_does(sides, tmp_path):
    ref = sides[0]["nan"]
    logger = _Lines()
    plan = FaultPlan()
    for kind, epoch, step in NAN_PLAN:
        plan.add(kind, epoch=epoch, step=step)
    trainer = _Tiny(max_epoch=EPOCHS, batch_size=BATCH, save_folder=str(tmp_path), num_workers=0, device="cpu",
                    save_period=1, nan_policy="restore_last_good", chain_steps=2, log_every=2, logger=logger,
                    fault_plan=plan, rows=80)
    trainer.train()
    got = {"nonfinite_steps": trainer.nonfinite_steps, "rollbacks": trainer.nonfinite_rollbacks,
           "warnings": [m for _, m in logger.lines if "non-finite" in m], "step": trainer.state.step}
    assert got == {k: ref[k] for k in got}
    assert (got["nonfinite_steps"], got["rollbacks"], len(got["warnings"])) == (1, 0, 1)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(nn.Linear(6, 16), nn.BatchNorm1d(16), nn.ReLU(), nn.Linear(16, 3))

    def forward(self, x):
        return self.body(x)


class _Tiny(Trainer):
    """``rows`` rows of 6 features (60: 7 steps an epoch at batch 8), 3 classes."""

    def __init__(self, *args, rows=60, **kw):
        self.rows = rows
        super().__init__(*args, **kw)

    def build_train_dataset(self):
        rng = np.random.RandomState(0)
        return ArrayDataSource(image=rng.randn(self.rows, 6).astype(np.float32), label=rng.randint(0, 3, self.rows))

    def build_model(self):
        torch.manual_seed(0)
        return _Net()

    def build_criterion(self):
        def criterion(logits, batch):
            loss = F.cross_entropy(logits, batch["label"].long())
            return loss, {"ce": loss}

        return criterion

    def build_optimizer(self, schedule):
        return torch.optim.AdamW(self.model.parameters(), lr=1e-2)

    def build_scheduler(self):
        return 1e-2


class _Lines:
    def __init__(self):
        self.lines = []

    def log(self, msg, log_type="info"):
        self.lines.append((log_type, msg))


def test_restore_last_good_rolls_back_to_the_newest_checkpoint(tmp_path):
    logger = _Lines()
    trainer = _Tiny(max_epoch=2, batch_size=8, save_folder=str(tmp_path), num_workers=0, device="cpu",
                    save_period=1, nan_policy="restore_last_good", log_every=4, logger=logger,
                    fault_plan=FaultPlan().add("nan_loss", epoch=1, step=2))
    restored = []
    restore = trainer.checkpoints.restore_latest_valid

    def recorded(state):
        out = restore(state)
        restored.append((out[2], state.step, {k: v.clone() for k, v in state.model.state_dict().items()},
                         [{k: v.clone() for k, v in s.items()} for s in state.optimizer.state.values()]))
        return out

    trainer.checkpoints.restore_latest_valid = recorded
    trainer.train()
    assert trainer.nonfinite_steps == 1 and trainer.nonfinite_rollbacks == 1
    (name, step, params, moments), = restored
    assert (name, step) == ("checkpoint_epoch_1", 7)  # the state after epoch 0
    saved = torch.load(os.path.join(str(tmp_path), "weights", name, "state.pt"), weights_only=True)
    for k, v in params.items():
        assert torch.equal(v, saved["params"][k]), k
    for st, want in zip(moments, saved["opt_state"]["state"].values(), strict=True):
        for k in st:
            assert torch.equal(st[k], want[k]), k
    assert any("rolled state back to checkpoint 'checkpoint_epoch_1'" in m for _, m in logger.lines)
    assert trainer.state.step == 7 + 3  # the rest of epoch 1 after the sync point at step 4
