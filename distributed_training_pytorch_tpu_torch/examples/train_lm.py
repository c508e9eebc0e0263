"""Causal-LM training entry of the port.

Counterpart of the repository's ``examples/train_lm.py``: byte-level windows of a corpus
file (``LM_CORPUS``) or, without one, a synthetic structured byte stream, trained through
the port's ``Trainer`` with the fused tied-embedding loss, AdamW and a warmup-cosine
schedule. Run:

    python -m distributed_training_pytorch_tpu_torch.examples.train_lm

Env knobs, as the JAX entry reads them: ``LM_CORPUS``, ``SEQ_LEN`` (256), ``EPOCHS``
(10), ``BATCH`` (256, global), ``BASE_LR`` (3e-4), ``MOE_EVERY`` (0; above 0 raises until
the expert-parallel slice), ``SAVE_DIR`` (``./runs/lm``), ``SNAPSHOT``, ``LM_SIZE``
(``tiny`` | ``small`` = GPT-2-small), ``SAVE_PERIOD`` / ``LAST_SAVE_PERIOD`` (1),
``DTYPE`` (``fp32`` | ``bf16``; unset keeps bf16 model compute under the f32 policy),
``PALLAS`` (1 | 0 | unset = auto), ``FUSED_CE`` (1; 0 = the plain logits criterion),
``CHAIN_STEPS`` (1), ``MESH`` (the mesh grammar of ``parallel/mesh.py``: ``dpN``,
``spN``, ``dpNspM``, ``spNxM``; ``fsdp``/``tp``/``pp``/``ep`` raise until their slices)
and ``TELEMETRY``/``PROFILE_DIR`` (unset; both raise until their slices). The port adds
``DEVICE`` (``cuda`` unless set to ``cpu``). Under ``torchrun`` each process is one rank
of the mesh. As in the JAX entry, the model's attention does not switch to ring with a
seq axis: a subclass's ``build_model`` asks for ``attention_impl="ring"``,
``mesh=self.mesh``, as :class:`RingLMTrainer` does (``build_trainer(trainer_cls=
RingLMTrainer)`` with ``MESH=spN``; no knob selects it).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
from distributed_training_pytorch_tpu_torch.models import GPTSmall, LMTiny
from distributed_training_pytorch_tpu_torch.ops.dispatch import pallas_from_env
from distributed_training_pytorch_tpu_torch.ops.schedules import warmup_cosine_lr
from distributed_training_pytorch_tpu_torch.parallel.mesh import mesh_from_env
from distributed_training_pytorch_tpu_torch.precision import model_dtype_for_entry
from distributed_training_pytorch_tpu_torch.trainer import Trainer
from distributed_training_pytorch_tpu_torch.utils import Logger

__all__ = ["LMTrainer", "build_trainer", "load_windows", "main"]


def load_windows(seq_len: int, path: "str | None" = None) -> np.ndarray:
    """``[N, seq_len + 1]`` int32 byte windows (input = ``[:-1]``, target = ``[1:]``);
    ``path`` overrides the ``LM_CORPUS`` env. The synthetic stream without a corpus is the
    JAX entry's, byte for byte."""
    path = path if path is not None else os.environ.get("LM_CORPUS")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"LM_CORPUS={path!r} does not exist")
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
    else:
        print("WARNING: LM_CORPUS unset — synthetic structured byte stream")
        rng = np.random.RandomState(0)
        motifs = [rng.randint(0, 255, size=(m,)) for m in (5, 9, 13)]
        parts = [motifs[rng.randint(3)] for _ in range(60000)]
        data = np.concatenate(parts).astype(np.uint8)
    if len(data) < seq_len + 1:
        raise ValueError(
            f"corpus has {len(data)} bytes — too short for SEQ_LEN={seq_len} (need at least seq_len + 1)"
        )
    windows = np.lib.stride_tricks.sliding_window_view(data, seq_len + 1)[::seq_len]
    return windows.astype(np.int32)


class LMTrainer(Trainer):
    """Tokens ride the loader's ``image`` slot; targets are the shifted window."""

    # the criterion and the fused loss weight padded validation rows out
    criterion_uses_mask = True

    def __init__(self, seq_len: int, base_lr: float, size: str, moe_every: int, **kw):
        self.seq_len = seq_len
        self.base_lr = base_lr
        self.size = size
        self.moe_every = moe_every
        self.windows = load_windows(seq_len)
        self.dtype_env = os.environ.get("DTYPE") or None
        self.pallas = pallas_from_env()
        self.fused_ce = os.environ.get("FUSED_CE", "1") != "0"
        kw.setdefault("precision", self.dtype_env)
        super().__init__(**kw)

    def build_train_dataset(self):
        w = self.windows[: int(len(self.windows) * 0.95)]
        return ArrayDataSource(image=w[:, :-1], label=w[:, 1:])

    def build_val_dataset(self):
        w = self.windows[int(len(self.windows) * 0.95) :]
        return ArrayDataSource(image=w[:, :-1], label=w[:, 1:])

    def build_model(self):
        factory = {"tiny": LMTiny, "small": GPTSmall}[self.size]
        explicit = self.dtype_env is not None or self.precision_requested
        return factory(
            vocab_size=256,
            dtype=model_dtype_for_entry(self.precision, explicit, torch.bfloat16),
            moe_every=self.moe_every,
            max_len=max(self.seq_len, 128),
            pallas=self.pallas,
            device=self.device,
        )

    def build_criterion(self):
        def criterion(logits, batch):
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.gather(logp, -1, batch["label"].long()[..., None])[..., 0]
            per_example = nll.mean(dim=-1)
            mask = batch.get("mask")
            if mask is None:
                loss = per_example.mean()
            else:
                loss = (per_example * mask).sum() / torch.clamp(mask.sum(), min=1.0)
            return loss, {"nll": loss, "ppl": torch.exp(loss)}

        return criterion

    def build_loss_fn(self):
        """The fused tied-embedding CE by default (``FUSED_CE=0``: the criterion on full
        f32 logits)."""
        if not self.fused_ce:
            return super().build_loss_fn()
        from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss

        return make_fused_lm_loss(self.model)

    def build_scheduler(self):
        steps_per_epoch = max(1, len(self.train_dataset) // self.batch_size)
        return warmup_cosine_lr(self.base_lr, self.max_epoch, steps_per_epoch, warmup_epochs=1)

    def build_optimizer(self, schedule):
        """``optax.adamw(schedule, weight_decay=0.1, b1=0.9, b2=0.95)``: one parameter group,
        decay on every parameter, eps 1e-8; the engine sets the lr from the schedule."""
        return torch.optim.AdamW(
            self.model.parameters(), lr=float(schedule(0)), betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1
        )


class RingLMTrainer(LMTrainer):
    """The entry's trainer with causal ring attention over the mesh's seq axis: how a
    user's subclass reaches the ring. ``PALLAS`` is not read, since its precedence would
    turn the ring into flash or plain attention."""

    def build_model(self):
        factory = {"tiny": LMTiny, "small": GPTSmall}[self.size]
        explicit = self.dtype_env is not None or self.precision_requested
        return factory(
            vocab_size=256,
            dtype=model_dtype_for_entry(self.precision, explicit, torch.bfloat16),
            moe_every=self.moe_every,
            max_len=max(self.seq_len, 128),
            attention_impl="ring",
            mesh=self.mesh,
            device=self.device,
        )


def build_trainer(device: "str | None" = None, trainer_cls: type = LMTrainer) -> LMTrainer:
    """The entry's trainer, configured from the env knobs; ``trainer_cls`` is
    :class:`LMTrainer` or a subclass with other hooks (for example a ``build_model`` with
    ring attention over the mesh's seq axis)."""
    for knob in ("TELEMETRY", "PROFILE_DIR"):
        if os.environ.get(knob):
            raise NotImplementedError(f"{knob} comes with the observability slice of the port")
    save_dir = os.environ.get("SAVE_DIR", "./runs/lm")
    kw = dict(
        seq_len=int(os.environ.get("SEQ_LEN", "256")),
        base_lr=float(os.environ.get("BASE_LR", "3e-4")),
        size=os.environ.get("LM_SIZE", "small"),
        moe_every=int(os.environ.get("MOE_EVERY", "0")),
        max_epoch=int(os.environ.get("EPOCHS", "10")),
        batch_size=int(os.environ.get("BATCH", "256")),
        chain_steps=int(os.environ.get("CHAIN_STEPS", "1")),
        mesh=mesh_from_env(),
        have_validate=True,
        save_best_for=("nll", "leq"),
        save_period=int(os.environ.get("SAVE_PERIOD", "1")),
        last_save_period=int(os.environ.get("LAST_SAVE_PERIOD", "1")),
        save_folder=save_dir,
        snapshot_path=os.environ.get("SNAPSHOT") or None,
        logger=Logger("lm", os.path.join(save_dir, "logfile.log")),
        device=device or os.environ.get("DEVICE", "cuda"),
    )
    return trainer_cls(**kw)


def main(device: "str | None" = None) -> LMTrainer:
    """Join the process group (under torchrun), train, leave it."""
    Trainer.distributed_setup()
    trainer = build_trainer(device)
    trainer.train()
    Trainer.destroy_process()
    return trainer


if __name__ == "__main__":
    main()
