"""Serving: continuous-batching inference on one card.

* :mod:`.batcher` — request admission: bucketized micro-batches, deadline flush,
  per-tenant fairness, typed overload rejection. Pure Python.
* :mod:`.engine`  — :class:`~.engine.InferEngine`: the forward on the card, padded to a
  bucket, with an atomic params swap.
* :mod:`.server`  — :class:`~.server.InferenceServer`: ``/predict``, ``/status`` and
  ``/metrics`` over HTTP, with the flight-recorder events.
* :mod:`.client`  — :class:`~.client.RetryClient`: retries honouring ``Retry-After``.

Importing this package imports no torch; the engine, server and client load on first use.
"""

from distributed_training_pytorch_tpu_torch.serving.batcher import (  # noqa: F401
    MicroBatch,
    MicroBatcher,
    OverloadRejected,
    Request,
    pick_bucket,
)

_LAZY = {
    "InferEngine": "distributed_training_pytorch_tpu_torch.serving.engine",
    "InferenceServer": "distributed_training_pytorch_tpu_torch.serving.server",
    "LatencyWindow": "distributed_training_pytorch_tpu_torch.serving.server",
    "RetriesExhausted": "distributed_training_pytorch_tpu_torch.serving.client",
    "RetryClient": "distributed_training_pytorch_tpu_torch.serving.client",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "InferEngine",
    "InferenceServer",
    "LatencyWindow",
    "MicroBatch",
    "MicroBatcher",
    "OverloadRejected",
    "Request",
    "RetriesExhausted",
    "RetryClient",
    "pick_bucket",
]
