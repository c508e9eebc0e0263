"""Device prefetch: overlap the host's batch production and its copy to the card with the
step.

Counterpart of ``distributed_training_pytorch_tpu/data/prefetch.py::device_prefetch``
(``:101``), on the same producer/consumer machinery (``_prefetched``): a background thread
drives the host batches ``depth`` ahead, the consumer takes them in order, and a producer
exception is raised in the consumer.

On a CUDA device each batch is staged into pinned host memory and copied on a side
``torch.cuda.Stream`` with ``non_blocking=True``; an event recorded on that stream after
the copy is waited on by the consumer's current (compute) stream before the batch is
yielded, and every tensor is marked ``record_stream`` on the compute stream, so that the
caching allocator does not hand its memory back to the side stream while the step still
reads it. The producer thread sets its device before its first copy. On the CPU the
batches are yielded as tensors over the same arrays, in the same order, with no stream.

The chained form (``device_prefetch_chained``) comes with chained steps, which the port's
``Trainer`` does not have yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch

__all__ = ["device_prefetch"]


def _prefetched(items: Iterable, depth: int) -> Iterator:
    """Drive ``items`` from a background thread, ``depth`` results in the queue.

    Shutdown (normal exhaustion or an abandoned consumer): the producer's ``put`` is
    bounded and gives up once ``cancelled`` is set; the consumer sets it, drains the queue
    with ``get_nowait`` until ``Empty``, joins the thread, and drains again, because the
    producer may complete one last ``put`` between the first drain and its own check of
    ``cancelled``; a batch stranded that way would hold its device memory for the queue's
    lifetime.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: "list[BaseException]" = []
    cancelled = threading.Event()

    def producer():
        try:
            for item in items:
                while not cancelled.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if cancelled.is_set():
                    return
        except BaseException as e:  # raised in the consumer
            err.append(e)
        finally:
            while True:  # the sentinel's put must not block forever either
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    if cancelled.is_set():
                        break

    thread = threading.Thread(target=producer, daemon=True, name="device-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        cancelled.set()

        def drain():
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    return

        drain()
        thread.join(timeout=2.0)
        drain()


def _host_tensors(batch: Mapping) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def device_prefetch(batches: Iterable[Mapping], device, *, depth: int = 2) -> Iterator[dict]:
    """Yield each host batch ``{field: array}`` as ``{field: tensor on device}``, with up
    to ``depth`` batches copied ahead on a side stream (see the module docstring)."""
    device = torch.device(device)
    if device.type != "cuda":
        return _prefetched((_host_tensors(b) for b in batches), depth)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def staged():
        torch.cuda.set_device(device)  # this thread's device, before its first copy
        stream = torch.cuda.Stream(device=device)
        for batch in batches:
            pinned = {k: t.pin_memory() for k, t in _host_tensors(batch).items()}
            with torch.cuda.stream(stream):
                on_device = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
                ready = torch.cuda.Event()
                ready.record(stream)
            yield on_device, ready

    def consumed():
        items = _prefetched(staged(), depth)
        try:
            for on_device, ready in items:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(ready)
                for t in on_device.values():
                    t.record_stream(compute)
                yield on_device
        finally:
            items.close()  # an abandoned consumer stops the producer now, not at collection

    return consumed()
