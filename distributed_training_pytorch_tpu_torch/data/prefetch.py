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

``device_prefetch_chained`` (``data/prefetch.py:115``) yields execution units ``(n,
batch)`` for chained steps: ``n == chain_steps`` with the window's batches stacked on a
new leading axis (one pinned host tensor a field, one copy on the side stream, one event
the compute stream waits on), or ``n == 1`` with a plain batch, for the first
``lead_singles`` batches (a mid-epoch resume realigned to a window boundary) and the
epoch's tail shorter than a window. The engine copies a window into its CUDA graph's
static inputs on the compute stream, after the replay that last read them: a copy into
them on the side stream could land while that replay still reads them.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch

__all__ = ["device_prefetch", "device_prefetch_chained"]


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
    units = _staged_units(((1, _host_tensors(b)) for b in batches), device, depth)

    def singles():
        try:
            for _, batch in units:
                yield batch
        finally:
            units.close()

    return singles()


def device_prefetch_chained(
    batches: Iterable[Mapping], device, chain_steps: int, *, depth: int = 2, lead_singles: int = 0
) -> Iterator["tuple[int, dict]"]:
    """Yield ``(n, batch)`` execution units for chained steps (see the module docstring):
    the first ``lead_singles`` batches and a short tail as ``(1, batch)``, every full
    window of ``chain_steps`` batches as ``(chain_steps, stacked)``, each field
    ``[chain_steps, ...]``. ``chain_steps == 1`` yields singles only."""
    if chain_steps < 1:
        raise ValueError(f"chain_steps must be >= 1, got {chain_steps}")

    def host_units():
        it = iter(batches)
        for host_batch in itertools.islice(it, max(0, int(lead_singles))):
            yield 1, _host_tensors(host_batch)
        while True:
            window = [_host_tensors(b) for b in itertools.islice(it, chain_steps)]
            if not window:
                return
            if len(window) < chain_steps or chain_steps == 1:
                for host_batch in window:
                    yield 1, host_batch
                if len(window) < chain_steps:
                    return
                continue
            yield chain_steps, {k: torch.stack([b[k] for b in window]) for k in window[0]}

    return _staged_units(host_units(), device, depth)


def _staged_units(units, device, depth: int) -> Iterator["tuple[int, dict]"]:
    """``(n, host tensors)`` units as ``(n, device tensors)``, ``depth`` ahead: on the
    card through pinned memory, a side stream and an event the compute stream waits on."""
    device = torch.device(device)
    if device.type != "cuda":
        return _prefetched(units, depth)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def staged():
        torch.cuda.set_device(device)  # this thread's device, before its first copy
        stream = torch.cuda.Stream(device=device)
        for n, batch in units:
            pinned = {k: t.pin_memory() for k, t in batch.items()}
            with torch.cuda.stream(stream):
                on_device = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
                ready = torch.cuda.Event()
                ready.record(stream)
            yield n, on_device, ready

    def consumed():
        items = _prefetched(staged(), depth)
        try:
            for n, on_device, ready in items:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(ready)
                for t in on_device.values():
                    t.record_stream(compute)
                yield n, on_device
        finally:
            items.close()  # an abandoned consumer stops the producer now, not at collection

    return consumed()
