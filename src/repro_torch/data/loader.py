"""Device-feeding data loader with background prefetch.

The port of ``repro.data.loader``. Wraps a stateless corpus
(``batch_at(step)``) with a double-buffered prefetch thread so host data
generation overlaps device compute. Restart semantics stay trivial: the
loader's only state is the step counter, which the training checkpoint
already stores.

Where the reference places a batch with ``jax.device_put`` onto its
sharding, the port copies each numpy array to the loader's ``device``:
through pinned host memory and ``non_blocking`` on a card, so the copy
overlaps the work already queued there; as it is on the CPU. Without a
device the batch stays numpy, as the reference's does without a
sharding.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on `device`: on a card through
    pinned host memory, ``non_blocking``."""
    device = torch.device(device)
    out = {}
    for key, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[key] = t
    return out


class PrefetchLoader:
    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 prefetch: int = 2, device=None):
        self._batch_fn = batch_fn
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put_device(self, batch: dict):
        if self._device is None:
            return batch
        return to_device(batch, self._device)

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._batch_fn(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, self._put_device(batch)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
