"""Background host feed: overlap collate and the host-to-device copy with
the device's work.

The port's copy of ``xva_trainer_tpu/data/prefetch.py``, with the
transfer of a batch to the card (``batch_to_device``). A :class:`Prefetcher` runs collate and the batch's transfer on a
worker thread with a bounded queue, so the training loop only dequeues ready
batches and launches steps. numpy copies and the transfer release the GIL,
so this overlaps even on one core.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


class Prefetcher:
    """Iterate ``source`` on a worker thread, ``transform`` each element
    (collate → the batch's transfer), and hand results to the consumer via a bounded
    queue.

    - ``depth``: max ready batches queued ahead (2-3 is enough to hide
      collate; more just burns host RAM).
    - exceptions in the worker re-raise in the consumer at the same position.
    - ``close()`` stops the worker promptly (pause/stop support); the
      iterator is single-use, like the generator it wraps.
    """

    def __init__(
        self,
        source: Iterable[Any],
        transform: Optional[Callable[[Any], Any]] = None,
        depth: int = 3,
    ):
        self._source = source
        self._transform = transform
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, obj: Any) -> bool:
        """Queue.put that honors close(); returns False when closing."""
        while not self._stop.is_set():
            try:
                self._q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(("ok", item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._put(("err", e))
            return
        self._put(_SENTINEL)

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            kind, payload = item
            if kind == "err":
                raise payload
            yield payload

    def close(self):
        """Stop the worker and drain; safe to call from the consumer loop."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch → tensors on ``device``: the transfer that
    runs in a ``Prefetcher``'s transform, so on the worker thread
    (``parallel/mesh.py::shard_batch`` takes a rank's slice first).

    ``"ids"`` (names, for the loss sorting) stays behind; int32 index arrays
    become int64. The copies start from pinned memory without blocking, on
    the device's default stream, the stream the training step runs on: the
    step queued after them waits for them, and the caching host allocator
    does not hand a pinned buffer out again before its copy has finished."""
    dev = torch.device(device)
    out = {}
    on_card = dev.type == "cuda"
    with torch.cuda.stream(torch.cuda.default_stream(dev)) if on_card else contextlib.nullcontext():
        for k, v in batch.items():
            if k == "ids":
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if on_card:
                t = t.pin_memory().to(dev, non_blocking=True)
            out[k] = t.long() if t.dtype == torch.int32 else t
    return out
