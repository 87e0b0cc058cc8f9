"""Asynchronous host->device feeding: overlap IQ upload with compute.

Port of ``tsl_sdr_tpu/runtime/feeder.py:33-78``. A producer thread runs the
block iterator (file or FIFO reads, widening, block cutting) and stages
each block on the card: into pinned host memory, then a ``non_blocking``
copy on a side stream, so the copy overlaps the compute of the block
before. The consumer's stream waits for each block's copy before using it.
The bounded queue holds the producer back when the device falls behind
(the reference's bounded work queue, ``multifm/demod.c:297``).

Usage::

    feeder = AsyncFeeder(block_iter, depth=3, device="cuda")
    for blk in feeder:                 # device tensors, in order
        state, out = step(state, blk)

``device_put=False`` stages the numpy blocks as they are (the producer's
host work still overlaps compute): the bit-exact tier's step uploads and
widens its own block.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

_SENTINEL = object()


class AsyncFeeder:
    """Iterate blocks staged ahead by a producer thread: device tensors
    (``device_put=True``) or the iterator's own numpy arrays."""

    def __init__(self, block_iterator, depth: int = 3, device="cuda",
                 device_put: bool = True):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        device = torch.device(device)
        on_card = device_put and device.type == "cuda"
        if on_card:
            index = (torch.cuda.current_device() if device.index is None
                     else device.index)
            device = torch.device("cuda", index)
            side = torch.cuda.Stream(device)

        def run():
            try:
                if on_card:
                    torch.cuda.set_device(device)
                for blk in block_iterator:
                    if self._stop.is_set():
                        return
                    if on_card:
                        host = torch.from_numpy(np.ascontiguousarray(blk))
                        with torch.cuda.stream(side):
                            t = host.pin_memory().to(device,
                                                     non_blocking=True)
                            ready = torch.cuda.Event()
                            ready.record(side)
                        blk = (t, ready)
                    elif device_put:
                        blk = torch.from_numpy(np.ascontiguousarray(blk))
                    self._q.put(blk)
            except Exception as e:  # noqa: BLE001 - raised in the consumer
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._on_card = on_card
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="tsl-feeder")
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            if self._on_card:
                t, ready = item
                stream = torch.cuda.current_stream(t.device)
                stream.wait_event(ready)
                # made on the side stream, used on this one: the allocator
                # must not reuse it before this stream is done with it
                t.record_stream(stream)
                item = t
            yield item

    def close(self, timeout: float = 5.0):
        """Stop the producer (it finishes the block in hand) and join it,
        draining the queue so that it is not held on a full one; a producer
        stuck in its iterator (a FIFO with no writer) is left after
        ``timeout`` seconds (a daemon thread)."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
