"""Micro-batching for serving: concurrent requests share one device call
(counterpart of awm_tpu/batching.py).

One consumer thread drains a queue of per-request chunk arrays, concatenates
those of one op (embed or detect) into one batch, runs the session's bucketed
call once and hands each request its rows back:

- throughput: one (N_total, L) call instead of K small ones;
- device discipline: only the consumer thread touches the card, so the
  process-wide TF32 switch of the fp32 session (utils/precision.py) and the
  card itself see one caller; HTTP threads only decode and encode WAVs;
- bounded latency: a request waits at most ``max_wait_ms`` for co-riders.

``MicroBatcher`` has the ``embed_chunks`` / ``detect_summary`` signatures of
``InferenceSession``; ``BatchedSession`` is a proxy that routes exactly those
two through it, so ``watermark_array`` / ``detect_array`` / ``verify_array``
run unchanged on top of it.  A failure of the device call is set on every
request of its batch.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np


class _Item:
    __slots__ = ("op", "arrays", "future")

    def __init__(self, op: str, arrays: Tuple[np.ndarray, ...]):
        self.op = op
        self.arrays = arrays
        self.future: Future = Future()


class MicroBatcher:
    """Single-consumer micro-batching front of an InferenceSession.

    max_batch: chunk budget per device call (a request above it still runs,
    alone).  max_wait_ms: how long the first request of a window waits for
    co-riders before the batch is dispatched.  stats: requests, device
    batches, chunks through them, and device_s, the wall seconds of the
    session calls (each ends with its results on the host)."""

    def __init__(self, session, *, max_batch: int = 256, max_wait_ms: float = 5.0):
        self.session = session
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.stats = {"requests": 0, "device_batches": 0, "batched_chunks": 0, "device_s": 0.0}
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True, name="awm-device")
        self._worker.start()

    # -- session-compatible surface -----------------------------------------

    def embed_chunks(self, chunks: np.ndarray, messages: np.ndarray) -> np.ndarray:
        return self._submit("embed", (np.asarray(chunks), np.asarray(messages)))

    def detect_summary(self, chunks: np.ndarray, lengths: Optional[np.ndarray] = None):
        chunks = np.asarray(chunks)
        if lengths is None:
            lengths = np.full(chunks.shape[0], chunks.shape[1], np.int64)
        return self._submit("detect", (chunks, np.asarray(lengths, np.int64)))

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(timeout=5.0)

    # -- internals -----------------------------------------------------------

    def _submit(self, op: str, arrays):
        item = _Item(op, arrays)
        with self._lock:
            self.stats["requests"] += 1
        self._q.put(item)
        return item.future.result()

    def _collect(self) -> List[_Item]:
        """Block for the first item, then gather same-op co-riders until the
        chunk budget or the wait window is spent; an item of the other op
        goes back on the queue for the next window."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        total = first.arrays[0].shape[0]
        deadline = time.monotonic() + self.max_wait
        spill = None
        while total < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post shutdown for the outer loop
                break
            if nxt.op != first.op:
                spill = nxt
                break
            batch.append(nxt)
            total += nxt.arrays[0].shape[0]
        if spill is not None:
            self._q.put(spill)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                return
            try:
                self._dispatch(batch)
            except Exception as e:  # every waiting request gets the failure
                for it in batch:
                    if not it.future.done():
                        it.future.set_exception(e)

    def _dispatch(self, batch: List[_Item]) -> None:
        sizes = [it.arrays[0].shape[0] for it in batch]
        bounds = np.cumsum([0] + sizes)
        with self._lock:
            self.stats["device_batches"] += 1
            self.stats["batched_chunks"] += int(bounds[-1])
        first, second = (np.concatenate([it.arrays[k] for it in batch]) for k in (0, 1))
        t0 = time.perf_counter()
        if batch[0].op == "embed":
            out = self.session.embed_chunks(first, second)
            rows = lambda lo, hi: out[lo:hi]
        else:
            out = self.session.detect_summary(first, second)
            rows = lambda lo, hi: tuple(o[lo:hi] for o in out)
        with self._lock:
            self.stats["device_s"] += time.perf_counter() - t0
        for it, lo, hi in zip(batch, bounds, bounds[1:]):
            it.future.set_result(rows(lo, hi))


class BatchedSession:
    """An InferenceSession whose embed_chunks and detect_summary go through
    a MicroBatcher.  Its other attributes (message_bits, sample_rate,
    chunk_len, ...) read through to the session; its other methods are
    refused, since they would run on the caller's thread and not the
    batcher's."""

    def __init__(self, session, *, max_batch: int = 256, max_wait_ms: float = 5.0):
        self._session = session
        self.batcher = MicroBatcher(session, max_batch=max_batch, max_wait_ms=max_wait_ms)

    def embed_chunks(self, chunks, messages):
        return self.batcher.embed_chunks(chunks, messages)

    def detect_summary(self, chunks, lengths=None):
        return self.batcher.detect_summary(chunks, lengths)

    def close(self):
        self.batcher.close()

    def __getattr__(self, name):
        value = getattr(self._session, name)
        if callable(value):
            raise AttributeError(
                f"BatchedSession routes only embed_chunks and detect_summary to the device "
                f"thread; {name} would run on the caller's")
        return value
