"""Micro-batch admission: requests queue, the executor drains batches.

Client threads never touch the store — :meth:`AdmissionQueue.submit`
enqueues a :class:`Request` and blocks on its event; the single batch
executor drains up to ``max_batch`` requests at a time and answers the
whole batch against one pinned epoch (see ``tier.py``).  Micro-batching
is what buys concurrency-8 its throughput: one lock acquisition, one
epoch pin, and one shared-plan group execution amortise over the whole
batch, and exact-duplicate queries (Zipf streams repeat themselves) are
answered once per batch.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["AdmissionQueue", "Request"]


class Request:
    """One admitted query: text + completion event + result slots."""

    __slots__ = (
        "text", "t_submit", "admit_version", "event",
        "response", "error",
    )

    def __init__(self, text: str, admit_version: int):
        self.text = text
        self.t_submit = time.perf_counter()
        #: registry version current at admission — a response computed
        #: at an older version is a stale read (must never happen)
        self.admit_version = admit_version
        self.event = threading.Event()
        self.response = None
        self.error: BaseException | None = None

    def resolve(self, response) -> None:
        self.response = response
        self.event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()

    def wait(self, timeout: float | None = None):
        if not self.event.wait(timeout):
            raise TimeoutError(f"query not answered in {timeout}s")
        if self.error is not None:
            raise self.error
        return self.response


class AdmissionQueue:
    """Unbounded FIFO with condition-variable batch draining."""

    def __init__(self):
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._items: deque[Request] = deque()
        self._closed = False
        self.max_depth = 0

    def submit(self, req: Request) -> None:
        with self._not_empty:
            if self._closed:
                raise RuntimeError("admission queue closed")
            self._items.append(req)
            self.max_depth = max(self.max_depth, len(self._items))
            self._not_empty.notify()

    def drain(self, max_batch: int, timeout: float = 0.05) -> list[Request]:
        """Up to ``max_batch`` queued requests; blocks until at least one
        arrives, the timeout elapses (empty list), or the queue closes."""
        with self._not_empty:
            if not self._items and not self._closed:
                self._not_empty.wait(timeout)
            batch = []
            while self._items and len(batch) < max_batch:
                batch.append(self._items.popleft())
            return batch

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def close(self) -> None:
        """Reject new submissions and wake the executor."""
        with self._not_empty:
            self._closed = True
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed
