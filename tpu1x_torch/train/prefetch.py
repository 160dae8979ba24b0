"""Background batch prefetch: the host's gather and the copy to the card off
the training loop's path (tpu1x/train/prefetch.py's counterpart).

A thread stays `depth` batches ahead: it takes each batch from the loader
(the memmap gather), pins it, and copies it to the card on a side CUDA
stream, recording an event after the copy. The consumer's stream waits on
that event before the batch is used, and each tensor is marked as used on
the consumer's stream (`record_stream`), so that the caching allocator does
not hand its memory to the side stream while the step still reads it. An
error in the thread is raised on the consumer's side when it reaches that
batch. On the CPU it is the same thread without streams.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

_END = object()


class DevicePrefetcher:
    """Wrap an iterator of {"tokens": np, ["actions": np]} batches (this
    rank's rows); yields (tokens, actions or None) as int64 tensors on
    `device`. Use it as a context manager, or call `close`, when the loop
    may stop before the iterator ends."""

    def __init__(self, batches: Iterator[dict], device, depth: int = 2):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self._cuda else None)
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, args=(batches,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
        if not self._cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _worker(self, batches):
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            for batch in batches:
                if self._stop.is_set():
                    return
                event = None
                with (torch.cuda.stream(self._stream) if self._cuda
                      else contextlib.nullcontext()):
                    tokens = self._to_device(batch["tokens"])
                    actions = (self._to_device(batch["actions"])
                               if "actions" in batch else None)
                    if self._cuda:
                        event = torch.cuda.Event()
                        event.record(self._stream)
                if not self._put((tokens, actions, event)):
                    return
        except Exception as e:  # surfaced on the consumer side
            self._error = e
        finally:
            self._put(_END)

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is _END:
                if self._error is not None:
                    raise self._error
                return
            tokens, actions, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for t in (tokens, actions):
                    if t is not None:
                        t.record_stream(consumer)
            yield tokens, actions

    def close(self) -> None:
        """Stop the thread and wait for it."""
        self._stop.set()
        self._thread.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

