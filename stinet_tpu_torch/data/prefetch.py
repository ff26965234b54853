"""Background-thread batch prefetch: host-side batch assembly (disk reads,
numpy padding, graph concatenation) overlaps the device's work.

A copy of `stinet_tpu/data/prefetch.py`. The reference gets this from
torch DataLoader worker processes; here one daemon thread does it, since
the build is numpy-bound and releases the GIL in its large copies. A
bounded queue applies backpressure, so at most `buffer_size` prepared
batches are held. An exception raised by the producer is raised again in
the consumer at `next()`, and `close()` cancels the producer.
"""
import queue
import threading


class _Sentinel:
    pass


_DONE = _Sentinel()


class PrefetchIterator:
    """Wrap an iterator; pull items eagerly on a daemon thread into a
    bounded queue."""

    def __init__(self, it, buffer_size: int = 2):
        self._q = queue.Queue(maxsize=max(1, buffer_size))
        self._err = None
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, args=(it,), daemon=True)
        self._thread.start()

    def _run(self, it):
        try:
            for item in it:
                # timeout-put instead of a blocking put so close() can
                # cancel a producer parked on a full queue (an abandoned
                # epoch iterator would otherwise pin the buffered items,
                # device tensors when the producer places batches, for
                # the process lifetime)
                while not self._stop:
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop:
                    return
        except BaseException as e:  # re-raised at the consumer's next()
            self._err = e
        finally:
            # _DONE must reach the consumer even when the queue is full
            # (buffer filled faster than it drains): block with the same
            # stop-aware polling as above; a dropped sentinel leaves the
            # consumer waiting in q.get() forever
            while not self._stop:
                try:
                    self._q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self):
        """Cancel the producer and release everything buffered; a consumer
        blocked in `next()` then ends its iteration. Safe to call multiple
        times and after exhaustion."""
        self._stop = True
        # a producer mid-put may still land one item after the drain, so
        # drain until the end marker fits
        while True:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(_DONE)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item
