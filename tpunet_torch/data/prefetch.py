"""Host->device prefetch: overlap the next batch's transfer with the
current step's compute. The port of ``tpunet/data/prefetch.py``.

A background thread pulls from the host iterator, copies each array into
pinned host memory and starts its host->device copy on a side CUDA stream,
recording an event after it; up to `size` batches wait in a bounded queue.
The consumer makes its current stream wait on the batch's event (the copy
may still be in flight, but nothing on the consumer's stream reads the
tensors before it is done) and marks the tensors as used by that stream, so
the caching allocator does not reuse their memory early. On the CPU the
arrays become tensors without copies.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from tpunet_torch import _device


def _map(item, fn):
    if isinstance(item, (tuple, list)):
        return type(item)(_map(x, fn) for x in item)
    if isinstance(item, dict):
        return {k: _map(v, fn) for k, v in item.items()}
    return fn(item)


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Wrap `iterator` (yielding numpy arrays, or tuples/lists/dicts of
    them) so batches arrive as tensors on `device` (default the GPU),
    `size` batches ahead.

    The worker thread is a daemon and stops at source exhaustion or when
    the consumer drops the generator. The size and the device are checked
    here, at the call, not at the first batch."""
    if size < 1:
        raise ValueError("size must be >= 1")
    return _prefetch(iterator, size, _device.resolve(device))


def _prefetch(iterator, size: int, dev: torch.device):
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    _full = queue.Full  # bound locally: may outlive the module at shutdown
    stop = threading.Event()

    def _put_or_abandon(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _full:
                continue
        return False

    def worker():
        try:
            if dev.type == "cuda":
                stream = torch.cuda.Stream(dev)

                def upload(x):
                    host = torch.from_numpy(np.ascontiguousarray(x))
                    return host.pin_memory().to(dev, non_blocking=True)

                for item in iterator:
                    with torch.cuda.stream(stream):
                        put = _map(item, upload)
                        ev = torch.cuda.Event()
                        ev.record(stream)
                    if not _put_or_abandon((put, ev)):
                        return
            else:
                for item in iterator:
                    put = _map(item, lambda x: torch.as_tensor(
                        np.asarray(x), device=dev))
                    if not _put_or_abandon((put, None)):
                        return
        except Exception as e:  # surface source errors to the consumer
            _put_or_abandon(e)
            return
        _put_or_abandon(_END)

    t = threading.Thread(target=worker, daemon=True,
                         name="tpunet-torch-prefetch")
    t.start()

    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            batch, ev = item
            if ev is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(ev)
                _map(batch, lambda x: x.record_stream(cur))
            yield batch
    finally:
        # Consumer closed (break / GeneratorExit / error): release the
        # worker and drop any parked batches.
        stop.set()
        try:
            while True:
                q.get_nowait()
        except BaseException:  # noqa: BLE001 — Empty normally; shutdown junk
            pass
