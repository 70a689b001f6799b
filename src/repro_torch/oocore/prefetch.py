"""Double-buffered upload of super-shards onto the card (the JAX package's
``oocore/prefetch.py``, rebuilt on CUDA streams).

The drive loop ``take(i)``s the super-shard it is about to compute on and
immediately ``request(j)``s the next one, so the next copy runs while the
current group computes.  The JAX package does this with one worker thread
calling ``device_put``; here the copy engine does it with no thread:

* the daemon pins each cold group's host fields once at bind time, so an
  upload is a set of ``non_blocking`` host→device copies;
* the copies land in one of two **slots**, device buffers shaped like a
  group, allocated (with no copy) when the uploader is made and
  overwritten by every upload, so the device holds at most two cold
  groups whatever the host queues (the groups are padded to one shape).
  No allocation happens while a span is timed: an allocation on the card
  can block the host until queued work ends, which would make a stall
  read as no wait;
* ``request`` starts a copy on one side ``torch.cuda.Stream`` into the
  slot that is not being read, after the side stream waits
  (``wait_event``) on the event ``release`` recorded on the compute stream
  after the slot's last reader — the host never waits;
* ``take`` makes the compute stream wait on the copy's end event.

Two numbers split the copy's cost, as in the JAX package:

* **transfer seconds** — the copy itself, between its two events (begun
  after the side stream's wait for the slot);
* **wait seconds** — how long the compute stream stalled on it: from an
  event recorded on the compute stream just before ``wait_event`` to the
  copy's end event, or 0 when the copy had already ended.

Both are :class:`Span` objects read with ``seconds()`` after the
iteration's one fetch, which the compute stream reaches only after every
copy it waited on: reading them makes no sync of its own.  A copy that
``take`` drops (a wrap-around guess the frontier then skipped) still ran:
its span is kept for the caller to count (:meth:`AsyncUploader.pop_stale`),
so a wait that sat behind it is matched by a transfer.  Without prefetch
the copy runs on the compute stream and the two spans are the same
object, so ``wait == transfer`` and the overlap is exactly 0.  On the CPU
the "copy" is synchronous (``take`` wraps the host arrays) and the same
interface holds, with host clock readings in the spans.

``overlap_efficiency = 1 - wait/transfer``: 1.0 means every byte moved
behind compute, 0.0 that the loop stalled for the whole copy.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch


class Span:
    """Seconds between two points: two CUDA timing events (read once the
    stream that waits on them has passed both), or two host clock readings.
    A negative span (the second point came first) reads 0."""

    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start = start
        self.end = end

    def seconds(self) -> float:
        if isinstance(self.start, float):
            return max(0.0, self.end - self.start)
        return max(0.0, self.start.elapsed_time(self.end)) / 1e3


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _event():
    return torch.cuda.Event(enable_timing=True)


class AsyncUploader:
    """Double-buffered prefetcher over ``upload_fn(index, out=None,
    copy=True) -> device dict``.

    ``upload_fn`` makes its copies on the current stream (``non_blocking``
    from pinned memory on the card): into fresh device tensors when ``out``
    is None, else into ``out`` — a dict it returned before — which it
    returns; with ``copy=False`` it only allocates fresh device tensors
    shaped like group ``index``.  On the card every upload goes into one
    of two slots (one without ``prefetch``), allocated here; with
    ``prefetch``,
    :meth:`request` runs it on the side stream (``stream``, or one of its
    own), otherwise :meth:`take` runs it on the compute stream into the
    slot.  On the CPU ``upload_fn(index)`` is called with no ``out``.

    At most two cold groups are live: the one being computed (taken, until
    :meth:`release`) and the next one in flight.  A pending upload that
    ``take`` does not ask for is dropped there, freeing its slot.
    ``max_live_groups`` is the most that were live at once,
    ``slot_allocations`` how many slots were allocated (≤ 2) and
    ``slot_bytes`` their device bytes.
    """

    def __init__(self, upload_fn: Callable[..., Any], device,
                 prefetch: bool = True, stream=None):
        self._upload = upload_fn
        self.device = torch.device(device)
        self.prefetch = bool(prefetch)
        self._cuda = self.device.type == "cuda"
        self._side = None
        if self._cuda and self.prefetch:
            self._side = (stream if stream is not None
                          else torch.cuda.Stream(device=self.device))
        self._slots: list = [None, None]
        self._free: list = [None, None]  # compute event after its last read
        self._pending: dict[int, tuple] = {}  # index → (slot, tree, start, end)
        self._taken: dict[int, Any] = {}      # index → slot
        self._stale: list[Span] = []
        self.max_live_groups = 0
        self.slot_allocations = 0
        self.slot_bytes = 0
        if self._cuda:
            self._bind_slots()

    def _bind_slots(self) -> None:
        """Allocates the slots, copying nothing, before any span is timed,
        on the stream whose copies fill them."""
        stream = (self._side if self._side is not None
                  else torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            slots = [self._upload(0, copy=False)
                     for _ in range(2 if self._side is not None else 1)]
        self._slots[:len(slots)] = slots
        self.slot_allocations = len(slots)
        self.slot_bytes = sum(t.numel() * t.element_size()
                              for tree in slots for t in _leaves(tree))

    def _count_live(self) -> None:
        self.max_live_groups = max(self.max_live_groups,
                                   len(self._pending) + len(self._taken))

    def _claim(self) -> int:
        used = ({p[0] for p in self._pending.values()}
                | set(self._taken.values()))
        for k in (0, 1):
            if k not in used:
                return k
        raise RuntimeError("AsyncUploader: both slots are live; release "
                           "the taken group before requesting another")

    def _fill(self, k: int, index: int):
        """Uploads group ``index`` into slot ``k`` on the current stream."""
        return self._upload(index, out=self._slots[k])

    def request(self, index: int) -> None:
        """Starts uploading super-shard ``index`` on the side stream, if it
        is not already in flight.  Without a side stream (no prefetch, or
        the CPU) the upload waits for :meth:`take`."""
        if self._side is None or index in self._pending:
            return
        k = self._claim()
        with torch.cuda.stream(self._side):
            if self._free[k] is not None:
                # the slot's last reader has been queued on the compute
                # stream; the copy overwrites it only once that has run
                self._side.wait_event(self._free[k])
            start, end = _event(), _event()
            start.record()
            tree = self._fill(k, index)
            end.record()
        self._pending[index] = (k, tree, start, end)
        self._count_live()

    def take(self, index: int) -> tuple[Any, Span, Span]:
        """Super-shard ``index`` on the device, ready for the compute
        stream's next launch → ``(device dict, transfer Span, wait
        Span)``.  A group not in flight is requested here; without a side
        stream it is uploaded here on the compute stream, and its wait is
        its whole transfer."""
        for other in [i for i in self._pending if i != index]:
            _, _, start, end = self._pending.pop(other)
            self._stale.append(Span(start, end))  # copied, then not needed
        if self._side is not None:
            self.request(index)
            k, tree, start, end = self._pending.pop(index)
            compute = torch.cuda.current_stream(self.device)
            reach = _event()
            reach.record(compute)
            compute.wait_event(end)
            self._taken[index] = k
            self._count_live()
            return tree, Span(start, end), Span(reach, end)
        if self._cuda:
            # on the compute stream: its earlier readers of the slot are
            # ahead of the copy in the same stream
            k = self._claim()
            start, end = _event(), _event()
            start.record()
            tree = self._fill(k, index)
            end.record()
        else:
            k = None
            start = time.perf_counter()
            tree = self._upload(index)
            end = time.perf_counter()
        span = Span(start, end)
        self._taken[index] = k
        self._count_live()
        return tree, span, span

    def release(self, index: int) -> None:
        """The loop has queued its last read of taken group ``index``: its
        slot may be overwritten once the compute stream has passed here."""
        k = self._taken.pop(index)
        if self._cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._free[k] = done

    def pop_stale(self) -> list[Span]:
        """The spans of the copies dropped since the last call."""
        out, self._stale = self._stale, []
        return out

    def close(self) -> None:
        """Drops the slots.  Their memory goes back to the allocator only
        once the compute stream has passed its queued reads of them."""
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            for slot in self._slots:
                for t in _leaves(slot) if slot is not None else ():
                    t.record_stream(compute)
        self._slots = [None, None]
        self._free = [None, None]
        self._pending.clear()
        self._taken.clear()
        self._stale = []
