"""Spans of the port's own work, on the clock of the device trace.

`span(name)` records (name, start, end, parent, thread) of the block it
wraps.  Times are `time.time_ns()`, nanoseconds since the Unix epoch: the
clock the profiler's device records are given in, so a span and the
device work inside it lie on one time line.  `parent` is the index of the
enclosing open span on the same thread (None at the top).  Spans are kept
in memory, in a ring of the last `RING` closed spans: `rows()` returns
them oldest first, `clear()` empties the ring, nothing is written to
disk.  The recorder is always on.

The recorder never synchronizes the device.  A span that ends on device
work ends where the host waits for that work anyway: a `.item()` or
`int()` of a device value, a `.cpu()`, or a blocking copy from pageable
memory.  The one exception is a `torch.cuda.synchronize()` placed
immediately before a blocking `.cpu()` that would wait for the same work.

Budget: a span costs a few microseconds, so a path takes at most one span
per native call, per doubling round or per copy, and none per read or per
kernel.  A span is added with the metric, test or program code that
reads it.
"""

import collections
import contextlib
import itertools
import threading
import time

RING = 65536


class Span:
    """One span: `end_ns` is None while it is open."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "thread")

    def __init__(self, index, name, parent, thread):
        self.index, self.name, self.parent = index, name, parent
        self.thread = thread
        self.start_ns = self.end_ns = None

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self):
        return (f"Span({self.index}, {self.name!r}, {self.start_ns}, "
                f"{self.end_ns}, parent={self.parent})")


class Recorder:
    """Closed spans in a ring of `maxlen`, open ones on a stack a thread."""

    def __init__(self, maxlen=RING):
        self._ring = collections.deque(maxlen=maxlen)
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    @contextlib.contextmanager
    def span(self, name):
        stack = self._stack()
        s = Span(next(self._ids), name, stack[-1].index if stack else None,
                 threading.get_ident())
        stack.append(s)
        s.start_ns = time.time_ns()
        try:
            yield s
        finally:
            s.end_ns = time.time_ns()
            stack.pop()
            self._ring.append(s)

    def rows(self):
        return list(self._ring)

    def clear(self):
        self._ring.clear()


_recorder = Recorder()
span, rows, clear = _recorder.span, _recorder.rows, _recorder.clear
