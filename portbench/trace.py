"""Spans of the benchmark's own code, and what the profiler's device trace
says about the window: busy time, time by operation, idle gaps.

Spans and the trace share one clock: the profiler gives its device
records in nanoseconds since the Unix epoch, and spans are taken with
time.time_ns().
"""

import contextlib
import time

import torch

K1_KERNELS = ("rank6_fused", "rank_block_counts")


class Spans:
    """(name, start ns, end ns, depth) of the benchmark's calls into the
    program, kept in memory."""

    def __init__(self):
        self.rows = []
        self._depth = 0

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.time_ns()
        self._depth += 1
        depth = self._depth
        try:
            yield
        finally:
            self._depth -= 1
            self.rows.append((name, t0, time.time_ns(), depth))

    def add(self, name, t0, t1, depth):
        self.rows.append((name, int(t0), int(t1), depth))


def start():
    """A running profiler of the device's activity alone."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def device_records(prof):
    """(name, start ns, duration ns) of every device record of a stopped
    profiler, read from its raw results (parsing them into function events
    takes minutes at a window's size)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _merged(recs, lo, hi):
    """The union of the records' intervals, clipped to [lo, hi], sorted."""
    iv = sorted((max(s, lo), min(s + d, hi)) for _, s, d in recs
                if s + d > lo and s < hi)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _labeller(spans):
    """A function from a time to the path of names of the spans around it
    (innermost last), by bisection over the spans' boundaries."""
    import bisect

    cuts = sorted({t for s in spans for t in s[1:3]})
    labels = []
    for a in cuts:
        around = sorted((s for s in spans if s[1] <= a < s[2]),
                        key=lambda s: s[3])
        labels.append("/".join(s[0] for s in around) or "outside any span")

    def label(t):
        i = bisect.bisect_right(cuts, t) - 1
        return labels[i] if i >= 0 else "outside any span"
    return label


def _short(name, width=120):
    """A device operation's name without its return type, cut to `width`
    characters (template arguments make some run to thousands)."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[: width - 3] + "..."


def summary(recs, t0_ns, t1_ns, spans, top=10):
    """What the trace says of the window [t0_ns, t1_ns]: busy seconds
    (union of device records), device seconds by operation name, and the
    idle seconds summed by the host span they fall in."""
    merged = _merged(recs, t0_ns, t1_ns)
    busy = sum(b - a for a, b in merged) / 1e9
    by_name = {}
    for name, s, d in recs:
        if s < t1_ns and s + d > t0_ns:
            by_name[name] = by_name.get(name, 0.0) + d / 1e9
    label = _labeller(spans)
    gaps, at = {}, t0_ns
    for a, b in merged + [[t1_ns, t1_ns]]:
        if a > at:
            lab = label((at + a) // 2)
            gaps[lab] = gaps.get(lab, 0.0) + (a - at) / 1e9
        at = max(at, b)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy,
        "window_s": (t1_ns - t0_ns) / 1e9,
        "by_name": by_name,
        "n_records": len(recs),
        "k1_s": sum(v for k, v in by_name.items()
                    if any(n in k for n in K1_KERNELS)),
        "breakdown": {"device_ops": [[_short(k), v] for k, v in ops[:top]],
                      "idle_gaps": [[k, v] for k, v in idle[:top]]},
    }


def first_record_ns(recs):
    return min((s for _, s, _ in recs), default=None)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
