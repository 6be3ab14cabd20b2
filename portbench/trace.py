"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over one
bounded segment, reduced to the device's busy time (the union of every
device operation's interval, so work that overlaps on two streams counts
once), kernel counts and times by name, and the idle gaps between device
operations, each named by the benchmark's host span that was open at the
gap's middle.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

SEGMENT = "portbench.segment"
SPAN = "portbench."
# The EI kernel K1, as the profiler names it.
K1_NAME = "ei_scores_kernel<false>"


def _is_copy(name):
    return name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


@contextmanager
def span(name):
    """A host span of the benchmark's own (``portbench.<name>``), which the
    traced segment's idle gaps are named by.  Costs a profiler call only
    while one records."""
    with torch.profiler.record_function(SPAN + name):
        yield


class Segment:
    """Profile a bounded segment: ``with seg.recording(): ...``; then
    :meth:`reduce`.  The segment ends after the card has finished its
    work."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        # A lead-in launch: the profiler has been seen to drop the records
        # of a profile's first moments.
        torch.zeros(1, device=self.device).add_(1)
        torch.cuda.synchronize(self.device)
        self._rf = torch.profiler.record_function(SEGMENT)
        self._rf.__enter__()

    def stop(self):
        torch.cuda.synchronize(self.device)
        self._rf.__exit__(None, None, None)
        self.prof.stop()

    @contextmanager
    def recording(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    def reduce(self, top=10):
        """``{busy_s, window_s, kernels, k1_s, k1_launches, device_ops,
        idle_gaps}`` over the segment."""
        evs = self.prof.events()
        seg = [e for e in evs if e.name == SEGMENT]
        s0, s1 = seg[0].time_range.start, seg[0].time_range.end
        # Device operations; the host spans' mirrors on the device
        # timeline (user annotations) are none.
        dev = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(SPAN)
               and s0 <= e.time_range.start <= s1]
        spans = sorted((e for e in evs if e.name.startswith(SPAN)
                        and e.name != SEGMENT),
                       key=lambda e: e.time_range.start)
        iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
        busy, gaps, cur = 0.0, [], None
        edge = s0
        for a, b in iv:
            if cur is None or a > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                if a > edge:
                    gaps.append((edge, a))
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
            edge = max(edge, b)
        if cur is not None:
            busy += cur[1] - cur[0]
        if s1 > edge:
            gaps.append((edge, s1))
        by_gap = {}
        open_spans, nxt = [], 0
        for a, b in gaps:
            # Gaps come in time order: a sweep keeps the spans open at mid.
            mid = 0.5 * (a + b)
            while nxt < len(spans) and spans[nxt].time_range.start <= mid:
                open_spans.append(spans[nxt])
                nxt += 1
            open_spans = [e for e in open_spans if e.time_range.end >= mid]
            inner = min(open_spans, default=None,
                        key=lambda e: e.time_range.end - e.time_range.start)
            label = "host" if inner is None else inner.name[len(SPAN):]
            by_gap[label] = by_gap.get(label, 0.0) + (b - a) * 1e-6
        by_op = {}
        kernels, k1_us, k1_n = 0, 0.0, 0
        for e in dev:
            us = e.time_range.end - e.time_range.start
            by_op[e.name] = by_op.get(e.name, 0.0) + us * 1e-6
            if not _is_copy(e.name):
                kernels += 1
            if K1_NAME in e.name:
                k1_us += us
                k1_n += 1
        return {
            "busy_s": busy * 1e-6,
            "window_s": (s1 - s0) * 1e-6,
            "kernels": kernels,
            "k1_s": k1_us * 1e-6,
            "k1_launches": k1_n,
            "device_ops": [[k[:160], v] for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                by_gap.items(), key=lambda kv: -kv[1])[:top]],
        }
