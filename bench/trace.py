"""The device trace of a `--trace 1` run: `torch.profiler` over a steady
stretch of the measured window, reduced to the device's busy seconds,
the kernels' seconds, the device operations that took most time and the
host's activity during the device's idle gaps."""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time
import warnings

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


@contextlib.contextmanager
def _one_cycle():
    """Quiet the profiler's note that it keeps one cycle's events: the
    trace is one cycle."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield


class Tracer:
    """Starts and stops the profiler at boundaries the traffic chooses
    (between jobs or batches, when the device is idle). Disabled, every
    call is a no-op and `summary` is None."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.done = False
        self._prof = None
        self._t0 = 0.0
        self.window_s = 0.0
        self.summary = None

    def start(self) -> None:
        if not self.enabled or self.active or self.done:
            return
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        torch.cuda.synchronize()
        with _one_cycle():
            self._prof.start()
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        with _one_cycle():
            self._prof.stop()
        self.active, self.done = False, True

    def reduce(self) -> None:
        """Read the trace (after the window: it takes seconds)."""
        if self._prof is None:
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self._prof = None
        self.summary = summarize(events, self.window_s)


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_label(starts, host, mid) -> str:
    """The innermost host span (latest start) that holds time `mid`."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(i - 4000, -1), -1):
        s, e, name = host[j]
        if e >= mid:
            return name
    return "host_python"


def summarize(events: list, window_s: float) -> dict:
    """Busy and kernel seconds, the top device operations and the idle
    seconds by what the host was doing, from a Chrome trace's events
    (timestamps in microseconds)."""
    dev, host = [], []
    by_op = collections.Counter()
    kernel_us = 0.0
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, ts, dur = ev.get("cat"), float(ev["ts"]), float(ev["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            by_op[str(ev.get("name", "?"))[:120]] += dur
            if cat == "kernel":
                kernel_us += dur
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, str(ev.get("name", "?"))[:120]))
    busy = _union(dev)
    busy_us = sum(e - s for s, e in busy)
    idle = collections.Counter()
    if busy and host:
        host.sort()
        starts = [h[0] for h in host]
        lo = min(starts[0], busy[0][0])
        hi = max(max(h[1] for h in host), busy[-1][1])
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                idle[_host_label(starts, host, (s + e) / 2)] += e - s
    return {
        "busy_s": busy_us * 1e-6,
        "kernel_s": kernel_us * 1e-6,
        "window_s": window_s,
        "device_ops": [[n, us * 1e-6] for n, us in by_op.most_common(TOP)],
        "idle_gaps": [[n, us * 1e-6] for n, us in idle.most_common(TOP)],
    }
