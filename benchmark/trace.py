"""The device's activity in a traced window, from ``torch.profiler``.

The profiler's Chrome trace is read back once the window has closed.
Device activity is every kernel, copy and memset on the card; the
window is the span of the ``WINDOW`` annotation that the harness puts
around its calls (from the first enqueue to the final synchronise).
Busy time is the union of the device's activity inside the window;
an idle gap is any part of the window that no device activity covers,
named by the innermost host operation running at its start.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "benchmark_window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}
TOP = 10


@dataclass
class Trace:
    window: tuple  # (start_us, end_us)
    device: list = field(default_factory=list)  # (name, start_us, end_us), in the window
    host: list = field(default_factory=list)  # (start_us, end_us, name), sorted

    @classmethod
    def from_chrome(cls, path) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if len(spans) != 1:
            raise RuntimeError(f"the trace holds {len(spans)} {WINDOW!r} spans, not 1")
        w0 = float(spans[0]["ts"])
        w1 = w0 + float(spans[0]["dur"])
        device, host = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            start = float(e["ts"])
            end = start + float(e.get("dur", 0))
            if e.get("cat") in DEVICE_CATS:
                if end > w0 and start < w1:
                    device.append((e["name"], max(start, w0), min(end, w1)))
            elif e.get("cat") in HOST_CATS:
                host.append((start, end, e["name"]))
        host.sort()
        return cls(window=(w0, w1), device=device, host=host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device's activity, as sorted disjoint
        (start_us, end_us)."""
        out = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(i) for i in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_seconds(self, match=lambda name: True) -> float:
        return sum(e - s for name, s, e in self.device if match(name)) / 1e6

    def gaps(self) -> list:
        """The window's idle parts, (start_us, end_us)."""
        out, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        best = None
        for start, end, name in reversed(self.host[max(0, i - 64) : i]):
            if end > t and (best is None or end - start < best[0]):
                best = (end - start, name)
        return best[1] if best else "no host op"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest
        idle gaps summed by what the host was doing, in seconds."""
        ops = defaultdict(float)
        for name, s, e in self.device:
            ops[name[:120]] += (e - s) / 1e6
        idle = defaultdict(float)
        for s, e in self.gaps():
            idle[self.host_at(s)[:120]] += (e - s) / 1e6
        top = lambda d: [[n, v] for n, v in sorted(d.items(), key=lambda x: -x[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}
