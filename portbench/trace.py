"""The device trace of a traced window, from ``torch.profiler``.

On the card the profiler records the CUDA activity alone: the kernels,
copies and fills on the device, and the host's calls into the CUDA
runtime.  It records no host op of the program (an op of PyTorch, an
autograd node): that recording costs the host microseconds an op, and
a chatglm3-6b train step (~10^5 ops) took 2.42 s under it on an H100
against 1.74 s without it.  Busy time is
the length of the union of the device intervals inside the window (two
kernels that overlap count once).  A per-layer reader picks the device
intervals of its kernels by name.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import sys

from torch.autograd import DeviceType

from portbench.work import union_s

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: entries in each list of the breakdown
TOP = 10
#: characters of a name in the breakdown
NAME_CHARS = 160


def _activity(e) -> str:
    """The kind of a profiler event ("kernel", "gpu_memcpy",
    "gpu_memset", "cuda_runtime" or "" for any other), from its device
    and name: the card's torch (2.11) gives ``_KinetoEvent`` no activity
    type."""
    name = e.name()
    if e.device_type() != DeviceType.CPU:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else ""


@dataclasses.dataclass
class Trace:
    lo: float                 # the window, seconds on the trace's clock
    hi: float
    device: list              # (start, end, name), sorted
    runtime: list             # (start, end, name) of runtime calls, sorted
    units: int = 0            # units of work the traced window ran

    @classmethod
    def of(cls, prof) -> "Trace":
        """The trace ``prof`` recorded.  Its window runs from the first
        event to the last: the host's first call into the runtime (a unit
        starts with one) to the end of the last unit's synchronize."""
        device, runtime = [], []
        for e in prof.profiler.kineto_results.events():
            kind = _activity(e)
            s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            if kind in DEVICE_ACTIVITIES and t > s:
                device.append((s, t, e.name()))
            elif kind == "cuda_runtime":
                runtime.append((s, t, e.name()))
        ends = [x for s, t, _ in device + runtime for x in (s, t)]
        lo, hi = (min(ends), max(ends)) if ends else (0.0, 0.0)
        print(f"trace: {len(device)} device intervals, {len(runtime)} "
              f"runtime calls", file=sys.stderr)
        return cls(lo, hi, sorted(device), sorted(runtime))

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which something ran on the device."""
        return union_s([(s, t) for s, t, _ in self.device], self.lo, self.hi)

    def device_s_named(self, match) -> tuple:
        """(device seconds inside the window, intervals) of the device
        intervals whose name ``match`` accepts; (0.0, 0) where there is
        none."""
        total, count = 0.0, 0
        for s, t, name in self.device:
            if match(name):
                total += max(0.0, min(t, self.hi) - max(s, self.lo))
                count += 1
        return total, count

    def gaps(self) -> list:
        """(start, end, the device interval before it or None) of each
        stretch of the window with nothing on the device."""
        out, reach, before = [], self.lo, None
        for s, t, name in self.device:
            if s > reach and reach < self.hi:
                out.append((reach, min(s, self.hi), before))
            if t > reach:
                reach, before = t, name
        if reach < self.hi:
            out.append((reach, self.hi, before))
        return out

    def runtime_at(self, times) -> list:
        """The name of the runtime call open at each of ``times`` (the
        latest started of those that contain it, on any thread), or
        None."""
        order = sorted(range(len(times)), key=lambda j: times[j])
        out = [None] * len(times)
        heap, i = [], 0
        for j in order:
            when = times[j]
            while i < len(self.runtime) and self.runtime[i][0] <= when:
                s, t, name = self.runtime[i]
                heapq.heappush(heap, (-s, t, name))
                i += 1
            while heap and heap[0][1] < when:
                heapq.heappop(heap)
            if heap:
                out[j] = heap[0][2]
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time
        by what the host was doing: the runtime call it was in (a
        synchronize is the host waiting on the device), else the device
        operation the gap follows."""
        ops = collections.Counter()
        for s, t, name in self.device:
            ops[name[:NAME_CHARS]] += max(0.0, min(t, self.hi) -
                                          max(s, self.lo))
        idle = collections.Counter()
        gaps = self.gaps()
        calls = self.runtime_at([(s + t) / 2 for s, t, _ in gaps])
        for (s, t, before), call in zip(gaps, calls):
            label = call if call is not None else \
                f"after {before}" if before is not None else "(window start)"
            idle[label[:NAME_CHARS]] += t - s
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)]}
