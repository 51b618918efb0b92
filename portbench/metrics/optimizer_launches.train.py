"""Kernel launches a train step makes in AdamW: the host's runtime
launch calls of the device trace (``*LaunchKernel*``) whose start lies
inside a ``train.optimizer`` span, over the steps.  Spans and runtime
calls share the profiler's clock.  Standard error gets, beside it, the
device kernels that start in the optimizer's stretch of each step on the
device: the span's device ms back from the end of the last device
interval before the host's next synchronize returns."""
import bisect

from portbench import spans


def read(run):
    recs = spans.of(run)
    opts = spans.named(recs, "train.optimizer")
    steps = spans.named(recs, "train.step")
    if not opts or not steps or not run.trace.runtime:
        return None
    launches = sorted(s for s, _, name in run.trace.runtime
                      if "LaunchKernel" in name)
    count = sum(bisect.bisect_right(launches, r["t1_wall"]) -
                bisect.bisect_left(launches, r["t0_wall"]) for r in opts)
    spans.log(f"optimizer_launches.train: {count} launches, "
              f"{_device_kernels(run.trace, opts)} device kernels in the "
              f"optimizer's stretch, over {len(steps)} steps")
    return count / len(steps)


def _device_kernels(trace, opts) -> int:
    syncs = sorted((s, t) for s, t, name in trace.runtime
                   if "Synchronize" in name)
    ends = sorted(t for _, t, _ in trace.device)
    kernels = sorted(s for s, _, name in trace.device
                     if not name.startswith(("Memcpy", "Memset")))
    total = 0
    for r in opts:
        sync = next((t for s, t in syncs if s >= r["t1_wall"]), None)
        if sync is None:
            continue
        k = bisect.bisect_right(ends, sync)
        if k == 0:
            continue
        end = ends[k - 1]
        total += bisect.bisect_right(kernels, end) - bisect.bisect_left(
            kernels, end - spans.device_ms(r) * 1e-3)
    return total
