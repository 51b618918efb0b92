"""Device idle milliseconds a train step: the gaps of the device trace
(``trace.Trace.gaps``: nothing on the card) whose midpoint falls while
the host is inside a ``train.step`` span, over the steps.  Standard error
gets that idle time split by the innermost span the host was in, and the
idle time outside the steps."""
import collections

from portbench import spans


def read(run):
    recs = spans.of(run)
    steps = spans.named(recs, "train.step")
    if not steps or not run.trace.device:
        return None
    gaps = run.trace.gaps()
    root_of = spans.roots_of(recs)
    split = collections.Counter()
    for (s, t, _), span in zip(gaps, spans.innermost(
            recs, [(s + t) / 2 for s, t, _ in gaps])):
        inside = span is not None and root_of[span["span_id"]] == \
            "train.step"
        split[span["name"] if inside else "(outside train.step)"] += t - s
    spans.log("step_idle_ms.train: " + ", ".join(
        f"{name} {1e3 * v / len(steps):.3f}"
        for name, v in split.most_common()) + " ms a step")
    split.pop("(outside train.step)", None)
    return 1e3 * sum(split.values()) / len(steps)
