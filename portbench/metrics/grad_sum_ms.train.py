"""Device milliseconds a train step spends summing the microbatches'
gradients (``train/steps.py`` ``make_grads_fn``): the ``train.grad_sum``
spans (the sum's zero fill, each microbatch's adds, the divide by M) of
the traced steps, over the steps.  Standard error gets the split by
phase."""
import collections

from portbench import spans


def read(run):
    recs = spans.of(run)
    value = spans.per_root(recs, "train.grad_sum", "train.step")
    if value is not None:
        steps = len(spans.named(recs, "train.step"))
        phases = collections.Counter()
        for r in spans.named(recs, "train.grad_sum"):
            phases[r["attrs"]["phase"]] += spans.device_ms(r) / steps
        spans.log("grad_sum_ms.train: " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()) + " ms a step")
    return value
