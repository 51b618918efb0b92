"""Device milliseconds a train step spends in remat's recompute
(``models/transformer.py`` ``_remat``, ``run_layers``): the
``train.recompute`` spans of the traced steps, each checkpointed layer or
segment run again in the backward, over the steps; a recompute inside
another counts once, in the outer one."""
from portbench import spans


def read(run):
    recs = spans.of(run)
    steps = spans.named(recs, "train.step")
    ids = {r["span_id"] for r in spans.named(recs, "train.recompute")}
    root_of = spans.roots_of(recs)
    outer = [r for r in spans.named(recs, "train.recompute")
             if r["parent_id"] not in ids
             and root_of[r["span_id"]] == "train.step"]
    if not steps or not outer:
        return None
    return sum(spans.device_ms(r) for r in outer) / len(steps)
