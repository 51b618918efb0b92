"""Device milliseconds a train step spends in AdamW (``optim/adamw.py``
``adamw_update``): the ``train.optimizer`` spans of the traced steps,
timed by their CUDA events, over the steps.  Standard error gets the
split between the grad norm (``optim.norm``) and the slice loop
(``optim.update``)."""
from portbench import spans


def read(run):
    recs = spans.of(run)
    value = spans.per_root(recs, "train.optimizer", "train.step")
    if value is not None:
        spans.log("optimizer_ms.train: norm {:.3f}, update {:.3f} ms a step"
                  .format(*(spans.per_root(recs, name, "train.step") or 0.0
                            for name in ("optim.norm", "optim.update"))))
    return value
