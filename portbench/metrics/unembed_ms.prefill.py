"""Device milliseconds a prompt spends unembedding (``models/
transformer.py`` ``unembed``): the ``model.unembed`` spans inside the
traced ``prefill.step`` spans, over the prompts.  Standard error gets the
positions unembedded against those served, and the prompt's own device
ms."""
from portbench import spans


def read(run):
    recs = spans.of(run)
    value = spans.per_root(recs, "model.unembed", "prefill.step")
    if value is not None:
        root_of = spans.roots_of(recs)
        spans_in = [r for r in spans.named(recs, "model.unembed")
                    if root_of[r["span_id"]] == "prefill.step"]
        spans.log("unembed_ms.prefill: {} of {} positions served; the "
                  "prompt {:.3f} device ms".format(
                      sum(r["attrs"]["served"] for r in spans_in),
                      sum(r["attrs"]["positions"] for r in spans_in),
                      spans.per_root(recs, "prefill.step", "prefill.step")))
    return value
