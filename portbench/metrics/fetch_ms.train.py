"""Host milliseconds a traced step's batch takes to fetch
(``data/pipeline.py`` ``next_device_batch``): the mean of the
``data.fetch`` spans on the host's clock, the program's own counterpart
of ``batch_wait_ms.train``.  Standard error gets the split between the
packets read on the host (``data.read``) and the copy to the card
(``data.copy``)."""
from portbench import spans


def read(run):
    recs = spans.of(run)
    value = spans.per_root(recs, "data.fetch", "data.fetch", spans.host_ms)
    if value is not None:
        spans.log("fetch_ms.train: read {:.3f}, copy {:.3f} host ms a batch"
                  .format(*(spans.per_root(recs, name, "data.fetch",
                                           spans.host_ms) or 0.0
                            for name in ("data.read", "data.copy"))))
    return value
