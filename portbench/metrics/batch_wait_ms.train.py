"""Mean host milliseconds a step of the window's untraced part waits in
the call to ``BrickDataPipeline.next_device_batch``, on the host's clock
(``data/pipeline.py``): the step's tokens read from the bricks and
copied to the card."""


def read(run):
    waits = run.kind.batch_s[:run.units]
    return 1e3 * sum(waits) / len(waits) if waits else None
