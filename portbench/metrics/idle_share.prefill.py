"""Share of the traced window in which no kernel, copy or fill ran on
the card, in %: the union of the device intervals, not their sum."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy = run.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.trace.window_s)
