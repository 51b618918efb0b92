"""The prefill's useful flops (``work.model_flops``: the forward over
every position, the unembedding at the served one, at the published
heads and vocabulary) over the seconds a prompt of the window's
untraced part times the H100's bf16 peak, in %."""
from portbench import work


def read(run):
    flops = work.model_flops(run.cell.model, "prefill",
                             run.kind.tokens_per_unit * run.units, run.units)
    return 100.0 * flops / (run.window_s * work.PEAK_FLOPS)
