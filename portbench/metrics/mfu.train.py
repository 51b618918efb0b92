"""The train step's useful flops (``work.model_flops`` at the published
heads and vocabulary) over the seconds a step of the window's untraced
part times the H100's bf16 peak, in %."""
from portbench import work


def read(run):
    flops = work.model_flops(run.cell.model, "train",
                             run.kind.tokens_per_unit * run.units,
                             run.kind.rows * run.units)
    return 100.0 * flops / (run.window_s * work.PEAK_FLOPS)
