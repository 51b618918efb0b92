"""The attention backward's share of its roofline in the train step, in
%: the bound of every backward attention call of the traced steps, from
the shapes the step needs at the published heads
(``work.flash_attention_bwd_work``: one call a layer and microbatch),
over the device time of the backward's kernels (``KERNELS``: the names
of ``kernels/flash_attention/csrc/flash_attention_bwd.cu`` and
``flash_bwd_wgmma.cuh``).  Where none of them ran, it reads nothing."""
from portbench import work

KERNELS = ("fa_bwd_",)


def read(run):
    if run.trace is None:
        return None
    device_s, launches = run.trace.device_s_named(
        lambda name: any(k in name for k in KERNELS))
    if not launches:
        return None
    m, t = run.cell.model, run.cell.traffic
    calls = m["num_layers"] * m["microbatches"] * run.trace.units
    per_call = work.bound_s(work.flash_attention_bwd_work(
        t["rows_per_microbatch"], t["seq_len"], t["seq_len"], m["num_heads"],
        m["num_kv_heads"], m["head_dim"], window=m.get("sliding_window")))
    return 100.0 * calls * per_call / device_s
