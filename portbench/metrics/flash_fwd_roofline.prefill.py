"""The attention forward's share of its roofline in the prefill, in %:
the bound of every attention call of the traced prompts, from the shapes
the prompt needs at the published heads (``work.flash_attention_work``:
one causal call a layer), over the device time of the forward's kernels
(``KERNELS``: the names of ``kernels/flash_attention/csrc/
flash_attention.cu`` and ``flash_wgmma.cuh``).  Where none of them ran,
it reads nothing."""
from portbench import work

KERNELS = ("flash_wgmma_kernel", "flash_attention_kernel")


def read(run):
    if run.trace is None:
        return None
    device_s, launches = run.trace.device_s_named(
        lambda name: any(k in name for k in KERNELS))
    if not launches:
        return None
    m, length = run.cell.model, run.cell.traffic["prompt_len"]
    calls = m["num_layers"] * run.trace.units
    per_call = work.bound_s(work.flash_attention_work(
        1, length, length, m["num_heads"], m["num_kv_heads"], m["head_dim"],
        window=m.get("sliding_window")))
    return 100.0 * calls * per_call / device_s
