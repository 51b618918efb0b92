"""The chunked RG-LRU scan kernel at recurrentgemma-9b's (1, 4096, 4096)
for several chunk lengths, beside an elementwise kernel that moves the
same bytes.

    python3 scripts/rglru_scan_chunks.py

Needs one CUDA card.  For chunk lengths 64 (the default), 48 and 32 the
kernel is first held bit for bit against ``rglru_scan_chunked_ref`` at
that chunk, then timed (device ms from CUDA-graph replay over 4 operand
sets, so L2 stays cold, as ``chip_smoke.py`` times it).  A shorter chunk
stages less a block, so more blocks fit on an SM, but makes more blocks,
each with its own ticket, publication and carry.  ``add_ms`` is
``torch.add(a, b, out=h)`` on the same tensors: it reads a and b and
writes h once, the scan's bytes with no recurrence, so it says what rate
the memory system gives such a stream.  ``fill_ms`` is the wrapper's
all-ones fill of the default plan's workspace alone, which each scan
call also runs.  Each time is the mean of two runs taken in the order
add, fill, 64, 48, 32, 32, 48, 64, fill, add.  Prints one JSON line a
chunk (``ms``, ``share_of_bound``, ``blocks``), one for the add and the
fill, then nvidia-smi's name and power limit."""
from __future__ import annotations

import functools
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SHAPE = (1, 4096, 4096)
CHUNKS = (64, 48, 32)
SETS = 4


def main() -> int:
    if not torch.cuda.is_available():
        print("rglru_scan_chunks: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_chunked_ref
    rg_kernel.build()
    gen = torch.Generator(device=cs.DEVICE)
    gen.manual_seed(3)
    sets = [cs.scan_operands(gen, *SHAPE, False)[:2] for _ in range(SETS)]
    a, x = sets[0]
    for chunk in CHUNKS:
        got, _ = rg_kernel.rglru_scan_cuda(a, x, chunk=chunk)
        want, _ = rglru_scan_chunked_ref(a, x, None, chunk)
        if not torch.equal(got, want):
            raise AssertionError(f"chunk {chunk}: not bit-equal to "
                                 f"rglru_scan_chunked_ref")
    outs = [torch.empty_like(a) for _ in sets]
    add = [functools.partial(torch.add, p, q, out=o)
           for (p, q), o in zip(sets, outs)]
    words = rg_kernel.plan(*SHAPE).ws_words
    fill = [functools.partial(torch.full, (words,), -1, dtype=torch.int64,
                              device=cs.DEVICE)]
    scan = {c: [functools.partial(rg_kernel.rglru_scan_cuda, p, q, chunk=c)
                for p, q in sets] for c in CHUNKS}
    order = [("add", add), ("fill", fill)] + [(c, scan[c]) for c in CHUNKS]
    times = {name: [] for name, _ in order}
    for name, calls in order + order[::-1]:
        times[name].append(cs.device_time_ms(calls))
    bound, by = cs.roofline.bound_ms(cs.roofline.rglru_scan_work(*SHAPE))
    for chunk in CHUNKS:
        ms = sum(times[chunk]) / 2
        print(json.dumps({
            "shape": list(SHAPE), "chunk": chunk,
            "blocks": rg_kernel.plan(*SHAPE, chunk=chunk).blocks,
            "ms": ms, "runs_ms": times[chunk], "bound_ms": bound,
            "bound_by": by, "share_of_bound": bound / ms}), flush=True)
    add_ms = sum(times["add"]) / 2
    print(json.dumps({"shape": list(SHAPE), "add_ms": add_ms,
                      "runs_ms": times["add"],
                      "share_of_bound": bound / add_ms,
                      "fill_ms": sum(times["fill"]) / 2,
                      "fill_runs_ms": times["fill"],
                      "fill_bytes": 8 * words}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
