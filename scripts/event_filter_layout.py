"""What limits the event_filter kernel: the sectors it reads from device
memory, or the L1 lines it has in flight.

    python3 scripts/event_filter_layout.py

Needs one CUDA card.  Times the kernel (device ms from CUDA-graph replay,
as ``chip_smoke.py`` times it) at the query path's chunk (64 events, K 6)
and at one brick (256 events, K 1), each with T = 4096 tracks, and with
the track row V floats wide for V = 63 (the store's), 32, 16, 8 and 1.
Only pt, column 0, is read, so the layouts do the same work on the same
values; they differ in what one pt costs the memory system:

- V 63 and 32: a 32-byte sector and a 128-byte L1 line of its own;
- V 16: a sector of its own (and a 64-byte half line), a line shared by 2;
- V 8: a sector of its own, a line shared by 4;
- V 1: 8 pt a sector, 32 a line.

Sectors per pt stay at one from V 63 down to V 8 while lines per pt fall
to a quarter.  If the time follows the lines, the L1 lines in flight
bound the kernel; if it stays flat down to V 8, the sectors do; if it
falls only at V 8, a 64-byte memory access does.  Prints one JSON line a
shape and layout (``ms``, ``sector_bound_ms``: the sectors of the valid
pt at 3.35 TB/s, ``lines`` per valid pt), then the launch floor and
nvidia-smi's name and power limit."""
from __future__ import annotations

import functools
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

#: (events, queries): the query path's chunk (B1), one brick (B2)
SHAPES = ((64, 6), (256, 1))
TRACKS = 4096
WIDTHS = (63, 32, 16, 8, 1)
#: operand sets cycled per timing: more bytes than the 50 MB L2 at V 1
ROTATION = 48
CALIB_ITERS = 0


def time_layout(gen, n, k, v):
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    sets = [cs.make_operands(gen, n, TRACKS, v, k, cap=False)
            for _ in range(ROTATION)]
    calls = [functools.partial(ef_kernel.event_filter_batch_cuda, *ops,
                               calib_iters=CALIB_ITERS) for ops in sets]
    ms = (cs.device_time_ms(calls) + cs.device_time_ms(calls)) / 2
    valid = sum(int(torch.clamp(ops[2].long(), 0, TRACKS).sum())
                for ops in sets) / len(sets)
    pt_per_sector = max(1, 8 // v)
    return {"events": n, "k": k, "tracks": TRACKS, "v": v, "ms": ms,
            "sector_bound_ms": 32 * valid / pt_per_sector
            / cs.HBM_BYTES_PER_S * 1e3,
            "lines": 1 / max(1, 32 // v), "valid_pt": valid}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    gen = torch.Generator(device=cs.DEVICE)
    gen.manual_seed(0)
    for n, k in SHAPES:
        for v in WIDTHS:
            cs.emit(time_layout(gen, n, k, v))
            torch.cuda.empty_cache()
    cs.emit({"launch_floor_ms": cs.launch_floor_ms()})
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
