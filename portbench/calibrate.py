"""The readings that set a cell's limits, on the chip at the cell's own
size, many seeds in one process (the benchmark's runs do not run this):

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control 3]

For each seed: the program's numbers against the float32 reference
(sound runs: the lower reading), the numbers of each fault the cell can
have, planted in the program (a train cell: half of each batch left out,
the mean taken over the rest; a prefill cell: the served token altered
where it is produced, the logits rolled by one), and for the first
``--control`` seeds the control's: the reference in float8 in the
program's place (the upper reading).  A step that returns its state
unchanged reads 1 by construction.  One JSON line a seed on stdout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def half_batch():
    """``make_train_step`` whose steps see the first half of each batch,
    in half the microbatches: half of the batch left out, the mean taken
    over the rest."""
    from repro_torch.train import steps
    real = steps.make_train_step

    def faulty(cfg, model, opt=None, lr=3e-4):
        inner = real(dataclasses.replace(
            cfg, microbatches=max(1, cfg.microbatches // 2)), model, opt, lr)

        def step(params, opt_state, batch):
            rows = next(iter(batch.values())).shape[0] // 2
            return inner(params, opt_state,
                         {key: x[:rows] for key, x in batch.items()})
        return step

    steps.make_train_step = faulty
    try:
        yield
    finally:
        steps.make_train_step = real


def program_outputs(cell, seed, device, fault=None):
    """The program's set-up and one window unit: the kind (its state
    freed) and its outputs."""
    Kind = cell.code("kinds", cell.traffic["kind"]).Kind
    kind = Kind(cell, seed, device)
    ctx = half_batch() if fault == "half_batch" else contextlib.nullcontext()
    with ctx:
        kind.setup()
        kind.unit()
    kind.release()
    return kind, kind.outputs()


def release():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--faults", type=int, default=3,
                        help="seeds (the first ones) with the faults run")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for n, seed in enumerate(seeds):
        line = {"workload": cell.name, "seed": seed}
        t = time.perf_counter()
        kind, out = program_outputs(cell, seed, "cuda")
        line["program_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ref = kind.reference()
        line["reference_s"] = time.perf_counter() - t
        release()
        line["program"] = kind.numbers(out, ref)
        if n < args.faults:
            if cell.traffic["kind"] == "train":
                _, bad = program_outputs(cell, seed, "cuda", "half_batch")
                line["half_batch"] = kind.numbers(bad, ref)
                release()
            else:
                line["altered"] = kind.numbers(torch.roll(out, 1), ref)
        if n < args.control:
            t = time.perf_counter()
            line["control"] = kind.numbers(kind.reference(fp8=True), ref)
            line["control_s"] = time.perf_counter() - t
            release()
        print(json.dumps(line), flush=True)
    print(f"calibrate {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
