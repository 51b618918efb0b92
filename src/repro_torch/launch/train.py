"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``launch/train.py``).

Runs the trainer on one device, the card unless ``--device cpu``
(``--reduced`` for a smoke-scale config on the CPU).  ``--production-mesh``
asks for the reference's 16 x 16 mesh of 256 devices, which one process
on one card does not have: it raises, as the reference does with fewer
devices.  Every family trains on the card, through the hand-written
backward kernels of B3, B4 and B5 (``kernels/*/ops.py``); recurrentgemma-9b
whole does not fit one card's memory, its training state alone ~137 GB.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.registry import get_config, list_archs, \
    reduced_config
from repro_torch.kernels import resolve_device
from repro_torch.train.trainer import Trainer, TrainerConfig

#: devices the reference's production mesh needs (16 x 16)
PRODUCTION_DEVICES = 256


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256 devices)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise RuntimeError(
            f"production mesh needs {PRODUCTION_DEVICES} devices, this "
            f"process drives one (the mesh and its sharding are not ported "
            f"yet: ROADMAP.md, queue A item 9)")
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, global_batch=args.global_batch,
        seq_len=args.seq_len, lr=args.lr)
    trainer = Trainer(cfg, tcfg, device=device)
    out = trainer.train()
    print(f"done ({device}): {out}")
    return out


if __name__ == "__main__":
    main()
