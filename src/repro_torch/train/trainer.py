"""Training loop: brick-fed data, checkpoint/restart, failure recovery
(port of ``train/trainer.py``).

The control loop is the GEPS JSE applied to training: the catalogue
tracks node health, the packet scheduler feeds the batch from node-local
bricks, and checkpoints make any failure a bounded-loss restart.  The
port runs on one device (``device=`` where the reference takes a mesh)
and differs from the reference in two places:

- a checkpoint of a bf16 model resumes: leaves come back in their
  manifest dtype (``checkpoint/ckpt.py``), where the reference's resume
  raises on them (C-ref9);
- a resumed run reads the data stream from where the checkpointed run
  left it (one global batch a step), so a restart ends with the bits of
  the uninterrupted run; the reference's resumed trainer starts the
  stream again from its first batch (C-ref10).

The last step is saved once: the reference saves it a second time when
it falls on ``ckpt_every``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.data.pipeline import BrickDataPipeline, TokenBrickStore
from repro_torch.kernels import resolve_device
from repro_torch.models import model_zoo
from repro_torch.optim.adamw import AdamW, init_opt_state
from repro_torch.train import steps as steps_lib

@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_ckpts: int = 3
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    log_every: int = 10
    async_ckpt: bool = True


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 n_data_nodes: int = 4,
                 failure_hook: Optional[Callable[[int], Optional[int]]] = None):
        """failure_hook(step) -> node_id to kill at that step (simulation)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.model = model_zoo.build_model(cfg)
        self.opt = AdamW()
        self.failure_hook = failure_hook

        self.catalog = MetadataCatalog(n_data_nodes)
        store = TokenBrickStore(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            n_bricks=2 * n_data_nodes,
            seqs_per_brick=max(4, tcfg.global_batch),
            n_nodes=n_data_nodes)
        self.pipeline = BrickDataPipeline(
            store, self.catalog, global_batch=tcfg.global_batch,
            device=self.device)

        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts,
                                      async_save=tcfg.async_ckpt)
        self.step_fn = steps_lib.make_train_step(cfg, self.model, self.opt,
                                                 lr=tcfg.lr)
        self.history: list = []
        #: (params, opt_state) after ``train``
        self.state = None

    # ------------------------------------------------------------------ #
    def init_state(self):
        """Parameters drawn from a generator seeded with 0 on the device,
        zero moments."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        params = self.model.table.init(gen, self.device)
        opt_state = init_opt_state(params, self.opt)
        return params, opt_state

    def _restore_or_init(self):
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            params, opt_state = self.init_state()
            return 0, params, opt_state
        tree, manifest = self.ckpt.restore_latest(device=self.device)
        # the data the checkpointed run consumed: one global batch a step
        for _ in range(manifest["step"]):
            self.pipeline.next_batch()
        return manifest["step"], tree["params"], tree["opt_state"]

    def _save(self, step, params, opt_state):
        self.ckpt.save(step, {"params": params, "opt_state": opt_state},
                       extra={"name": self.cfg.name})

    # ------------------------------------------------------------------ #
    def train(self) -> Dict[str, float]:
        start_step, params, opt_state = self._restore_or_init()
        step = start_step
        t0 = time.time()
        while step < self.tcfg.total_steps:
            # simulated node failure: mark dead, data fails over to replicas
            if self.failure_hook is not None:
                victim = self.failure_hook(step)
                if victim is not None:
                    self.catalog.mark_dead(victim)
                    self.pipeline.sched.requeue_node(victim)
            batch = self.pipeline.next_device_batch()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            step += 1
            if step % self.tcfg.log_every == 0 or step == self.tcfg.total_steps:
                loss = float(metrics["loss"])
                self.history.append({"step": step, "loss": loss})
            if step % self.tcfg.ckpt_every == 0:
                self._save(step, params, opt_state)
        if step % self.tcfg.ckpt_every or step == start_step:
            self._save(step, params, opt_state)   # not saved just above
        self.ckpt.wait()
        self.state = (params, opt_state)
        return {
            "steps": step - start_step,
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "wall_s": time.time() - t0,
        }
