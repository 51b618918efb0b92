"""Training traffic: a closed loop of whole train steps.

Set-up builds the one training object of the run, ``make_train_step``'s
step with its model, bf16 parameters drawn from the seed and AdamW's
state, and feeds it from the port's brick pipeline (``data/pipeline.py``:
``TokenBrickStore`` rows seeded by the run's seed, so every row differs).
The first ``checked_steps`` steps run in set-up through the window's own
call and feed, and the window goes on with the same object.

What is checked, once the window has closed and the program's state is
freed (``reference/decoder.follow_training``): the loss of each checked
step and of the step after them, each leaf's norm of the first gradient
as the optimizer got it (from the first moment after step 1:
m1 / ((1 - b1) clip), with the clip of the grad norm the step reported),
and each leaf's norm of the parameters' change after the checked steps.
"""
from __future__ import annotations

import gc
import time

import torch

from portbench import compare, program, weights
from portbench.harness import synchronize
from portbench.reference import decoder


class Kind:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.m = cell.model
        self.traffic = cell.traffic
        self.opt_hp = self.traffic["optimizer"]
        self.cfg = program.model_config(cell)
        self.checked = self.traffic["checked_steps"]
        self.rows = self.cfg.microbatches * self.traffic["rows_per_microbatch"]
        self.tokens_per_unit = self.rows * self.traffic["seq_len"]
        self.losses, self.grad_norms, self.batches = [], [], []
        self.batch_s = []          # host seconds of each fetch in the window
        self.readings = {}
        self.attempted = self.failed = 0

    def setup(self, mark=lambda phase: None):
        from repro_torch.core.catalog import MetadataCatalog
        from repro_torch.data.pipeline import BrickDataPipeline, \
            TokenBrickStore
        from repro_torch.models import model_zoo
        from repro_torch.optim.adamw import AdamW, init_opt_state
        from repro_torch.train import steps
        cfg, hp, data = self.cfg, self.opt_hp, self.traffic["data"]
        mark("program imported")
        model = model_zoo.build_model(cfg)
        self.params = program.params(model, self.m, self.seed, self.device)
        mark("weights drawn")
        opt = AdamW(b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                    weight_decay=hp["weight_decay"],
                    grad_clip=hp["grad_clip"],
                    moment_dtype=cfg.opt_moment_dtype)
        self.opt_state = init_opt_state(self.params, opt)
        self.step = steps.make_train_step(cfg, model, opt, lr=hp["lr"])
        store = TokenBrickStore(
            vocab_size=cfg.vocab_size, seq_len=self.traffic["seq_len"],
            n_bricks=data["bricks"], seqs_per_brick=self.rows,
            n_nodes=data["nodes"], replication=data["replication"],
            seed=self.seed)
        self.pipe = BrickDataPipeline(store, MetadataCatalog(data["nodes"]),
                                      global_batch=self.rows,
                                      device=self.device)
        mark("state and pipeline")
        for t in range(self.checked):
            self._step()
            if t == 0:
                self.readings["grad"] = self._first_grad()
        mark("checked steps")
        self.readings["change"] = self._change()
        mark("change read")
        self.batch_s.clear()

    def _step(self):
        start = time.perf_counter()
        batch = self.pipe.next_device_batch()
        self.batch_s.append(time.perf_counter() - start)
        if len(self.batches) <= self.checked:
            self.batches.append(batch["tokens"])
        self.params, self.opt_state, met = self.step(
            self.params, self.opt_state, batch)
        self.losses.append(met["loss"])
        self.grad_norms.append(met["grad_norm"])
        synchronize(self.device)

    def unit(self):
        self._step()
        self.attempted += 1

    @torch.no_grad()
    def _first_grad(self) -> dict:
        hp = self.opt_hp
        clip = min(1.0, hp["grad_clip"] / max(float(self.grad_norms[0]),
                                              1e-9))
        return {name: float(torch.linalg.vector_norm(m.float()))
                / ((1 - hp["b1"]) * clip)
                for name, m in program.leaf_views(self.opt_state["m"]).items()}

    @torch.no_grad()
    def _change(self) -> dict:
        views = program.leaf_views(self.params)
        out = {}
        dt = views["embed/table"].dtype
        for j in range(len(weights.global_groups(self.m))):
            for key, w in weights.draw_global(self.m, self.seed, self.device,
                                              dt, groups=[j]).items():
                out[key] = _diff_norm(views[key], w)
        for i in range(self.m["num_layers"]):
            for key, w in weights.draw_layer(self.m, self.seed, i,
                                             self.device, dt).items():
                name = f"layers/{key}[{i}]"
                out[name] = _diff_norm(views[name], w)
        return out

    def e2e(self, units: int, window_s: float) -> dict:
        window = torch.stack(self.losses[self.checked:]).float().cpu()
        self.failed = int((~torch.isfinite(window)).sum())
        return {"train_tokens_per_s": units * self.tokens_per_unit / window_s}

    def release(self):
        self.losses = [float(x) for x in self.losses[:self.checked + 1]]
        del self.params, self.opt_state, self.step, self.pipe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self) -> dict:
        """What the program produced that the check compares."""
        return dict(self.readings, loss=self.losses[:self.checked + 1])

    def reference(self, fp8: bool = False) -> dict:
        """The reference's readings of the same steps (``fp8``: the
        control)."""
        return decoder.follow_training(
            self.m, self.seed, self.batches, microbatches=self.cfg.microbatches,
            optimizer=self.opt_hp, steps=self.checked, device=self.device,
            fp8=fp8)

    def numbers(self, outputs, ref) -> dict:
        return compare.train(outputs, ref)

    def check(self) -> dict:
        return self.numbers(self.outputs(), self.reference())


def _diff_norm(p: torch.Tensor, w: torch.Tensor, chunk: int = 1 << 26):
    """||p - w|| in f32, a flat slice at a time (no whole-leaf f32
    temporaries in set-up)."""
    p, w = p.reshape(-1), w.reshape(-1)
    total = 0.0
    for i in range(0, p.numel(), chunk):
        total += float(torch.sum(
            (p[i:i + chunk].float() - w[i:i + chunk].float()) ** 2))
    return total ** 0.5
