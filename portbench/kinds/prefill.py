"""Prefill traffic: a closed loop of whole prompts through the port's
``make_prefill_step`` under ``torch.inference_mode``.

Each unit draws a new prompt from the seed, runs the prefill and brings
the last position's logits and the served (greedy) token to the host:
the time to the first token of that prompt.  Set-up runs one prompt of
the same shape that is not counted.

What is checked, once the window has closed and the weights are freed:
for one prompt of the window, drawn from the seed, the last-position
logits against the reference's (``reference/decoder.prefill_logits``),
which draws the weights again and runs every layer over the prompt.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import compare, program, weights
from portbench.reference import decoder

#: the tag of the draw that picks the checked prompt
SAMPLE_TAG = 4


class Kind:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.m = cell.model
        self.cfg = program.model_config(cell)
        self.length = cell.traffic["prompt_len"]
        self.tokens_per_unit = self.length
        self.rows = []             # (Vp,) f32 logits on the host, a prompt
        self.attempted = self.failed = 0

    def setup(self, mark=lambda phase: None):
        from repro_torch.models import model_zoo
        from repro_torch.train import steps
        mark("program imported")
        model = model_zoo.build_model(self.cfg)
        self.params = program.params(model, self.m, self.seed, self.device)
        mark("weights drawn")
        self.step = steps.make_prefill_step(self.cfg, model)
        self._prompt(0)
        mark("warm prompt")

    def _prompt(self, k: int) -> torch.Tensor:
        tokens = weights.prompt(self.seed, k, self.length,
                                self.cfg.vocab_size, self.device)
        with torch.inference_mode():
            last = self.step(self.params, {"tokens": tokens})
            return last[0].float().cpu()

    def unit(self):
        self.attempted += 1
        row = self._prompt(self.attempted)
        self.rows.append(row)
        if not torch.isfinite(row).all():
            self.failed += 1

    def e2e(self, units: int, window_s: float) -> dict:
        return {"prefill_tokens_per_s": units * self.length / window_s}

    def release(self):
        del self.params, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _pick(self) -> int:
        """The index (into ``rows``) of the prompt the check compares."""
        return int(np.random.default_rng(weights.draw_seed(
            self.seed, SAMPLE_TAG)).integers(len(self.rows)))

    def outputs(self) -> torch.Tensor:
        """What the program produced that the check compares."""
        return self.rows[self._pick()]

    def reference(self, fp8: bool = False) -> torch.Tensor:
        """The reference's logits of the checked prompt (``fp8``: the
        control)."""
        tokens = weights.prompt(self.seed, self._pick() + 1, self.length,
                                self.cfg.vocab_size, self.device)
        return decoder.prefill_logits(self.m, self.seed, tokens, self.device,
                                      fp8=fp8)

    def numbers(self, outputs, ref) -> dict:
        return compare.prefill(outputs, ref, self.cfg.vocab_size)

    def check(self) -> dict:
        return self.numbers(self.outputs(), self.reference())
