"""Family dispatch: one ``Model`` facade per architecture family (port of
``models/model_zoo.py``).  The port builds dense decoder LMs without
experts, the hybrid recurrent/attention family (recurrentgemma) and the
xLSTM family; ``moe``, ``vlm`` and ``audio`` raise "not ported yet".

  table                               -> ParamTable
  forward(params, batch)              -> (logits, aux_loss)   prefill
  init_cache(batch, seq_len, device)  -> decode state         decode
  decode_step(params, cache, tokens)  -> (logits, cache)

``LanguageModel`` is the ``nn.Module`` that serves any of them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from torch import nn

from repro_torch.models.params import NOT_PORTED, ParamTable


@dataclasses.dataclass
class Model:
    cfg: object
    table: ParamTable
    forward: Callable  # (params, batch) -> (logits, aux)
    decode_step: Callable  # (params, cache, tokens) -> (logits, cache)
    init_cache: Callable  # (batch, seq_len, device) -> cache


def build_model(cfg) -> Model:
    if cfg.family == "dense" and not cfg.num_experts:
        return _decoder_lm(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        return hybrid.build(cfg)
    if cfg.family == "ssm":
        from repro_torch.models import xlstm
        return xlstm.build(cfg)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) {NOT_PORTED}")
    raise ValueError(f"unknown family {cfg.family}")


def _decoder_lm(cfg) -> Model:
    from repro_torch.models import transformer
    return Model(
        cfg=cfg,
        table=transformer.param_table(cfg),
        forward=lambda params, batch: transformer.forward(
            cfg, params, batch["tokens"]),
        decode_step=lambda params, cache, tokens: transformer.decode_step(
            cfg, params, cache, tokens),
        init_cache=lambda b, s, device: transformer.init_cache(
            cfg, b, s, device),
    )


class LanguageModel(nn.Module):
    """An LM of any ported family as an ``nn.Module``: it holds the
    parameters under the reference's paths (``embed/table``,
    ``blocks/u0/rec/lam``, ...), frozen for serving, and runs the family's
    ``Model`` facade on them."""

    def __init__(self, model: Model, params: dict):
        super().__init__()
        self.model = model
        self.cfg = model.cfg
        flat = {}

        def walk(node, prefix):
            for key, val in node.items():
                if isinstance(val, dict):
                    walk(val, f"{prefix}{key}/")
                else:
                    flat[f"{prefix}{key}"] = nn.Parameter(
                        val, requires_grad=False)
        walk(params, "")
        self.weights = nn.ParameterDict(flat)

    def tree(self) -> dict:
        """The parameters as the reference's nested dict (no copies)."""
        tree: dict = {}
        for path, val in self.weights.items():
            node = tree
            parts = path.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = val
        return tree

    def forward(self, tokens):
        return self.model.forward(self.tree(), {"tokens": tokens})

    def decode_step(self, cache, tokens):
        return self.model.decode_step(self.tree(), cache, tokens)

    def init_cache(self, batch: int, seq_len: int) -> dict:
        device = next(iter(self.weights.values())).device
        return self.model.init_cache(batch, seq_len, device)
