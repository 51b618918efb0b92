"""Family dispatch: one ``Model`` facade per architecture family (port of
``models/model_zoo.py``).  The port builds dense decoder LMs without
experts; the other families raise "not ported yet".

  table                               -> ParamTable
  forward(params, batch)              -> (logits, aux_loss)   prefill
  init_cache(batch, seq_len, device)  -> ring KV cache        decode
  decode_step(params, cache, tokens)  -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import transformer
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
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid", "ssm"):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) {NOT_PORTED}")
    raise ValueError(f"unknown family {cfg.family}")


def _decoder_lm(cfg) -> Model:
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
