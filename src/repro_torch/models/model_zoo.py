"""Family dispatch: one ``Model`` facade per architecture family (port of
``models/model_zoo.py``): decoder LMs (dense, with or without experts,
moe and vlm), the encoder-decoder (audio: whisper), the hybrid
recurrent/attention family (recurrentgemma) and the xLSTM family.

  table                                   -> ParamTable
  forward(params, batch)                  -> (logits, aux_loss)  prefill
  init_cache(batch, seq_len, device)      -> decode state        decode
  init_cache_abstract(shd, batch, seq_len) -> the same on ``meta``  dry run
  decode_step(params, cache, tokens, shd=None) -> (logits, cache)
  extra_inputs(shape, shd)                -> abstract extra inputs dry run
  input_specs(model, shape, shd)          -> abstract batch        dry run

``batch`` holds ``tokens`` and the family's extra inputs: ``patch_embeds``
(vlm, optional) or ``frames`` (audio).  ``shd`` is the reference's
``Sharder`` (``parallel/sharding.py``): a decode step given one attends
through the grid-brick cache where ``brick_active`` holds.  The forward
takes none: on the port's meshes (one card, or a mesh emulated on it) a
Sharder changes no computation of it.  ``LanguageModel`` is the
``nn.Module`` that serves any of them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from repro_torch.models.params import AbstractParam, ParamTable, \
    torch_dtype


@dataclasses.dataclass
class Model:
    cfg: object
    table: ParamTable
    forward: Callable  # (params, batch) -> (logits, aux)
    # (params, cache, tokens, shd=None) -> (logits, cache)
    decode_step: Callable
    init_cache: Callable  # (batch, seq_len, device) -> cache
    # (shd, batch, seq_len) -> cache of AbstractParam leaves
    init_cache_abstract: Callable
    extra_inputs: Callable  # (shape, shd) -> dict of AbstractParam


def abstract(shd, shape, dtype, roles) -> AbstractParam:
    """A ``meta`` tensor of ``shape`` and ``dtype`` with the spec of
    ``roles`` on ``shd``'s mesh (the reference's sharded
    ``ShapeDtypeStruct``)."""
    return AbstractParam(torch.empty(shape, dtype=dtype, device="meta"),
                         shd.spec(roles, shape))


def abstract_cache(cache: dict, roles: dict, shd, seq_len: int) -> dict:
    """A decode state made on ``meta`` (``init_cache(..., "meta")``) as
    ``AbstractParam`` leaves with the specs of the reference's ``roles``,
    and ``t = seq_len - 1``: the step that writes the cache's last
    position, which attends over every slot of the ring as the
    reference's step does whatever ``t`` holds (the port's attends over
    the filled prefix)."""
    out = {key: AbstractParam(val, shd.spec(roles[key], val.shape))
           for key, val in cache.items() if key != "t"}
    out["t"] = seq_len - 1
    return out


def input_specs(model: Model, shape, shd) -> dict:
    """Abstract inputs (``AbstractParam``: ``meta`` tensor and spec) for
    one shape cell: int32 tokens (and labels) of (batch, seq_len), one new
    token a row at decode, and the family's extra inputs."""
    b = shape.global_batch
    seq = shape.seq_len if shape.kind in ("train", "prefill") else 1
    specs = {"tokens": abstract(shd, (b, seq), torch.int32,
                                ("batch", None))}
    if shape.kind in ("train", "prefill"):
        specs["labels"] = abstract(shd, (b, seq), torch.int32,
                                   ("batch", None))
    specs.update(model.extra_inputs(shape, shd))
    return specs


def embeds_input(cfg, name: str, length: int):
    """``extra_inputs`` of a family with one (batch, length, d_model)
    input in ``cfg.dtype`` at train and prefill (vlm's ``patch_embeds``,
    audio's ``frames``)."""
    def extra(shape, shd):
        if shape.kind not in ("train", "prefill"):
            return {}
        return {name: abstract(
            shd, (shape.global_batch, length, cfg.d_model),
            torch_dtype(cfg.dtype), ("batch", None, None))}

    return extra


def build_model(cfg) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return _decoder_lm(cfg)
    if cfg.family == "audio":
        from repro_torch.models import encdec
        return encdec.build(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        return hybrid.build(cfg)
    if cfg.family == "ssm":
        from repro_torch.models import xlstm
        return xlstm.build(cfg)
    raise ValueError(f"unknown family {cfg.family}")


def _decoder_lm(cfg) -> Model:
    from repro_torch.models import transformer
    return Model(
        cfg=cfg,
        table=transformer.param_table(cfg),
        forward=lambda params, batch: transformer.forward(
            cfg, params, batch["tokens"],
            patch_embeds=batch.get("patch_embeds")),
        decode_step=lambda params, cache, tokens, shd=None:
            transformer.decode_step(cfg, params, cache, tokens, shd),
        init_cache=lambda b, s, device: transformer.init_cache(
            cfg, b, s, device),
        init_cache_abstract=lambda shd, b, s: abstract_cache(
            transformer.init_cache(cfg, b, s, "meta"),
            transformer.cache_roles(cfg, shd, s), shd, s),
        extra_inputs=(embeds_input(cfg, "patch_embeds", cfg.num_patches)
                      if cfg.num_patches else lambda shape, shd: {}),
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

    def forward(self, tokens, patch_embeds=None, frames=None):
        """tokens (B, S) and the family's extra inputs: ``patch_embeds``
        (B, P, d) for vlm, ``frames`` (B, S_enc, d) for audio."""
        batch = {"tokens": tokens}
        if patch_embeds is not None:
            batch["patch_embeds"] = patch_embeds
        if frames is not None:
            batch["frames"] = frames
        return self.model.forward(self.tree(), batch)

    def decode_step(self, cache, tokens, shd=None):
        return self.model.decode_step(self.tree(), cache, tokens, shd)

    def init_cache(self, batch: int, seq_len: int) -> dict:
        device = next(iter(self.weights.values())).device
        return self.model.init_cache(batch, seq_len, device)
