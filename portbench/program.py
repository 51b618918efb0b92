"""The program under test (``repro_torch``), built from a cell's files:
its model configuration and its parameter tree filled with the cell's
weights.  The harness takes from the program only the system under test;
the inputs are drawn by ``weights.py``."""
from __future__ import annotations

import dataclasses

import torch

from portbench import weights


def model_config(cell):
    """The port's ``ModelConfig`` of the cell: the registry's config of
    the file's ``arch`` with the file's ``model`` numbers written over
    it (each key a field of the config)."""
    from repro_torch.configs.registry import get_config
    base = get_config(cell.config["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    unknown = sorted(set(cell.model) - fields)
    if unknown:
        raise ValueError(f"{cell.config_name}: not config fields: {unknown}")
    return dataclasses.replace(base, **cell.model)


def nested(flat: dict) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = val
    return out


def leaf_views(tree: dict) -> dict:
    """Leaf name -> tensor, as ``reference.decoder.leaves`` names them:
    ``layers/<path>[i]`` for layer i of a stacked path."""
    out = {}
    for path, t in flat(tree).items():
        if path.startswith("layers/"):
            out.update({f"{path}[{i}]": t[i] for i in range(t.shape[0])})
        else:
            out[path] = t
    return out


def params(model, m: dict, seed: int, device) -> dict:
    """The port's parameter tree of ``model`` (``model_zoo.build_model``),
    allocated from its table and filled with the cell's weights, a layer
    at a time.  Raises where the table's leaves are not the ones the
    benchmark draws."""
    table = model.table
    dtypes = {table.dtype(d) for d in table.defs.values()}
    if len(dtypes) != 1:
        raise ValueError(f"parameters of several dtypes: {dtypes}")
    dtype = dtypes.pop()
    drawn = {path for group in weights.global_groups(m)
             for path, *_ in group}
    drawn |= {f"layers/{path}" for path, *_ in weights.layer_leaves(m)}
    if drawn != set(table.defs):
        raise ValueError(
            f"the program's leaves differ from the drawn ones: "
            f"{sorted(set(table.defs) ^ drawn)}")
    out = {path: torch.empty(d.shape, dtype=dtype, device=device)
           for path, d in table.defs.items()}
    for path, w in weights.draw_global(m, seed, device, dtype).items():
        out[path].copy_(w)
    for i in range(m["num_layers"]):
        for path, w in weights.draw_layer(m, seed, i, device, dtype).items():
            out[f"layers/{path}"][i].copy_(w)
    return nested(out)
