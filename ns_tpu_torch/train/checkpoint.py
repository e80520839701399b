"""Checkpoint save and restore in the JAX package's npz format, and the
weight carry between JAX key paths and torch modules.

Port of `ns_tpu/train/checkpoint.py`. A checkpoint is one .npz holding
one array per leaf under its key path (`params/lift/w`,
`params/spectral/0/lo_re`, ...), plus `__manifest__`: a JSON blob with the
format version and a {key: {shape, dtype}} table (format 2). Format 1
checkpoints carry `__treedef__` instead, and their table is read from the
arrays. A `<file>.meta.json` beside it holds the run's metadata (the
Trainer's `config` and `grid`). Files written here load into the JAX
package and the JAX package's load here.

State is a nested dict (or list) of arrays or tensors; a key path joins
the keys and list indices with '/', as JAX's `_path_key` does.

The weight carry: a model of `ns_tpu_torch.models` names and shapes its
parameters as the JAX parameter tree does, so the JAX key path of a
parameter is its module path with '/' for '.' (`spectral.0.lo_re` ->
`spectral/0/lo_re`); `params_from_jax` and `params_to_jax` move the
values across.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch
from torch import nn

CKPT_FORMAT_VERSION = 2


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{key path: leaf} of a nested dict/list/tuple; dict keys in sorted
    order, as JAX flattens them."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, sub in items:
        out.update(_flatten_with_paths(sub, f"{prefix}/{k}" if prefix
                                       else str(k)))
    return out


def save_checkpoint(state: dict, folder: str, is_best: bool = False,
                    filename: str = "checkpoint.npz",
                    meta: dict | None = None) -> str:
    """Save the nested `state` (+ JSON-able `meta`) to folder/filename; copy
    it to model_best.npz when is_best."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, filename)
    arrays = {k: _host(v) for k, v in _flatten_with_paths(state).items()}
    manifest = {
        "format_version": CKPT_FORMAT_VERSION,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
    }
    np.savez(path, __manifest__=np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8), **arrays)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, default=str)
    if is_best:
        shutil.copyfile(path, os.path.join(folder, "model_best.npz"))
        if meta is not None:
            shutil.copyfile(path + ".meta.json",
                            os.path.join(folder, "model_best.npz.meta.json"))
    return path


def _leaf_meta(leaf) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), np.dtype(str(leaf.dtype).split(".")[-1])
    return np.shape(leaf), np.asarray(leaf).dtype


def _check_manifest(path: str, data, template: dict,
                    allow_cast: bool = False) -> None:
    """Leaf-by-leaf check of the saved checkpoint against `template`
    ({key: (shape, dtype)}): raises ValueError naming every missing,
    unexpected, shape-mismatched and (unless `allow_cast`)
    dtype-mismatched leaf."""
    if "__manifest__" in data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        version = manifest.get("format_version")
        if version != CKPT_FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path} has format_version {version}; this "
                f"build reads version {CKPT_FORMAT_VERSION}")
        saved = {k: (tuple(v["shape"]), np.dtype(v["dtype"]))
                 for k, v in manifest["leaves"].items()}
    else:  # format 1 (`__treedef__`) or a bare npz: the arrays' own table
        saved = {k: (np.shape(data[k]), data[k].dtype) for k in data.files
                 if k != "__treedef__"}

    missing = sorted(set(template) - set(saved))
    unexpected = sorted(set(saved) - set(template))
    both = set(template) & set(saved)
    mismatched = sorted(k for k in both
                        if tuple(saved[k][0]) != tuple(template[k][0]))
    cast_bad = [] if allow_cast else sorted(
        k for k in both if k not in mismatched
        and saved[k][1] != template[k][1])
    if missing or unexpected or mismatched or cast_bad:
        lines = [f"checkpoint {path} does not match the template pytree "
                 "(wrong model/optimizer config for this checkpoint?):"]
        if missing:
            lines.append(f"  template leaves absent from checkpoint: "
                         f"{missing}")
        if unexpected:
            lines.append(f"  checkpoint leaves absent from template: "
                         f"{unexpected}")
        for k in mismatched:
            lines.append(f"  shape mismatch at {k!r}: saved "
                         f"{tuple(saved[k][0])} vs template "
                         f"{tuple(template[k][0])}")
        for k in cast_bad:
            lines.append(f"  dtype mismatch at {k!r}: saved "
                         f"{saved[k][1]} vs template {template[k][1]} "
                         "(pass allow_cast=True to cast explicitly)")
        raise ValueError("\n".join(lines))


def _unflatten_like(like, flat: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, flat, f"{prefix}/{i}" if prefix
                                          else str(i))
                          for i, v in enumerate(like))
    return flat[prefix]


def load_checkpoint(path: str, like: Any, allow_cast: bool = False) -> Any:
    """Restore a checkpoint into the structure of `like` (a nested
    dict/list of arrays or tensors with the same key paths), as numpy
    arrays in the template leaves' dtypes. Dtypes must match unless
    `allow_cast=True` (an f64 checkpoint into an f32 template would
    otherwise truncate silently)."""
    template = {k: _leaf_meta(v) for k, v in _flatten_with_paths(like).items()}
    with np.load(path) as data:
        _check_manifest(path, data, template, allow_cast=allow_cast)
        flat = {k: data[k].astype(dt).reshape(shape)
                for k, (shape, dt) in template.items()}
    return _unflatten_like(like, flat)


def load_meta(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)


# --- the weight carry --------------------------------------------------------


def jax_key(name: str) -> str:
    """The JAX key path of a module parameter path."""
    return name.replace(".", "/")


def params_to_jax(model: nn.Module) -> dict:
    """{JAX key path: numpy array} of the model's parameters."""
    return {jax_key(n): _host(p) for n, p in model.named_parameters()}


@torch.no_grad()
def params_from_jax(model: nn.Module, flat: dict,
                    what: str = "the given parameters") -> nn.Module:
    """Fill the model's parameters from {JAX key path: array}, cast to each
    parameter's dtype and device. Raises ValueError naming every leaf the
    model has and `flat` lacks, or a leaf whose shape differs; other keys
    of `flat` are ignored (a Trainer checkpoint's opt_state, say)."""
    named = [(jax_key(n), p) for n, p in model.named_parameters()]
    missing = [k for k, _ in named if k not in flat]
    if missing:
        raise ValueError(f"{what}: missing params leaves {missing} (wrong "
                         "model config for this checkpoint?)")
    for k, p in named:
        arr = flat[k]
        if tuple(np.shape(arr)) != tuple(p.shape):
            raise ValueError(
                f"{what}: leaf {k!r} has shape {tuple(np.shape(arr))}; this "
                f"config expects {tuple(p.shape)} (wrong model config for "
                "this checkpoint?)")
        p.copy_(torch.tensor(np.asarray(arr)))
    return model
