"""Checkpoint / resume (counterpart of jrr_tpu/utils/checkpoint.py).

- `save_train_state`/`restore_train_state`: the `TrainState` as
  <dir>/state_<step:08d>.npz in jrr_tpu's layout — the arrays of jrr_tpu's
  TrainState keyed by `jax.tree_util.keystr` (`convert.train_state_arrays`),
  so jrr_tpu's `restore_train_state(path, template)` reads a file the port
  wrote and the port reads jrr_tpu's npz. The port's own earlier layout
  (keys such as "jreg_opt/m/0", "pose_disc/fc1.weight") still restores,
  so older port runs resume. jrr_tpu writes an orbax directory when orbax
  imports; that raises here: jrr_tpu's `restore_train_state` and then
  `save_pytree_npz` turn one into an npz.
- `save_pytree_npz`/`restore_pytree_npz` write and read any other tree of
  tensors (NamedTuples, tuples, lists, dicts, `nn.Module`s by state_dict,
  the engine's `_Adam` by count and moments, ints and floats) as one .npz,
  keyed by the path of each leaf.
- `ShardManifest`: per-shard refined outputs, one shard_<id:06d>.npz each,
  and manifest.json listing the completed shards — the same files and keys
  as jrr_tpu's, so a refined-shard directory written by either package
  resumes in the other.

Train states, shards and the manifest are written whole or not at all:
to `<path>.tmp.npz` (or `<path>.tmp`) first, then moved into place with
`os.replace` (`savez_atomic`, `write_json_atomic`), so a crash mid-write
leaves no partial file at a final path. jrr_tpu writes its train states
straight to the final path.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from jrr_tpu_torch import config as config_lib
from jrr_tpu_torch import convert
from jrr_tpu_torch.refine import engine


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    key = lambda k: f"{prefix}/{k}" if prefix else str(k)  # noqa: E731
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    if isinstance(tree, (int, float, np.ndarray, np.generic)):
        return {prefix: np.asarray(tree)}
    if isinstance(tree, nn.Module):
        return {key(k): v.detach().cpu().numpy() for k, v in tree.state_dict().items()}
    if isinstance(tree, engine._Adam):
        out = {key("count"): np.asarray(tree.count)}
        out.update(_flatten(tree.m, key("m")))
        out.update(_flatten(tree.v, key("v")))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = tree._asdict().items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {prefix!r}")
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, key(k)))
    return out


def _restore(tree: Any, data: Dict[str, np.ndarray], prefix: str = "") -> Any:
    key = lambda k: f"{prefix}/{k}" if prefix else str(k)  # noqa: E731
    if isinstance(tree, torch.Tensor):
        return torch.as_tensor(data[prefix], dtype=tree.dtype, device=tree.device)
    if isinstance(tree, (bool, int, float)):
        return type(tree)(data[prefix])
    if isinstance(tree, nn.Module):
        module = copy.deepcopy(tree)
        state = module.state_dict()
        module.load_state_dict({k: torch.as_tensor(data[key(k)]) for k in state})
        return module
    if isinstance(tree, engine._Adam):
        opt = copy.copy(tree)
        opt.count = int(data[key("count")])
        opt.m = _restore(tree.m, data, key("m"))
        opt.v = _restore(tree.v, data, key("v"))
        return opt
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**{k: _restore(v, data, key(k)) for k, v in tree._asdict().items()})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_restore(v, data, key(i)) for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _restore(v, data, key(k)) for k, v in tree.items()}
    raise TypeError(f"cannot restore a {type(tree).__name__} at {prefix!r}")


def savez_atomic(path: str, **arrays) -> str:
    """np.savez(path, **arrays) by way of `<path>.tmp.npz` and `os.replace`:
    a crash mid-write leaves no partial file at `path`. Returns `path`."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def write_json_atomic(path: str, obj) -> None:
    """json.dump(obj) to `path` by way of `<path>.tmp` and `os.replace`."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def save_pytree_npz(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def restore_pytree_npz(path: str, template: Any) -> Any:
    """The tree of `template` with every leaf read from `path` (each tensor
    on its template's device and dtype)."""
    with np.load(path) as f:
        data = dict(f)
    missing = sorted(set(_flatten(template)) - set(data))
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} of the tree's keys (first: {missing[0]!r})")
    return _restore(template, data)


def save_train_state(ckpt_dir: str, state, step: int) -> str:
    """Write `state` in jrr_tpu's layout to <ckpt_dir>/state_<step:08d>.npz;
    returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    return savez_atomic(os.path.join(ckpt_dir, f"state_{step:08d}.npz"),
                        **convert.train_state_arrays(state))


def restore_train_state(path: str, template):
    """The `TrainState` in `path`, jrr_tpu's layout or the port's earlier
    one, with the learning rates and device of `template`."""
    if not path.endswith(".npz"):
        raise ValueError(
            f"{path} is not an npz train state: an orbax directory of jrr_tpu? Turn it "
            "into an npz with jrr_tpu.utils.checkpoint.restore_train_state(path, template) "
            "and then jrr_tpu.utils.checkpoint.save_pytree_npz(path + '.npz', state)"
        )
    with np.load(path) as f:
        data = dict(f)
    if not any(k.startswith(".") for k in data):  # the port's earlier layout
        return restore_pytree_npz(path, template)
    want = convert.train_state_arrays(template)
    for key, value in want.items():
        if key not in data or data[key].shape != value.shape:
            got = data[key].shape if key in data else "missing"
            raise ValueError(f"{path}: {key} is {got}, the template's is {value.shape}")
    cfg = config_lib.PipelineConfig()
    cfg = dataclasses.replace(
        cfg, jreg=dataclasses.replace(cfg.jreg, lr=template.jreg_opt.lr),
        discriminator=dataclasses.replace(cfg.discriminator, lr=template.pose_disc_opt.lr),
    )
    return convert.train_state_from_arrays(data, cfg, device=template.j_reg_raw.device)


class ShardManifest:
    """Per-shard output bookkeeping: restart = skip completed shards."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.manifest_path = os.path.join(out_dir, "manifest.json")

    def completed(self) -> List[int]:
        if not os.path.exists(self.manifest_path):
            return []
        with open(self.manifest_path) as f:
            return sorted(json.load(f)["completed"])

    def is_done(self, shard_id: int) -> bool:
        return shard_id in set(self.completed())

    def write_shard(self, shard_id: int, arrays: Dict[str, np.ndarray]) -> str:
        path = savez_atomic(os.path.join(self.out_dir, f"shard_{shard_id:06d}.npz"), **arrays)
        done = sorted(set(self.completed()) | {shard_id})
        write_json_atomic(self.manifest_path, {"completed": done})
        return path

    def read_shard(self, shard_id: int) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.out_dir, f"shard_{shard_id:06d}.npz")) as f:
            return dict(f)
