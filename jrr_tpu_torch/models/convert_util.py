"""Checkpoint key-layout hardening (counterpart of
jrr_tpu/models/convert_util.py:28-99).

The reference loads published artifacts directly — SPIN's
`model_checkpoint.pt` (reference: scripts/optimize.py:90-94), VIBE's and
MEVA's `ckpt['gen_state_dict']` (reference: scripts/test.py:146-195). The
port's modules carry the published key names, so those files load into them
by name; the failure to guard against is a silent layout drift in a real
artifact surfacing as a bare KeyError the day the file appears.

`StateDictView` wraps a torch state dict for loading:

- strips the `DataParallel`-era `module.` prefix (published VIBE/MEVA
  checkpoints exist in both layouts);
- on a missing key, raises `CheckpointLayoutError` with a diff report —
  the requested key, the closest names actually present (with shapes), and a
  prefix-grouped inventory of the whole dict — instead of a bare KeyError.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch


class CheckpointLayoutError(KeyError):
    """A checkpoint's key layout does not match what the converter expects.

    str(err) carries the full diff report (KeyError quotes its arg, so
    override __str__ to keep the report readable)."""

    def __str__(self) -> str:  # noqa: D105
        return self.args[0]


def _to_numpy(v: Any) -> np.ndarray:
    return np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)


class StateDictView(Mapping):
    """Dict-like view over a torch state dict with actionable key errors."""

    def __init__(self, state_dict: Dict[str, Any], source: str = "checkpoint"):
        self.source = source
        self._sd: Dict[str, Any] = {}
        for k, v in state_dict.items():
            self._sd[k[7:] if k.startswith("module.") else k] = v

    def __len__(self) -> int:
        return len(self._sd)

    def __iter__(self) -> Iterator[str]:
        return iter(self._sd)

    def __contains__(self, key: object) -> bool:
        return key in self._sd

    def keys(self):
        return self._sd.keys()

    def __getitem__(self, key: str) -> np.ndarray:
        if key not in self._sd:
            raise CheckpointLayoutError(self._report(key))
        return _to_numpy(self._sd[key])

    def get(self, key: str, default: Optional[Any] = None):
        if key not in self._sd:
            return default
        return _to_numpy(self._sd[key])

    def _shape(self, key: str) -> str:
        v = self._sd[key]
        shape = getattr(v, "shape", None)
        return "x".join(map(str, shape)) if shape is not None else "?"

    def _report(self, missing: str) -> str:
        lines = [
            f"{self.source}: key '{missing}' not found "
            f"({len(self._sd)} tensors present).",
        ]
        close = difflib.get_close_matches(missing, self._sd.keys(), n=5, cutoff=0.4)
        if close:
            lines.append("  closest keys present:")
            lines += [f"    {k}  ({self._shape(k)})" for k in close]
        # Prefix-grouped inventory: first dotted component.
        groups: Dict[str, int] = {}
        for k in self._sd:
            groups[k.split(".", 1)[0]] = groups.get(k.split(".", 1)[0], 0) + 1
        inv = ", ".join(f"{p}.* ({n})" for p, n in sorted(groups.items()))
        lines.append(f"  key groups present: {inv or '(empty)'}")
        lines.append(
            "  The checkpoint's layout differs from the published layout this "
            "converter targets; check the converter options (n_layers, "
            "hidden_size, bidirectional) against the checkpoint's config, or "
            "map the keys above to the expected names."
        )
        return "\n".join(lines)


def empty_module(factory) -> torch.nn.Module:
    """`factory()`'s module on the CPU with its tensors allocated but not
    initialized, for `load_module` to fill (a ResNet-50's random init costs
    more than its load)."""
    with torch.device("meta"):
        module = factory()
    return module.to_empty(device="cpu")


def load_module(module: torch.nn.Module, view: StateDictView, prefix: str = "",
                defaults: Optional[Dict[str, Any]] = None) -> None:
    """Fill every parameter and buffer of `module` from `view[prefix + name]`.

    Keys of the file that the module does not have are ignored (the
    reference loads with strict=False; VIBE's gen_state_dict also holds its
    SMPL buffers). A missing key raises `CheckpointLayoutError`, except
    BatchNorm's `num_batches_tracked` (older files lack it; inference never
    reads it) and the names in `defaults`, which take the given value. A
    tensor of another shape raises too, unless only its rank differs."""
    defaults = defaults or {}
    state = {}
    for name, current in module.state_dict().items():
        key = prefix + name
        if key in view:
            value = torch.as_tensor(view[key])
        elif name.endswith("num_batches_tracked"):
            value = torch.zeros_like(current)
        elif name in defaults:
            value = torch.as_tensor(np.asarray(defaults[name]))
        else:
            value = torch.as_tensor(view[key])  # raises with the diff report
        if value.shape != current.shape:
            if value.ndim == current.ndim or value.numel() != current.numel():
                raise CheckpointLayoutError(
                    f"{view.source}: '{key}' has shape {tuple(value.shape)}, the module "
                    f"expects {tuple(current.shape)}; check the layout options (n_layers, "
                    "hidden_size, bidirectional) against the checkpoint's config.")
            value = value.reshape(current.shape)  # (144,) against (1, 144) and the like
        state[name] = value.to(current.dtype)
    module.load_state_dict(state)
