"""Published-checkpoint → consumer wiring (counterpart of
jrr_tpu/evals/consumers.py:29-167; reference: main.py:23-27 runs the VIBE and
MEVA consumer evals, scripts/test.py:141-301).

Load the torch file, sniff the GRU layout from its tensor shapes (hidden
size, layer count, bidirectionality; the reference hardcodes them per
checkpoint), load the weights into the port's module by their published
names, splice in the ResNet backbone from SPIN's checkpoint (the reference's
VIBE_Demo/MEVA_demo take hmr's weights from SPIN's file,
scripts/test.py:146-195) and return the frame-level and sequence consumers
for `harness.evaluate_consumer` / `evaluate_consumer_sequences`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from jrr_tpu_torch.models import convert_util
from jrr_tpu_torch.models import meva as meva_lib
from jrr_tpu_torch.models import spin as spin_lib
from jrr_tpu_torch.models import temporal as temporal_lib

def load_gen_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Torch checkpoint file → state dict (VIBE/MEVA layouts: the generator
    weights under ['gen_state_dict']; a bare state dict at the root also
    loads). Read with `weights_only=False`: the published files also hold
    numpy scalars (VIBE's `performance`), which the weights-only unpickler
    refuses (tests/test_torch_consumers.py shows it)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("gen_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
            for k, v in sd.items()}


def sniff_temporal_layout(sd) -> Dict[str, Any]:
    """(hidden_size, n_layers, bidirectional[, latent_dim, vae_hidden]) from
    the checkpoint's own tensor shapes."""
    view = convert_util.StateDictView(sd, "gen_state_dict")
    n_layers = 0
    while f"encoder.gru.weight_ih_l{n_layers}" in view:
        n_layers += 1
    if n_layers == 0:
        view["encoder.gru.weight_ih_l0"]  # raises with the diff report
    meta: Dict[str, Any] = {
        "hidden_size": int(view["encoder.gru.weight_ih_l0"].shape[0]) // 3,
        "n_layers": n_layers,
        "bidirectional": "encoder.gru.weight_ih_l0_reverse" in view,
    }
    if "vae_model.e_mu.weight" in view:
        meta["latent_dim"] = int(view["vae_model.e_mu.weight"].shape[0])
        meta["vae_hidden"] = int(view["vae_model.d_gru.weight_hh_l0"].shape[1])
    return meta


def _spin_backbone_variables(spin_checkpoint: str) -> Dict[str, torch.Tensor]:
    """The ResNet-50 state of SPIN's checkpoint, under `ResNet50`'s names
    (the mean parameters are the head's, so they play no part)."""
    return spin_lib.backbone_state(spin_lib.load_spin_checkpoint(spin_checkpoint, device="cpu"))


def random_backbone_state() -> Dict[str, torch.Tensor]:
    """A ResNet-50 state drawn from `torch.Generator().manual_seed(0)`:
    conv weights N(0, 1/fan_in), BatchNorm at identity. jrr_tpu draws its
    random backbone from PRNGKey(0) (flax's init), so the two differ."""
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        shapes = spin_lib.ResNet50().state_dict()
    state = {}
    for name, value in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if value.ndim == 4:
            fan_in = value.shape[1] * value.shape[2] * value.shape[3]
            state[name] = torch.randn(value.shape, generator=gen) / math.sqrt(fan_in)
        elif leaf in ("weight", "running_var"):
            state[name] = torch.ones(value.shape)
        else:  # bias, running_mean, num_batches_tracked
            state[name] = torch.zeros(value.shape, dtype=value.dtype)
    return state


def build_consumer(
    kind: str,
    checkpoint_path: str,
    smpl_model,
    backbone: Optional[Dict[str, torch.Tensor]] = None,
    seqlen: int = 16,
) -> Tuple[Any, Any, Dict[str, Any]]:
    """(consumer, seq_consumer, layout meta) for 'vibe' or 'meva', on the
    body model's device.

    `backbone` is the ResNet-50 state spliced in, `_spin_backbone_variables`
    of SPIN's checkpoint: read once by the caller for every kind (jrr_tpu
    takes the SPIN file's path and reads it per kind). Without it the
    backbone is random (`random_backbone_state`): the eval runs end to end,
    but its numbers mean nothing, since the reference always has hmr's
    pretrained backbone; a loud warning says so."""
    sd = load_gen_state_dict(checkpoint_path)
    meta = sniff_temporal_layout(sd)
    view = convert_util.StateDictView(sd, f"{kind.upper()} gen_state_dict")
    if kind == "vibe":
        model = convert_util.empty_module(lambda: temporal_lib.TemporalPoseModel(
            meta["hidden_size"], meta["n_layers"], meta["bidirectional"]))
    elif kind == "meva":
        model = convert_util.empty_module(lambda: meva_lib.MEVAPoseModel(
            meta["hidden_size"], meta["n_layers"], meta["bidirectional"],
            latent_dim=meta.get("latent_dim", 1024), vae_hidden=meta.get("vae_hidden", 1024),
        ))
    else:
        raise ValueError(f"unknown consumer kind {kind!r} (vibe|meva)")
    regressor_defaults = {
        "init_pose": np.zeros((1, spin_lib.NUM_POSE_PARAMS), np.float32),
        "init_shape": np.zeros((1, 10), np.float32),
        "init_cam": np.asarray([spin_lib.DEFAULT_CAM], np.float32),
    }
    for name, child in model.named_children():
        if name == "backbone":
            continue
        convert_util.load_module(child, view, prefix=f"{name}.",
                                 defaults=regressor_defaults if name == "regressor" else None)
    if backbone is None:
        print(
            f"WARNING: no --spin-checkpoint given — the {kind.upper()} "
            "consumer's ResNet backbone is RANDOM-initialized; the eval "
            "exercises the full path but its numbers are not meaningful "
            "(the reference splices SPIN's pretrained hmr backbone, "
            "scripts/test.py:146-195)."
        )
        backbone = random_backbone_state()
    model.backbone.load_state_dict(backbone)
    model = model.eval().to(smpl_model.v_template.device)
    consumer = temporal_lib.make_temporal_consumer(smpl_model, model, seqlen=seqlen)
    seq_consumer = temporal_lib.make_sequence_consumer(smpl_model, model)
    return consumer, seq_consumer, meta
