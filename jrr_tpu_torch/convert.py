"""Turn the JAX package's parameters, given as array-likes (numpy arrays or
anything `np.asarray` accepts), into the port's objects — so both packages
can be run on the same numbers. Only numpy is used on the input side.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from jrr_tpu_torch import config as config_lib
from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.models import discriminator as disc_lib
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.refine import engine
from jrr_tpu_torch.refine import trainer
from jrr_tpu_torch.refine.losses import FrameBatch, FrameParams


def _t(x, dev, dtype=torch.float32):
    return None if x is None else torch.as_tensor(np.array(x), dtype=dtype, device=dev)


def _copy(cls, obj):
    """An instance of the port's dataclass `cls` with `obj`'s field values."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def refiner_config(src) -> config_lib.RefinerConfig:
    """A JAX `RefinerConfig` (or any object with its fields) → the port's."""
    return dataclasses.replace(
        _copy(config_lib.RefinerConfig, src),
        loss_weights=_copy(config_lib.LossWeights, src.loss_weights),
        camera=_copy(config_lib.CameraConfig, src.camera),
        silhouette=_copy(config_lib.SilhouetteConfig, src.silhouette),
    )


def pipeline_config(src) -> config_lib.PipelineConfig:
    """A JAX `PipelineConfig` → the port's, every field carried across."""
    return config_lib.PipelineConfig(
        refiner=refiner_config(src.refiner),
        discriminator=_copy(config_lib.DiscriminatorConfig, src.discriminator),
        jreg=_copy(config_lib.JRegConfig, src.jreg),
        data=_copy(config_lib.DataConfig, src.data),
        mesh=_copy(config_lib.MeshConfig, src.mesh),
        seed=src.seed,
        num_betas=src.num_betas,
    )


def smpl_model(src, device="cuda") -> smpl_lib.SMPLModel:
    """An object with the JAX `SMPLModel` fields → `SMPLModel` on `device`."""
    dev = resolve_device(device)
    perm = getattr(src, "vertex_perm", None)
    return smpl_lib.SMPLModel(
        v_template=_t(src.v_template, dev),
        shapedirs=_t(src.shapedirs, dev),
        posedirs=_t(src.posedirs, dev),
        j_regressor=_t(src.j_regressor, dev),
        lbs_weights=_t(src.lbs_weights, dev),
        faces=_t(src.faces, dev, torch.int64),
        j_regressor_extra=_t(getattr(src, "j_regressor_extra", None), dev),
        parents=tuple(int(p) for p in src.parents),
        vertex_perm=_t(perm, dev, torch.int64),
    )


def _load_linear(layer: nn.Linear, w, b) -> None:
    """JAX (in, out) weight + (out,) bias → nn.Linear's (out, in)."""
    with torch.no_grad():
        layer.weight.copy_(torch.as_tensor(np.array(w, np.float32).T))
        layer.bias.copy_(torch.as_tensor(np.array(b, np.float32)))


def pose_discriminator(params: Mapping, device="cuda") -> disc_lib.PoseDiscriminator:
    """JAX pose-discriminator param dict (w1, b1, w2, b2, wj, bj, wg1…bg3)."""
    d = disc_lib.PoseDiscriminator(device="cpu")
    _load_linear(d.conv1, params["w1"], params["b1"])
    _load_linear(d.conv2, params["w2"], params["b2"])
    _load_linear(d.fc1, params["wg1"], params["bg1"])
    _load_linear(d.fc2, params["wg2"], params["bg2"])
    _load_linear(d.fc3, params["wg3"], params["bg3"])
    with torch.no_grad():
        d.joint_w.copy_(torch.as_tensor(np.array(params["wj"], np.float32)))
        d.joint_b.copy_(torch.as_tensor(np.array(params["bj"], np.float32)))
    return d.to(resolve_device(device))


def shape_discriminator(params: Mapping, device="cuda") -> disc_lib.ShapeDiscriminator:
    """JAX shape-discriminator param dict (w1, b1, w2, b2, w3, b3)."""
    d = disc_lib.ShapeDiscriminator(device="cpu")
    for i, layer in enumerate((d.fc1, d.fc2, d.fc3), start=1):
        _load_linear(layer, params[f"w{i}"], params[f"b{i}"])
    return d.to(resolve_device(device))


def frame_params(src, device="cuda") -> FrameParams:
    """An object with pose6d/orient6d/betas/cam_t fields → `FrameParams`."""
    dev = resolve_device(device)
    return FrameParams(*(_t(getattr(src, f), dev) for f in FrameParams._fields))


def frame_batch(src, device="cuda") -> FrameBatch:
    """An object with gt_j2d/gt_j3d/mask fields → `FrameBatch`."""
    dev = resolve_device(device)
    return FrameBatch(*(_t(getattr(src, f, None), dev) for f in FrameBatch._fields))


def _adam_moments(opt_state):
    """The (count, mu, nu) node of an optax adam state: `optax.adam` chains
    scale_by_adam with a learning-rate scale, so its state is a tuple whose
    first entry carries the moments."""
    node = opt_state
    while not hasattr(node, "mu"):
        node = node[0]
    return node


def _adam(params, lr: float, moments, to_params) -> engine._Adam:
    """An `_Adam` over `params` whose moments are the JAX moments laid out
    like the parameters (`to_params` maps a JAX tree to a list)."""
    opt = engine._Adam(params, lr)
    opt.count = int(np.array(moments.count))
    opt.m = [t.detach().clone() for t in to_params(moments.mu)]
    opt.v = [t.detach().clone() for t in to_params(moments.nu)]
    return opt


def train_state(src, cfg: config_lib.PipelineConfig, device="cuda") -> trainer.TrainState:
    """A JAX `TrainState` (j_reg_raw, the optax adam states of all three
    optimizers, both discriminators' param dicts, step; arrays as numpy or
    anything `np.asarray` takes) → the port's, with the learning rates of
    `cfg`. Discriminator moments are converted like their parameters (the
    same transposes), in `module.parameters()` order."""
    dev = resolve_device(device)
    j_reg = _t(src.j_reg_raw, dev)
    pose = pose_discriminator(src.pose_disc, device=dev)
    shape = shape_discriminator(src.shape_disc, device=dev)
    as_pose = lambda tree: list(pose_discriminator(tree, device=dev).parameters())  # noqa: E731
    as_shape = lambda tree: list(shape_discriminator(tree, device=dev).parameters())  # noqa: E731
    lr_d = cfg.discriminator.lr
    return trainer.TrainState(
        j_reg_raw=j_reg,
        jreg_opt=_adam([j_reg], cfg.jreg.lr, _adam_moments(src.jreg_opt),
                       lambda x: [_t(x, dev)]),
        pose_disc=pose,
        pose_disc_opt=_adam(list(pose.parameters()), lr_d, _adam_moments(src.pose_disc_opt), as_pose),
        shape_disc=shape,
        shape_disc_opt=_adam(list(shape.parameters()), lr_d, _adam_moments(src.shape_disc_opt),
                             as_shape),
        step=int(np.array(src.step)),
    )
