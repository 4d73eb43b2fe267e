"""Turn the JAX package's parameters, given as array-likes (numpy arrays or
anything `np.asarray` accepts), into the port's objects — so both packages
can be run on the same numbers: configs, the SMPL arrays, the
discriminators and the train state, and the flax variables of the SPIN,
VIBE-style and MEVA-style networks. The train state also goes back:
`train_state_arrays` gives jrr_tpu's checkpoint arrays of a port state,
`train_state_from_arrays` reads them. Only numpy is used on the JAX side.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from jrr_tpu_torch import config as config_lib
from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.models import convert_util
from jrr_tpu_torch.models import discriminator as disc_lib
from jrr_tpu_torch.models import image_discriminator as imgd_lib
from jrr_tpu_torch.models import meva as meva_lib
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.models import spin as spin_lib
from jrr_tpu_torch.models import temporal as temporal_lib
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


# The port's discriminator parameter names → (jrr_tpu's key, stored
# transposed): nn.Linear keeps (out, in) where jrr_tpu keeps (in, out).
_POSE_DISC_KEYS = {
    "joint_w": ("wj", False), "joint_b": ("bj", False),
    "conv1.weight": ("w1", True), "conv1.bias": ("b1", False),
    "conv2.weight": ("w2", True), "conv2.bias": ("b2", False),
    "fc1.weight": ("wg1", True), "fc1.bias": ("bg1", False),
    "fc2.weight": ("wg2", True), "fc2.bias": ("bg2", False),
    "fc3.weight": ("wg3", True), "fc3.bias": ("bg3", False),
}
_SHAPE_DISC_KEYS = {f"fc{i}.{kind}": (f"{kind[0]}{i}", kind == "weight")
                    for i in (1, 2, 3) for kind in ("weight", "bias")}


def _disc_from_jax(disc: nn.Module, params: Mapping, keys, device) -> nn.Module:
    with torch.no_grad():
        for name, p in disc.named_parameters():
            key, transposed = keys[name]
            a = np.array(params[key], np.float32)
            p.copy_(torch.as_tensor(a.T if transposed else a))
    return disc.to(resolve_device(device))


def _disc_to_jax(disc: nn.Module, tensors, keys) -> Dict[str, np.ndarray]:
    """Tensors laid out like `disc.parameters()` (the parameters, or an
    `_Adam`'s moments) → jrr_tpu's param dict."""
    out = {}
    for (name, _), t in zip(disc.named_parameters(), tensors):
        key, transposed = keys[name]
        a = t.detach().cpu().numpy()
        out[key] = np.ascontiguousarray(a.T) if transposed else a
    return out


def pose_discriminator(params: Mapping, device="cuda") -> disc_lib.PoseDiscriminator:
    """JAX pose-discriminator param dict (w1, b1, w2, b2, wj, bj, wg1…bg3)."""
    return _disc_from_jax(disc_lib.PoseDiscriminator(device="cpu"), params, _POSE_DISC_KEYS, device)


def shape_discriminator(params: Mapping, device="cuda") -> disc_lib.ShapeDiscriminator:
    """JAX shape-discriminator param dict (w1, b1, w2, b2, w3, b3)."""
    return _disc_from_jax(disc_lib.ShapeDiscriminator(device="cpu"), params, _SHAPE_DISC_KEYS,
                          device)


def image_discriminator_from_jax(params: Mapping, device="cuda") -> imgd_lib.ImageDiscriminator:
    """JAX image-discriminator param dict (w0…w3, b0…b3 with HWIO kernels,
    w_out, b_out) → `models.image_discriminator.ImageDiscriminator`."""
    disc = imgd_lib.ImageDiscriminator(device="cpu")
    convs = list(disc.convs) + [disc.out]
    names = [str(i) for i in range(len(disc.convs))] + ["_out"]
    with torch.no_grad():
        for conv, n in zip(convs, names):
            conv.weight.copy_(torch.as_tensor(_conv_weight(params[f"w{n}"])))
            conv.bias.copy_(torch.as_tensor(_np(params[f"b{n}"])))
    return disc.to(resolve_device(device))


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
    like the parameters (`to_params` maps a JAX tree to a list), its int32
    count on the device as the trainer keeps it."""
    opt = engine._Adam(params, lr, device_count=True)
    opt.set_count(int(np.array(moments.count)))
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


_DISCS = (("pose_disc", _POSE_DISC_KEYS), ("shape_disc", _SHAPE_DISC_KEYS))


def train_state_arrays(state: trainer.TrainState) -> Dict[str, np.ndarray]:
    """The port's `TrainState` → the arrays of jrr_tpu's TrainState
    (jrr_tpu/refine/trainer.py:45-52) as its npz checkpoint holds them,
    keyed by `jax.tree_util.keystr` of each leaf: ".j_reg_raw", ".step",
    ".jreg_opt[0].count" / ".mu" / ".nu" (optax's ScaleByAdamState, the
    first entry of adam's chain), ".pose_disc['w1']",
    ".pose_disc_opt[0].mu['w1']", ... Counts and the step are int32."""
    # int() reads a count on the device as well as a Python int.
    i32 = lambda x: np.asarray(int(x), np.int32)  # noqa: E731
    opt = state.jreg_opt
    out = {
        ".j_reg_raw": state.j_reg_raw.detach().cpu().numpy(), ".step": i32(state.step),
        ".jreg_opt[0].count": i32(opt.count),
        ".jreg_opt[0].mu": opt.m[0].detach().cpu().numpy(),
        ".jreg_opt[0].nu": opt.v[0].detach().cpu().numpy(),
    }
    for field, keys in _DISCS:
        disc, opt = getattr(state, field), getattr(state, f"{field}_opt")
        out[f".{field}_opt[0].count"] = i32(opt.count)
        for prefix, tensors in ((f".{field}", list(disc.parameters())),
                                (f".{field}_opt[0].mu", opt.m), (f".{field}_opt[0].nu", opt.v)):
            out.update({f"{prefix}['{k}']": a for k, a in _disc_to_jax(disc, tensors, keys).items()})
    return out


def train_state_from_arrays(arrays: Mapping, cfg: config_lib.PipelineConfig,
                            device="cuda") -> trainer.TrainState:
    """jrr_tpu's TrainState arrays, keyed as `train_state_arrays` writes them
    (e.g. np.load of a jrr_tpu `state_<step>.npz`) → the port's, with the
    learning rates of `cfg`."""

    def tree(prefix, keys):
        return {key: arrays[f"{prefix}['{key}']"] for key, _ in keys.values()}

    def adam(prefix, keys=None):
        get = (lambda m: arrays[f"{prefix}[0].{m}"]) if keys is None else (  # noqa: E731
            lambda m: tree(f"{prefix}[0].{m}", keys))
        return (types.SimpleNamespace(count=arrays[f"{prefix}[0].count"], mu=get("mu"),
                                      nu=get("nu")),)

    src = types.SimpleNamespace(
        j_reg_raw=arrays[".j_reg_raw"], jreg_opt=adam(".jreg_opt"), step=arrays[".step"],
        **{f: tree(f".{f}", keys) for f, keys in _DISCS},
        **{f"{f}_opt": adam(f".{f}_opt", keys) for f, keys in _DISCS},
    )
    return train_state(src, cfg, device=device)


# --- Flax variables of the SPIN and consumer models (the inverse of
# jrr_tpu's torch-checkpoint converters, models/{spin,temporal,meva}.py) ---


def _np(x) -> np.ndarray:
    return np.array(x, np.float32)


def _conv_weight(kernel) -> np.ndarray:
    """flax conv kernel (H, W, I, O) → torch (O, I, H, W)."""
    return np.transpose(_np(kernel), (3, 2, 0, 1))


def _dense(sd, key: str, p) -> None:
    sd[f"{key}.weight"] = _np(p["kernel"]).T
    sd[f"{key}.bias"] = _np(p["bias"])


def _backbone(sd, prefix: str, params, stats) -> None:
    """flax `ResNet50` params + batch_stats → hmr's names under `prefix`."""
    def bn(key, p, s):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _np(p["scale"]), _np(p["bias"])
        sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = _np(s["mean"]), _np(s["var"])

    sd[f"{prefix}conv1.weight"] = _conv_weight(params["conv1"]["kernel"])
    bn(f"{prefix}bn1", params["BatchNorm_0"], stats["BatchNorm_0"])
    for stage, (blocks, _, _) in enumerate(spin_lib.STAGES):
        for b in range(blocks):
            key, name = f"{prefix}layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            p, s = params[name], stats[name]
            for ci in range(1, 4):
                sd[f"{key}.conv{ci}.weight"] = _conv_weight(p[f"conv{ci}"]["kernel"])
                bn(f"{key}.bn{ci}", p[f"BatchNorm_{ci - 1}"], s[f"BatchNorm_{ci - 1}"])
            if "downsample_conv" in p:
                sd[f"{key}.downsample.0.weight"] = _conv_weight(p["downsample_conv"]["kernel"])
                bn(f"{key}.downsample.1", p["BatchNorm_3"], s["BatchNorm_3"])


def _head(sd, prefix: str, head) -> None:
    for lin in ("fc1", "fc2", "decpose", "decshape", "deccam"):
        _dense(sd, f"{prefix}{lin}", head[lin])


def _gru_layer(sd, key: str, suffix: str, cell) -> None:
    """A flax GRUCell's params → torch's layer tensors, gates in [r, z, n].

    jrr_tpu's converter folds torch's two r and z biases into one,
    b_ir + b_hr and b_iz + b_hz (temporal.py:138-156); flax adds that one
    bias on the input side. Here the sum goes to bias_ih and bias_hh's r
    and z parts are 0: σ(W x + (b_i + b_h) + U h) is the same function. The
    candidate gate keeps b_in on the input and b_hn inside r·(U_n h + b_hn),
    as both packages do."""
    gates = ("r", "z", "n")
    sd[f"{key}.weight_ih_{suffix}"] = np.concatenate([_np(cell[f"i{g}"]["kernel"]).T for g in gates])
    sd[f"{key}.weight_hh_{suffix}"] = np.concatenate([_np(cell[f"h{g}"]["kernel"]).T for g in gates])
    sd[f"{key}.bias_ih_{suffix}"] = np.concatenate([_np(cell[f"i{g}"]["bias"]) for g in gates])
    hn = _np(cell["hn"]["bias"])
    sd[f"{key}.bias_hh_{suffix}"] = np.concatenate([np.zeros_like(hn), np.zeros_like(hn), hn])


def _encoder(sd, encoder, n_layers: int, bidirectional: bool) -> None:
    for k in range(n_layers):
        _gru_layer(sd, "encoder.gru", f"l{k}", encoder[f"gru_l{k}"])
        if bidirectional:
            _gru_layer(sd, "encoder.gru", f"l{k}_reverse", encoder[f"gru_l{k}_rev"])
    _dense(sd, "encoder.linear", encoder["linear"])


def _load(module: nn.Module, sd, device) -> nn.Module:
    convert_util.load_module(module, convert_util.StateDictView(sd, "flax variables"))
    return module.eval().to(resolve_device(device))


def spin_model(variables: Mapping, device="cuda") -> spin_lib.SPIN:
    """JAX `SPIN` flax variables ({"params", "batch_stats"}, arrays as numpy
    or anything `np.asarray` takes) → `models.spin.SPIN` on `device`."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    _backbone(sd, "", params["backbone"], stats["backbone"])
    _head(sd, "", params["head"])
    for name in ("init_pose", "init_shape", "init_cam"):
        sd[name] = _np(params[name])
    return _load(convert_util.empty_module(spin_lib.SPIN), sd, device)


def temporal_model(variables: Mapping, meta: Mapping, device="cuda") -> temporal_lib.TemporalPoseModel:
    """JAX `TemporalPoseModel` flax variables → the port's, with the layout
    `meta` of `consumers.sniff_temporal_layout` (hidden_size, n_layers,
    bidirectional)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    _backbone(sd, "backbone.", params["backbone"], stats["backbone"])
    _encoder(sd, params["encoder"], meta["n_layers"], meta["bidirectional"])
    _head(sd, "regressor.", params["head"])
    for name in ("init_pose", "init_shape", "init_cam"):
        sd[f"regressor.{name}"] = _np(params[name])
    model = convert_util.empty_module(lambda: temporal_lib.TemporalPoseModel(
        hidden_size=meta["hidden_size"], n_layers=meta["n_layers"],
        bidirectional=meta["bidirectional"]))
    return _load(model, sd, device)


def meva_model(variables: Mapping, meta: Mapping, device="cuda") -> meva_lib.MEVAPoseModel:
    """JAX `MEVAPoseModel` flax variables → the port's (`meta` as for
    `temporal_model`, plus latent_dim and vae_hidden). A flax init of
    MEVAPoseModel holds no VAE encoder (its forward only decodes); then the
    port's `enc_gru`, `e_mu` and `e_logvar` are zeros, which its forward
    never reads either."""
    params, stats = variables["params"], variables["batch_stats"]
    latent, hidden = meta["latent_dim"], meta["vae_hidden"]
    sd = {}
    _backbone(sd, "backbone.", params["backbone"], stats["backbone"])
    _encoder(sd, params["encoder"], meta["n_layers"], meta["bidirectional"])
    vae = params["vae_model"]
    model = convert_util.empty_module(lambda: meva_lib.MEVAPoseModel(
        hidden_size=meta["hidden_size"], n_layers=meta["n_layers"],
        bidirectional=meta["bidirectional"], latent_dim=latent, vae_hidden=hidden))
    for name, value in model.vae_model.state_dict().items():
        sd[f"vae_model.{name}"] = np.zeros(tuple(value.shape), np.float32)
    if "enc_gru_l0" in vae:
        _gru_layer(sd, "vae_model.enc_gru", "l0", vae["enc_gru_l0"])
        _dense(sd, "vae_model.e_mu", vae["e_mu"])
        _dense(sd, "vae_model.e_logvar", vae["e_logvar"])
    _gru_layer(sd, "vae_model.d_gru", "l0", vae["d_gru"])
    for lin in ("d_init", "d_out"):
        _dense(sd, f"vae_model.{lin}", vae[lin])
    _dense(sd, "feat_to_latent", params["feat_to_latent"])
    _head(sd, "regressor.", params["regressor"])
    sd["regressor.init_pose"] = np.zeros((1, spin_lib.NUM_POSE_PARAMS), np.float32)
    for name in ("init_shape", "init_cam"):
        sd[f"regressor.{name}"] = _np(params[name])
    return _load(model, sd, device)
