"""The port's SPIN initializer (jrr_tpu_torch.models.spin, pipeline.make_spin_fn)
and the rotation, joint and constant tables beside it, against jrr_tpu on
the CPU.

SPIN runs at 64² (ResNet-50 pools globally, so any size above 32 works),
batch 2, with numpy-seeded weights and BatchNorm statistics and numpy-seeded
images; both packages read one torch checkpoint file, or the port takes a
flax variable tree through `convert.spin_model`. Tolerance 1e-4 on pose6d,
betas and cam (JAX's own test against torch allows 2e-3,
tests/test_spin.py:127-129; tests/torch_pipeline_report.py measures 7.9e-6
on the full-head checkpoint of these tests). Rotations:
quaternions 2e-6, axis-angle 2e-5 rad (the near-180° cases included),
joints49's gathered joints exact and its regressed ones 1e-6, the index
maps equal. One JAX SPIN apply is compiled per
input shape and shared through the module's fixtures.
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu import constants as jconstants
from jrr_tpu import pipeline as jpipeline
from jrr_tpu.models import convert_util as jconvert_util
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu.models import spin as jspin
from jrr_tpu.ops import rotations as jrot
from jrr_tpu_torch import config as cfg_lib
from jrr_tpu_torch import constants, convert, pipeline
from jrr_tpu_torch.data import fixtures, h36m
from jrr_tpu_torch.models import convert_util, smpl, spin
from jrr_tpu_torch.ops import rotations

SIZE = 64
TOL = 1e-4
IDENTITY_6D = np.tile(np.asarray([1, 0, 0, 1, 0, 0], np.float32), 24)
# torch's intra-op threads while these networks run: the suite runs six
# test processes on the machine's cores, and ResNet-50 convolutions on all
# cores in each of them slow every process.
TORCH_THREADS = 2


@contextlib.contextmanager
def torch_threads(n=TORCH_THREADS):
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads():
        yield


def spin_state_dict(seed=0, head_scale=1.0):
    """hmr's state dict with numpy-seeded values: convs N(0, 1/fan_in),
    BatchNorm statistics as tests/test_spin.py randomizes them, the dec*
    heads scaled by `head_scale` and a near-identity mean pose."""
    rng = np.random.default_rng(seed)
    model = spin.SPIN()
    norms = {n for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    out = {}
    for name, value in model.state_dict().items():
        shape, (module, leaf) = tuple(value.shape), name.rpartition(".")[::2]
        if leaf == "num_batches_tracked":
            out[name] = value
            continue
        if leaf == "running_mean":
            a = rng.uniform(-0.2, 0.2, shape)
        elif leaf == "running_var":
            a = rng.uniform(0.6, 1.4, shape)
        elif module in norms:
            a = rng.uniform(0.8, 1.2, shape) if leaf == "weight" else rng.normal(scale=0.1, size=shape)
        elif name == "init_pose":
            a = IDENTITY_6D[None] + rng.normal(scale=0.05, size=shape)
        elif name == "init_shape":
            a = rng.normal(scale=0.1, size=shape)
        elif name == "init_cam":
            a = np.asarray([[0.9, 0.0, 0.0]]) + rng.normal(scale=0.01, size=shape)
        elif leaf == "weight":
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = rng.normal(scale=0.05, size=shape)
        if name.startswith("dec"):
            a = a * head_scale
        out[name] = torch.as_tensor(np.asarray(a, np.float32))
    return out


def write_spin_checkpoint(path, seed=0, head_scale=1.0, prefix="", drop=()):
    sd = {prefix + k: v for k, v in spin_state_dict(seed, head_scale).items() if k not in drop}
    torch.save({"model": sd, "epoch": 3, "optimizer": {"state": {}, "param_groups": []}}, path)
    return path


def write_mean_params(path, seed=5):
    rng = np.random.default_rng(seed)
    np.savez(path, pose=(IDENTITY_6D + rng.normal(scale=0.05, size=144)).astype(np.float32),
             shape=rng.normal(scale=0.1, size=10).astype(np.float32),
             cam=np.asarray([0.85, 0.01, -0.02], np.float32))
    return path


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("spin")
    write_spin_checkpoint(str(root / "model_checkpoint.pt"))
    write_spin_checkpoint(str(root / "module_prefixed.pt"), prefix="module.")
    write_spin_checkpoint(str(root / "no_buffers.pt"), drop=("init_pose", "init_shape", "init_cam"))
    write_mean_params(str(root / "smpl_mean_params.npz"))
    # Predictions near the mean parameters: a camera scale near 0.9 keeps
    # the initial depth finite.
    write_spin_checkpoint(str(root / "near_mean.pt"), head_scale=1e-3)
    return root


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return rng.uniform(size=(2, 3, SIZE, SIZE)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_spin():
    """One jitted JAX SPIN apply for every variable tree of the module."""
    model = jspin.SPIN()
    return jax.jit(lambda v, img: model.apply(v, img, train=False))


def _port_outputs(fn, img):
    return [x.numpy() for x in fn(torch.as_tensor(img))]


def _assert_close(got, want, tol=TOL):
    for g, w, name in zip(got, want, ("pose6d", "betas", "cam")):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, err_msg=name)


@pytest.mark.parametrize("case", ["plain", "module_prefix", "mean_params", "no_buffers"])
def test_make_spin_fn_matches_jax(case, ckpt_dir, images):
    """Both packages' make_spin_fn on one file: DataParallel prefixes
    stripped, the npz mean parameters winning over the buffers, and zeros
    with cam (0.9, 0, 0) for a file with neither."""
    name = {"module_prefix": "module_prefixed.pt", "no_buffers": "no_buffers.pt"}.get(
        case, "model_checkpoint.pt")
    path = str(ckpt_dir / name)
    mean = str(ckpt_dir / "smpl_mean_params.npz") if case == "mean_params" else None
    img = np.asarray(spin.normalize_image(torch.as_tensor(images)))
    want = jpipeline.make_spin_fn(path, mean)(jnp.asarray(img))
    got = _port_outputs(pipeline.make_spin_fn(path, mean, device="cpu"), img)
    _assert_close(got, want)
    port = spin.load_spin_checkpoint(path, mean, device="cpu")
    if case == "no_buffers":
        assert torch.equal(port.init_pose, torch.zeros(1, 144))
        assert torch.equal(port.init_cam, torch.tensor([[0.9, 0.0, 0.0]]))
    if case == "mean_params":
        with np.load(mean) as f:
            np.testing.assert_array_equal(port.init_cam.numpy()[0], f["cam"])


def _random_tree(abstract, rng):
    """Numpy-seeded values for a flax variable tree of `abstract`'s shapes."""
    def leaf(path, x):
        names = [getattr(k, "key", "") for k in path]
        if names[-1] == "var":
            return rng.uniform(0.6, 1.4, x.shape).astype(np.float32)
        if names[-1] == "mean":
            return rng.uniform(-0.2, 0.2, x.shape).astype(np.float32)
        if names[-1] == "scale":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        if names[-1] == "kernel":
            return (rng.normal(size=x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        if names[-1] == "init_pose":
            return (IDENTITY_6D[None] + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
        return rng.normal(scale=0.05, size=x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def test_flax_variables_carried_across(jax_spin, images):
    """A flax variable tree of JAX's SPIN (numpy-seeded, every leaf of its
    init), through `convert.spin_model`: the port computes what JAX does."""
    abstract = jax.eval_shape(jspin.SPIN().init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 3, SIZE, SIZE)))
    variables = _random_tree(abstract, np.random.default_rng(3))
    img = np.asarray(spin.normalize_image(torch.as_tensor(images)))
    want = jax_spin(variables, jnp.asarray(img))
    model = convert.spin_model(variables, device="cpu")
    with torch.no_grad():
        got = _port_outputs(model, img)
    _assert_close(got, want)


def test_spin_consumer_matches_jax(ckpt_dir, images):
    """`harness.make_spin_consumer`: SPIN's estimates through SMPL and a
    stacked pair of regressors, as JAX's make_spin_consumer composes them
    (its SPIN apply, then `smpl_joint_fn`; both jitted here)."""
    from jrr_tpu.evals import harness as jharness
    from jrr_tpu_torch.evals import harness

    path = str(ckpt_dir / "near_mean.pt")
    jmodel = jsmpl.synthetic_smpl_model(seed=0, num_verts=64, num_faces=100)
    rng = np.random.default_rng(8)
    j_regs = np.abs(rng.normal(size=(2, 17, 64))).astype(np.float32)
    j_regs /= j_regs.sum(axis=2, keepdims=True)
    img = np.asarray(spin.normalize_image(torch.as_tensor(images)))
    pose6d, betas, _ = jpipeline.make_spin_fn(path)(jnp.asarray(img))
    want = jharness.smpl_joint_fn(jmodel)(pose6d, betas, jnp.asarray(j_regs))
    consumer = harness.make_spin_consumer(convert.smpl_model(jmodel, device="cpu"),
                                          spin.load_spin_checkpoint(path, device="cpu"))
    got = consumer(torch.as_tensor(img), torch.as_tensor(j_regs))
    assert got.shape == (2, 2, 17, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@contextlib.contextmanager
def tf32_flags_seen(seen: set):
    """Adds to `seen` the (matmul, cuDNN) TF32 flags in force at each
    module's forward inside."""
    def hook(module, args, output):
        seen.add((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


@pytest.mark.parametrize("policy", [True, False], ids=["shipped", "policy_taken_out"])
def test_spin_runs_in_float32_whatever_the_flags(policy, ckpt_dir, images):
    """make_spin_fn's network runs with TF32 off for matmuls and cuDNN when
    the process has turned it on (chip_smoke's `_shipped(True)`), and the
    flags are as before afterwards; `_shipped(False)` takes that policy out
    (the TF32 reading chip_smoke reports), and `_backbone_features` catches
    exactly the features `ResNet50.forward` pools."""
    import chip_smoke

    path = str(ckpt_dir / "model_checkpoint.pt")
    fn = pipeline.make_spin_fn(path, device="cpu")
    img = spin.normalize_image(torch.as_tensor(images))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    seen, caught = set(), {}
    with chip_smoke._shipped(policy):
        with tf32_flags_seen(seen), chip_smoke._backbone_features(caught):
            fn(img)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    assert seen == {(not policy, not policy)}
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved
    with torch.inference_mode():
        want = spin.ResNet50.forward(spin.load_spin_checkpoint(path, device="cpu"), img)
    assert torch.equal(caught["features"], want)


def test_spin_entry_points_need_a_card_or_cpu(ckpt_dir, monkeypatch):
    path = str(ckpt_dir / "model_checkpoint.pt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: spin.load_spin_checkpoint(path, **kw),
                 lambda **kw: pipeline.make_spin_fn(path, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")


def test_normalize_image_matches_jax(images):
    np.testing.assert_allclose(spin.normalize_image(torch.as_tensor(images)).numpy(),
                               np.asarray(jspin.normalize_image(jnp.asarray(images))), atol=1e-6)


def test_a_drifted_key_raises_the_same_report(tmp_path):
    """A renamed tensor: both packages raise CheckpointLayoutError with the
    same diff report (the key, the closest names present, the inventory)."""
    sd = spin_state_dict()
    sd["layer2.0.conv_1.weight"] = sd.pop("layer2.0.conv1.weight")
    path = str(tmp_path / "drifted.pt")
    torch.save({"model": sd}, path)
    with pytest.raises(convert_util.CheckpointLayoutError) as got:
        spin.load_spin_checkpoint(path, device="cpu")
    with pytest.raises(jconvert_util.CheckpointLayoutError) as want:
        jspin.convert_torch_spin_checkpoint({k: v.numpy() for k, v in sd.items()})
    assert str(got.value) == str(want.value)
    assert "layer2.0.conv1.weight" in str(got.value) and "layer2.0.conv_1.weight" in str(got.value)


def test_a_tensor_of_another_shape_raises(tmp_path):
    sd = spin_state_dict()
    sd["fc2.weight"] = sd["fc2.weight"][:512]
    path = str(tmp_path / "narrow.pt")
    torch.save(sd, path)
    with pytest.raises(convert_util.CheckpointLayoutError, match="fc2.weight"):
        spin.load_spin_checkpoint(path, device="cpu")


def test_batch_to_device_inputs_with_spin(tmp_path, ckpt_dir):
    """The SPIN path of `_batch_to_device_inputs`, both packages on one
    fixture batch: the initial estimates equal JAX's, the targets are those
    of the stored path."""
    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    root = fixtures.write_fixture_dataset(str(tmp_path), num_frames=2, seed=6, model=model)
    batch = next(iter(h36m.BatchLoader(h36m.H36MDataset(root), 2, shuffle=False)))
    # The crops resized to the module's SPIN input size (the function does
    # not read it), so JAX's compile is shared.
    batch["spin_image"] = torch.nn.functional.interpolate(
        torch.as_tensor(batch["spin_image"]), size=(SIZE, SIZE), mode="bilinear").numpy()
    path = str(ckpt_dir / "near_mean.pt")
    jinit, jdata = jpipeline._batch_to_device_inputs(batch, jpipeline.make_spin_fn(path))
    cfg = cfg_lib.PipelineConfig()
    init, data = pipeline._batch_to_device_inputs(
        batch, cfg, "cpu", spin_fn=pipeline.make_spin_fn(path, device="cpu"))
    for k in init._fields:
        np.testing.assert_allclose(getattr(init, k).numpy(), np.asarray(getattr(jinit, k)),
                                   rtol=1e-5, atol=TOL, err_msg=k)
    _, stored = pipeline._batch_to_device_inputs(batch, cfg, "cpu")
    assert torch.equal(data.gt_j3d, stored.gt_j3d) and torch.equal(data.mask, stored.mask)
    assert init.pose6d.shape == (2, 23, 6) and init.orient6d.shape == (2, 1, 6)
    np.testing.assert_array_equal(data.mask.numpy(), np.asarray(jdata.mask))
    assert not init.cam_t.requires_grad and not init.cam_t.is_inference()


def _near_pi_rotations(rng, n):
    """Rotations at and within 1e-3 rad of 180°, about random axes."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = np.pi - np.concatenate([[0.0, 1e-7, 1e-5], rng.uniform(0, 1e-3, n - 3)])
    return (axis * angle[:, None]).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "near_pi", "near_identity"])
def test_rotation_conversions_match_jax(kind):
    """rotmat_to_quat (Shepperd pivot, w ≥ 0), quat_to_axis_angle and
    rotmat_to_axis_angle against JAX on the same rotation matrices."""
    rng = np.random.default_rng(11)
    if kind == "random":
        rot = np.array(jrot.random_rotmat(jax.random.PRNGKey(0), (64,)))
    else:
        aa = _near_pi_rotations(rng, 64) if kind == "near_pi" else (
            rng.normal(scale=1e-5, size=(64, 3)).astype(np.float32))
        rot = np.array(jrot.axis_angle_to_rotmat(jnp.asarray(aa)))
    r = torch.as_tensor(rot)
    q = rotations.rotmat_to_quat(r)
    np.testing.assert_allclose(q.numpy(), np.asarray(jrot.rotmat_to_quat(jnp.asarray(rot))),
                               atol=2e-6)
    assert torch.all(q[:, 0] >= 0)
    np.testing.assert_allclose(rotations.rotmat_to_axis_angle(r).numpy(),
                               np.asarray(jrot.rotmat_to_axis_angle(jnp.asarray(rot))), atol=2e-5)
    qs = rng.normal(size=(64, 4)).astype(np.float32)  # unnormalized, either sign of w
    np.testing.assert_allclose(rotations.quat_to_axis_angle(torch.as_tensor(qs)).numpy(),
                               np.asarray(jrot.quat_to_axis_angle(jnp.asarray(qs))), atol=2e-5)
    if kind == "near_pi":  # the round trip holds the angle where the trace term vanishes
        back = rotations.axis_angle_to_rotmat(rotations.rotmat_to_axis_angle(r))
        np.testing.assert_allclose(back.numpy(), rot, atol=2e-5)


def test_smpl_joints49_matches_jax():
    """The 45 gathered joints equal JAX's exactly, the 9 regressed ones
    (convex rows, as the real extra regressor's) within 1e-6."""
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(2, 6890, 3)).astype(np.float32)
    joints = rng.normal(size=(2, 24, 3)).astype(np.float32)
    extra = rng.uniform(size=(9, 6890)).astype(np.float32)
    extra /= extra.sum(axis=1, keepdims=True)
    jmodel = dataclasses.replace(
        jsmpl.synthetic_smpl_model(seed=0, num_verts=64, num_faces=100),
        j_regressor_extra=jnp.asarray(extra))
    want = np.asarray(jsmpl.smpl_joints49(
        jmodel, jsmpl.SMPLOutput(jnp.asarray(verts), jnp.asarray(joints), jnp.asarray(verts))))
    model = convert.smpl_model(jmodel, device="cpu")
    t = torch.as_tensor
    got = smpl.smpl_joints49(model, smpl.SMPLOutput(t(verts), t(joints), t(verts))).numpy()
    assert got.shape == (2, 49, 3)
    gathered = np.asarray(smpl.SPIN_49_JOINT_MAP) < 45
    np.testing.assert_array_equal(got[:, gathered], want[:, gathered])
    np.testing.assert_allclose(got[:, ~gathered], want[:, ~gathered], atol=1e-6)
    with pytest.raises(ValueError, match="j_regressor_extra"):
        smpl.smpl_joints49(dataclasses.replace(model, j_regressor_extra=None),
                           smpl.SMPLOutput(t(verts), t(joints), t(verts)))


@pytest.mark.parametrize("name", [
    "IMG_NORM_MEAN", "IMG_NORM_STD", "GT_2_J17", "J17_2_METRO", "H36M_J17_TO_J14_METRO",
    "H36M_TO_J17", "H36M_TO_J14", "J24_TO_J17", "J24_TO_J14",
])
def test_constants_equal_jax(name):
    assert getattr(constants, name) == getattr(jconstants, name)


def test_joint_tables_equal_jax():
    assert smpl.EXTRA_JOINT_VERTEX_IDS == jsmpl.EXTRA_JOINT_VERTEX_IDS
    assert smpl.SPIN_49_JOINT_MAP == jsmpl.SPIN_49_JOINT_MAP


def test_spin_checkpoint_loads_weights_only(ckpt_dir):
    """SPIN's file (tensors, an optimizer dict, the epoch) passes torch's
    weights-only unpickler, which the loader uses."""
    ckpt = torch.load(str(ckpt_dir / "model_checkpoint.pt"), weights_only=True)
    assert ckpt["epoch"] == 3 and "conv1.weight" in ckpt["model"]


def test_pipeline_refuses_a_converted_npz(tmp_path):
    with pytest.raises(ValueError, match="torch SPIN checkpoint"):
        pipeline.make_spin_fn(os.path.join(str(tmp_path), "spin.npz"), device="cpu")
