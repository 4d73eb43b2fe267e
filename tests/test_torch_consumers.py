"""The port's VIBE/MEVA consumers (models/temporal.py, models/meva.py,
evals/consumers.py), their harness (evals/harness.py), the sequence batches
(data/h36m.py) and the CLI's consumer flags, against jrr_tpu on the CPU.

Both packages read the same torch files: a SPIN checkpoint (backbone) and
numpy-seeded gen_state_dicts in VIBE's layout (GRU hidden 8, two layers,
uni- and bidirectional) and MEVA's (also latent 8, VAE hidden 8); inputs
are numpy-seeded 64² crops, batch 2, seqlen 2. Tolerances (in brackets the
gaps tests/torch_pipeline_report.py measures, section `consumers`):
- consumer joints 1e-5 m [≤ 1.0e-7], MEVA's VAE outputs 1e-5 [1.2e-6];
- the harness's MPJPE / PA-MPJPE 1e-3 mm on one fixture directory's
  batches [1.5e-5 on the report's JAX-written directory];
- sequence chunks and batches exact.
One JAX apply is compiled per model and input shape, shared through the
module's fixtures. `run_pipeline` with SPIN initialization and the VIBE
consumer is held against JAX's in test_torch_pipeline.py, beside the other
pipeline runs whose compiles and fixture directory it shares.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu.data import h36m as jh36m
from jrr_tpu.evals import consumers as jconsumers
from jrr_tpu.evals import harness as jharness
from jrr_tpu.models import convert_util as jconvert_util
from jrr_tpu.models import meva as jmeva
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu.models import temporal as jtemporal
from jrr_tpu_torch import cli, convert, pipeline
from jrr_tpu_torch.data import fixtures, h36m
from jrr_tpu_torch.evals import consumers, harness
from jrr_tpu_torch.models import convert_util, meva, smpl, spin, temporal

from tests.test_torch_spin import IDENTITY_6D, _few_threads, _random_tree  # noqa: F401
from tests.test_torch_spin import tf32_flags_seen, write_spin_checkpoint

SIZE, SEQLEN, H = 64, 2, 8
KINDS = ("vibe", "vibe_bidirectional", "meva")
CONSUMER_TOL = 1e-5


def gen_state_dict(kind, seed=1):
    """A gen_state_dict of `kind` at hidden H: GRU and linear weights
    N(0, 1/fan_in), the IEF head scaled by 0.01 (as
    tests/test_consumer_cli.py fabricates it), the decoders biased to the
    identity pose; VIBE's also holds a key of its SMPL buffers, which both
    loaders ignore."""
    rng = np.random.default_rng(seed)
    if kind == "meva":
        model = meva.MEVAPoseModel(hidden_size=H, n_layers=2, latent_dim=H, vae_hidden=H)
    else:
        model = temporal.TemporalPoseModel(hidden_size=H, n_layers=2,
                                           bidirectional=kind == "vibe_bidirectional")
    out = {}
    for name, value in model.state_dict().items():
        shape = tuple(value.shape)
        if name.startswith("backbone.") or (kind == "meva" and name == "regressor.init_pose"):
            continue
        if name == "regressor.init_pose" or name == "vae_model.d_out.bias":
            a = IDENTITY_6D.reshape(shape) + rng.normal(scale=0.05, size=shape)
        elif name == "regressor.init_cam":
            a = np.asarray([[0.9, 0.0, 0.0]])
        elif name.endswith("weight") and value.ndim == 2:
            a = rng.normal(size=shape) / np.sqrt(shape[1])
        else:
            a = rng.normal(scale=0.05, size=shape)
        if name.startswith("regressor.") and "init" not in name:
            a = a * 0.01
        out[name] = torch.as_tensor(np.asarray(a, np.float32))
    if kind != "meva":
        out["regressor.smpl.v_template"] = torch.zeros(6890, 3)
    return out


def _meta(kind):
    meta = {"hidden_size": H, "n_layers": 2, "bidirectional": kind == "vibe_bidirectional"}
    if kind == "meva":
        meta.update(latent_dim=H, vae_hidden=H)
    return meta


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The SPIN checkpoint and one gen_state_dict file per kind, saved as the
    published files are: the generator under 'gen_state_dict' beside a
    numpy float64 'performance'."""
    root = tmp_path_factory.mktemp("consumers")
    out = {"spin": write_spin_checkpoint(str(root / "spin.pt"), head_scale=1e-3)}
    for seed, kind in enumerate(KINDS, start=1):
        out[kind] = str(root / f"{kind}.pth.tar")
        torch.save({"gen_state_dict": gen_state_dict(kind, seed), "performance": np.float64(56.5),
                    "epoch": 3}, out[kind])
    return out


@pytest.fixture(scope="module")
def backbone(files):
    """The ResNet-50 state of the SPIN file, read once, as run_pipeline
    reads it for every consumer."""
    return consumers._spin_backbone_variables(files["spin"])


@pytest.fixture(scope="module")
def bodies():
    jmodel = jsmpl.synthetic_smpl_model(seed=0, num_verts=64, num_faces=100)
    return jmodel, convert.smpl_model(jmodel, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    j_reg = np.abs(rng.normal(size=(17, 64))).astype(np.float32)
    return {
        "img": rng.normal(size=(2, 3, SIZE, SIZE)).astype(np.float32),
        "video": rng.normal(size=(2, SEQLEN, 3, SIZE, SIZE)).astype(np.float32),
        "j_regs": (j_reg, j_reg * rng.uniform(0.5, 1.5, j_reg.shape).astype(np.float32)),
    }


def _norms(j_regs, xp):
    stack = [r / r.sum(axis=1, keepdims=True) for r in j_regs]
    return xp(np.stack(stack).astype(np.float32))


@pytest.fixture(scope="module")
def jax_consumers(files, bodies):
    """JAX's (consumer, seq_consumer, meta) per kind, built once: each jitted
    consumer compiles once per input shape for the whole module."""
    jmodel, _ = bodies
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = jconsumers.build_consumer(
                "meva" if kind == "meva" else "vibe", files[kind], jmodel,
                spin_checkpoint=files["spin"], seqlen=SEQLEN)
        return cache[kind]

    return get


@pytest.fixture(scope="module")
def jax_outputs(jax_consumers, inputs):
    """JAX's frame and sequence consumers on the shared inputs, per kind."""
    cache = {}

    def get(kind):
        if kind not in cache:
            consumer, seq_consumer, meta = jax_consumers(kind)
            norms = _norms(inputs["j_regs"], jnp.asarray)
            cache[kind] = (np.asarray(consumer(jnp.asarray(inputs["img"]), norms)),
                           np.asarray(seq_consumer(jnp.asarray(inputs["video"]), norms)), meta)
        return cache[kind]

    return get


def _port_outputs(consumer, seq_consumer, inputs):
    norms = _norms(inputs["j_regs"], torch.as_tensor)
    return (consumer(torch.as_tensor(inputs["img"]), norms).numpy(),
            seq_consumer(torch.as_tensor(inputs["video"]), norms).numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_consumers_match_jax(kind, files, backbone, bodies, inputs, jax_outputs):
    """build_consumer on the same files: the frame-level consumer (each frame
    repeated into a seqlen sequence; the port repeats its features) and the
    sequence consumer, both regressors at once."""
    _, model = bodies
    consumer, seq_consumer, meta = consumers.build_consumer(
        "meva" if kind == "meva" else "vibe", files[kind], model, backbone=backbone,
        seqlen=SEQLEN)
    want_frame, want_seq, want_meta = jax_outputs(kind)
    assert meta == want_meta == _meta(kind)
    got_frame, got_seq = _port_outputs(consumer, seq_consumer, inputs)
    assert got_frame.shape == (2, 2, 17, 3) and got_seq.shape == (2, 2, SEQLEN, 17, 3)
    np.testing.assert_allclose(got_frame, want_frame, atol=CONSUMER_TOL)
    np.testing.assert_allclose(got_seq, want_seq, atol=CONSUMER_TOL)


@pytest.mark.parametrize("which", ["frame", "sequence"])
def test_consumers_run_in_float32_whatever_the_flags(which, files, backbone, bodies, inputs):
    """Both consumers run with TF32 off for matmuls (the GRUs, the heads)
    and cuDNN when the process has turned it on (chip_smoke's
    `_shipped(True)`, how it holds them on the card)."""
    import chip_smoke

    built = consumers.build_consumer("meva", files["meva"], bodies[1], backbone=backbone,
                                     seqlen=SEQLEN)
    index, x = (0, inputs["img"]) if which == "frame" else (1, inputs["video"])
    seen = set()
    with chip_smoke._shipped(True), tf32_flags_seen(seen):
        built[index](torch.as_tensor(x), _norms(inputs["j_regs"], torch.as_tensor))
    assert seen == {(False, False)}


def _jax_variables(kind, files):
    """The flax variables JAX's build_consumer makes of the files."""
    sd = jconsumers.load_gen_state_dict(files[kind])
    backbone = jconsumers._spin_backbone_variables(files["spin"])
    meta = _meta(kind)
    if kind == "meva":
        return jmeva.convert_torch_meva_checkpoint(
            sd, backbone_variables=backbone, hidden_size=H, n_layers=2, vae_hidden=H)
    return jtemporal.convert_torch_vibe_checkpoint(
        sd, backbone_variables=backbone, hidden_size=H, n_layers=2,
        bidirectional=meta["bidirectional"])


@pytest.mark.parametrize("kind", KINDS)
def test_flax_variables_carried_across(kind, files, bodies, inputs, jax_outputs):
    """JAX's flax variables of the consumer (its converter's output, GRU
    biases folded) through convert.temporal_model / meva_model: the port's
    consumers compute what JAX's do."""
    _, model = bodies
    variables = jax.tree.map(np.asarray, _jax_variables(kind, files))
    to_port = convert.meva_model if kind == "meva" else convert.temporal_model
    port = to_port(variables, _meta(kind), device="cpu")
    got = _port_outputs(temporal.make_temporal_consumer(model, port, seqlen=SEQLEN),
                        temporal.make_sequence_consumer(model, port), inputs)
    for g, w in zip(got, jax_outputs(kind)):
        np.testing.assert_allclose(g, w, atol=CONSUMER_TOL)


def test_flax_init_carried_across(inputs):
    """A numpy-seeded tree of every leaf of MEVA's flax init, which holds no
    VAE encoder (its forward only decodes), JAX's model.apply against the
    port's forward on the same video. (VIBE's trees, uni- and
    bidirectional, are carried across in test_flax_variables_carried_across.)"""
    jmodel = jmeva.MEVAPoseModel(hidden_size=H, n_layers=2, latent_dim=H, vae_hidden=H)
    video = inputs["video"]
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(video.shape))
    variables = _random_tree(abstract, np.random.default_rng(4))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(video))
    port = convert.meva_model(variables, _meta("meva"), device="cpu")
    with torch.no_grad():
        got = port(torch.as_tensor(video))
    for g, w, name in zip(got, want, ("pose6d", "betas", "cam")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=CONSUMER_TOL, err_msg=name)


def test_motion_vae_matches_jax(files):
    """MEVA's motion VAE alone, encode and decode, from the same file."""
    sd = jconsumers.load_gen_state_dict(files["meva"])
    vae_params = jmeva.convert_torch_meva_checkpoint(
        sd, hidden_size=H, n_layers=2, vae_hidden=H)["params"]["vae_model"]
    seq = np.random.default_rng(9).normal(size=(2, 5, 2048)).astype(np.float32)
    want = jmeva.MotionVAE(latent_dim=H, hidden_size=H).apply({"params": vae_params},
                                                              jnp.asarray(seq))
    vae = meva.MotionVAE(latent_dim=H, hidden_size=H)
    convert_util.load_module(vae, convert_util.StateDictView(torch.load(
        files["meva"], weights_only=False)["gen_state_dict"]), prefix="vae_model.")
    with torch.no_grad():
        got = vae(torch.as_tensor(seq))
    assert got[0].shape == (2, 5, 144)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=CONSUMER_TOL)


def test_gen_files_need_the_full_unpickler(files):
    """Why load_gen_state_dict reads with weights_only=False: the published
    files hold a numpy scalar, which the weights-only unpickler refuses."""
    with pytest.raises(pickle.UnpicklingError):
        torch.load(files["vibe"], weights_only=True)
    sd = consumers.load_gen_state_dict(files["vibe"])
    assert consumers.sniff_temporal_layout(sd) == jconsumers.sniff_temporal_layout(
        jconsumers.load_gen_state_dict(files["vibe"])) == _meta("vibe")


def test_a_drifted_gen_key_raises_the_same_report(tmp_path, backbone, bodies):
    sd = gen_state_dict("vibe")
    sd["encoder.gru.weight_hh_l_1"] = sd.pop("encoder.gru.weight_hh_l1")
    path = str(tmp_path / "drifted.pth.tar")
    torch.save({"gen_state_dict": sd}, path)
    with pytest.raises(convert_util.CheckpointLayoutError) as got:
        consumers.build_consumer("vibe", path, bodies[1], backbone=backbone)
    with pytest.raises(jconvert_util.CheckpointLayoutError) as want:
        jtemporal.convert_torch_vibe_checkpoint(
            {k: v.numpy() for k, v in sd.items()}, hidden_size=H, n_layers=2)
    assert str(got.value) == str(want.value)
    assert "encoder.gru.weight_hh_l1" in str(got.value)


def test_without_spin_the_backbone_is_random_and_warned(files, bodies, inputs, capsys):
    consumer, _, _ = consumers.build_consumer("vibe", files["vibe"], bodies[1])
    assert "RANDOM-initialized" in capsys.readouterr().out
    norms = _norms(inputs["j_regs"], torch.as_tensor)
    assert torch.isfinite(consumer(torch.as_tensor(inputs["img"]), norms)).all()
    state, again = consumers.random_backbone_state(), consumers.random_backbone_state()
    assert state.keys() == spin.ResNet50().state_dict().keys()
    assert all(torch.equal(v, again[k]) for k, v in state.items())
    assert torch.equal(state["bn1.running_var"], torch.ones(64))


def test_consumers_need_a_card_or_cpu(files, backbone, bodies, inputs, monkeypatch):
    """The consumer evals run on the card unless the regressors or `device`
    say otherwise; without a card they raise. build_consumer puts the
    model on the body model's device (here the CPU)."""
    consumer, _, _ = consumers.build_consumer("vibe", files["vibe"], bodies[1], backbone=backbone)
    out = consumer(torch.as_tensor(inputs["img"]), _norms(inputs["j_regs"], torch.as_tensor))
    assert out.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    j_regs = [np.ones((17, 64), np.float32)] * 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.evaluate_consumer({"vibe": consumer}, [], *j_regs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.evaluate_consumer_sequences({"vibe": consumer}, [], *j_regs)
    assert harness.evaluate_consumer({}, [], *j_regs, device="cpu") == {}


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """8 fixture frames in two sequences, written by the port (both
    harnesses read the same batches, loaded once)."""
    root = str(tmp_path_factory.mktemp("fixtures"))
    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    return fixtures.write_fixture_dataset(root, num_frames=8, seed=0, model=model, device="cpu")


def _normalized(batch):
    """Normalized crops, resized 224² → 64² to the module's consumer input
    size (the harness does not read the image size; the JAX consumers'
    compiles are shared)."""
    img = torch.nn.functional.interpolate(torch.as_tensor(batch["spin_image"]), size=(SIZE, SIZE),
                                          mode="bilinear", align_corners=False)
    return dict(batch, spin_image=spin.normalize_image(img).numpy())


@pytest.fixture(scope="module")
def harness_batches(fixture_root):
    """The fixture directory's batches, read once: two frame batches of 2
    and sequence batches of two 2-frame chunks."""
    ds = h36m.H36MDataset(fixture_root)
    batches = [_normalized(b) for b in h36m.BatchLoader(ds, 2, drop_last=True)][:2]
    seq_batches = [_normalized(b) for b in h36m.ordered_sequence_batches(
        ds.load_batch, ds.frame_order(), 2 * SEQLEN, SEQLEN)]
    return batches, seq_batches


def test_harness_matches_jax(files, backbone, bodies, inputs, jax_consumers, harness_batches):
    """evaluate_consumer and evaluate_consumer_sequences of both packages on
    the same batches of one fixture directory, with the same consumer
    files; the module's body and regressors."""
    jconsumer, jseq, _ = jax_consumers("vibe")
    consumer, seq, _ = consumers.build_consumer("vibe", files["vibe"], bodies[1],
                                                backbone=backbone, seqlen=SEQLEN)
    j_regs = inputs["j_regs"]
    batches, seq_batches = harness_batches
    pairs = [
        (harness.evaluate_consumer({"vibe": consumer}, batches, *j_regs, device="cpu")["vibe"],
         jharness.evaluate_consumer(jconsumer, batches, *map(jnp.asarray, j_regs))),
        (harness.evaluate_consumer_sequences({"vibe": seq}, seq_batches, *j_regs, seqlen=SEQLEN,
                                             device="cpu")["vibe"],
         jharness.evaluate_consumer_sequences(jseq, seq_batches, *map(jnp.asarray, j_regs),
                                              seqlen=SEQLEN)),
    ]
    for got, want in pairs:
        for g, w in ((got.before, want.before), (got.after, want.after)):
            assert g.num_frames == w.num_frames > 0
            np.testing.assert_allclose([g.mpjpe, g.pa_mpjpe], [w.mpjpe, w.pa_mpjpe], atol=1e-3)
        assert got.summary().count("\n") == want.summary().count("\n")
    assert pairs[0][0].before.num_frames == 4 and pairs[1][0].before.num_frames == 4


def test_one_pass_scores_each_consumer_as_alone(files, backbone, bodies, inputs,
                                                harness_batches):
    """VIBE and MEVA scored together on one pass of the batches (as
    run_pipeline scores them) give each one's results alone, exactly."""
    built = {kind: consumers.build_consumer(kind, files[kind], bodies[1], backbone=backbone,
                                            seqlen=SEQLEN) for kind in ("vibe", "meva")}
    j_regs = inputs["j_regs"]
    for index, batches, evaluate in ((0, harness_batches[0], harness.evaluate_consumer),
                                     (1, harness_batches[1], functools.partial(
                                         harness.evaluate_consumer_sequences, seqlen=SEQLEN))):
        together = evaluate({k: b[index] for k, b in built.items()}, iter(batches), *j_regs,
                            device="cpu")
        assert list(together) == ["vibe", "meva"]
        for kind, b in built.items():
            assert together[kind] == evaluate({kind: b[index]}, batches, *j_regs,
                                              device="cpu")[kind]


def test_sequence_batches_equal_jax(fixture_root):
    """sequence_chunk_indices and ordered_sequence_batches exactly as JAX's:
    on the directory's frame order and on a shuffled order with ragged
    sequences (remainders dropped, never crossing a sequence)."""
    order = h36m.H36MDataset(fixture_root).frame_order()
    rng = np.random.default_rng(5)
    seq_ids = rng.integers(0, 4, size=37)
    frame_nos = rng.permutation(37)
    for ids, nos in (order, (seq_ids, frame_nos)):
        for seqlen in (2, 3, 16):
            got = h36m.sequence_chunk_indices(ids, nos, seqlen)
            want = jh36m.sequence_chunk_indices(ids, nos, seqlen)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
            load = lambda idx: {"i": np.asarray(idx)}  # noqa: E731
            for g, w in zip(h36m.ordered_sequence_batches(load, (ids, nos), 7, seqlen),
                            jh36m.ordered_sequence_batches(load, (ids, nos), 7, seqlen),
                            strict=True):
                np.testing.assert_array_equal(g["i"], w["i"])


def test_cli_runs_the_consumer_evals(tmp_path, files, capsys):
    """`--spin-checkpoint`, `--meva-checkpoint` and `--consumer-seqlen`
    through the CLI on the CPU, with JAX's text blocks (4 port-written
    frames, batch 2; `--vibe-checkpoint` runs the same block, held in
    test_torch_pipeline.py)."""
    root = str(tmp_path / "fixtures")
    fixtures.write_fixture_dataset(root, num_frames=4, seed=0, model=smpl.synthetic_smpl_model(
        seed=0, num_verts=256, num_faces=500, device="cpu"), device="cpu")
    cli.main(["--demo", "--device", "cpu", "--data-root", root,
              "--out", str(tmp_path / "out"), "--stage-a-steps", "3", "--stage-b-steps", "2",
              "--batch-size", "2", "--spin-checkpoint", files["spin"],
              "--meva-checkpoint", files["meva"], "--consumer-seqlen", "2"])
    stdout = capsys.readouterr().out
    assert "\nMEVA\nMPJPE\n" in stdout and "\nMEVA (sequence)\nMPJPE\n" in stdout
    assert "[MEVA] checkpoint layout:" in stdout and "VIBE" not in stdout
    assert "RANDOM-initialized" not in stdout


@pytest.mark.parametrize("argv, seqlen", [
    (["--demo"], 4), (["--data-root", "h36m"], 16), (["--demo", "--consumer-seqlen", "8"], 8),
])
def test_cli_consumer_seqlen_defaults(argv, seqlen, tmp_path, monkeypatch):
    """JAX's defaults (jrr_tpu/cli.py:177-182): 16, or 4 under --demo; every
    consumer flag reaches run_pipeline."""
    seen = {}
    monkeypatch.setattr(pipeline, "run_pipeline", lambda cfg, **kw: seen.update(kw))
    cli.main(argv + ["--out", str(tmp_path), "--device", "cpu", "--spin-checkpoint", "spin.pt",
                     "--spin-mean-params", "mean.npz", "--vibe-checkpoint", "vibe.pth.tar",
                     "--meva-checkpoint", "meva.pth.tar"])
    assert seen["consumer_seqlen"] == seqlen
    assert (seen["spin_checkpoint"], seen["spin_mean_params"], seen["vibe_checkpoint"],
            seen["meva_checkpoint"]) == ("spin.pt", "mean.npz", "vibe.pth.tar", "meva.pth.tar")
