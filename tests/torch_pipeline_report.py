"""Measure, on the CPU, how far the port's product loop lies from jrr_tpu's,
and the host costs of its data path. Prints one JSON line per section:

    python tests/torch_pipeline_report.py      (~3 minutes)

- `host` (in a process without JAX): the zlib compression of a 1000²
  fixture-like frame at levels 1 and 6, and the milliseconds per dataset
  item (two PNG reads, two crops) of a port-written fixture directory
  (filter 0) and of a JAX-written one (imageio's adaptive filters);
- `grids`: jnp.linspace(-1, 1, n) against the correctly rounded
  −(1 − i/(n−1)) + i/(n−1), and the largest gap between the two packages'
  warp grids;
- `pipeline`: both packages' run_pipeline(demo=True) on one JAX-written
  fixture directory, without and with the silhouette (the configurations
  of test_torch_pipeline.py): the largest gaps in refined parameters,
  regressors and evals, and JAX's float32 lstsq solve against the port's
  float64 one on one accumulator;
- `float_spread`: the first batch refined at 112² with 3 stage-B steps by
  both packages in float32 and float64 (interior skip off: JAX's float64
  path does not run with it): each package's float32-float64 spread and
  the gap between the two float64 runs.

The numbers back the tolerances of tests/test_torch_{data,pipeline}.py.
The script sits beside them because it drives both packages through their
helpers (tests/conftest.py, test_torch_pipeline.py); the port's own tools
(tools/torch_*.py) import no JAX.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from jrr_tpu_torch import convert, pipeline  # noqa: E402
from jrr_tpu_torch.data import fixtures, h36m, png  # noqa: E402
from jrr_tpu_torch.models import smpl  # noqa: E402
from jrr_tpu_torch.ops import sampling  # noqa: E402
from jrr_tpu_torch.refine import engine, trainer  # noqa: E402
from jrr_tpu_torch.utils import checkpoint as ckpt  # noqa: E402


def _jax():
    """JAX on the CPU and the JAX-side modules (imported only where needed:
    the host costs are measured in a process without JAX)."""
    import conftest  # noqa: F401  (JAX on the CPU)
    import test_torch_pipeline as tp

    return tp


class _Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def _fixture_root(tmp):
    from jrr_tpu.data import fixtures as jfixtures
    from jrr_tpu.models import smpl as jsmpl

    root = os.path.join(tmp, "fixtures")
    model = jsmpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500)
    j_true = pipeline._demo_regressor(model.num_verts, np.random.default_rng(0))
    jfixtures.write_fixture_dataset(root, num_frames=8, seed=0, model=model, j_reg_raw=j_true)
    return root, model, j_true


def host(root):
    """Measured in a child process that imports no JAX."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--host", root],
                          capture_output=True, text=True, check=True, cwd=ROOT)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _host(root):
    rng = np.random.default_rng(0)
    frame = np.zeros((1000, 1000), np.float32)
    frame[300:800, 200:700] = rng.uniform(size=(500, 500)) > 0.3
    img = (np.stack([frame] * 3, -1) * 255).astype(np.uint8)
    rows = np.zeros((1000, 3001), np.uint8)
    rows[:, 1:] = img.reshape(1000, -1)
    out = {}
    for level in (1, 6):
        t0 = time.perf_counter()
        for _ in range(5):
            zlib.compress(rows.tobytes(), level)
        out[f"encode_level{level}_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    png.encode(img)
    out["png_encode_ms"] = (time.perf_counter() - t0) * 1e3
    port_root = os.path.join(os.path.dirname(root), "port_fixtures")
    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    fixtures.write_fixture_dataset(port_root, num_frames=8, seed=0, model=model)
    for name, where in (("port_written", port_root), ("imageio_written", root)):
        ds = h36m.H36MDataset(where)
        ds[0]
        t0 = time.perf_counter()
        for _ in range(3):
            for i in range(len(ds)):
                ds[i]
        out[f"dataset_item_ms_{name}"] = (time.perf_counter() - t0) / (3 * len(ds)) * 1e3
    return out


def grids():
    import jax.numpy as jnp
    from jrr_tpu.ops import sampling as jsampling

    out = {}
    for n in (224, 256):
        i = np.arange(n - 1, dtype=np.float32)
        step = i / np.float32(n - 1)
        rounded = (-(np.float32(1) - step) + step).astype(np.float32)
        out[f"linspace_{n}_points_differing"] = int(
            (np.asarray(jnp.linspace(-1.0, 1.0, n))[:-1] != rounded).sum())
    rng = np.random.default_rng(4)
    hom = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    hom[:, :2, :2] += rng.normal(scale=0.2, size=(2, 2, 2))
    hom[:, :2, 2] = rng.normal(scale=0.3, size=(2, 2))
    hom[:, 2, :2] = rng.normal(scale=0.05, size=(2, 2))
    got = sampling.make_warp_grid(torch.as_tensor(hom), (224, 200)).numpy()
    out["warp_grid_max_gap"] = float(np.abs(got - np.asarray(jsampling.make_warp_grid(
        hom, (224, 200)))).max())
    return out


def _gaps(jarts, arts, jlstsq):
    tp = _jax()
    out = {}
    for k in tp.PARAMS:
        out[k] = max(float(np.abs(g[k] - w[k]).max())
                     for g, w in zip(tp._shards(arts.out_dir), tp._shards(jarts.out_dir)))
    out["j_reg_final_rel"] = float(np.linalg.norm(arts.j_reg_final - jarts.j_reg_final)
                                   / np.linalg.norm(jarts.j_reg_final))
    out["j_reg_lstsq"] = float(np.abs(arts.j_reg_lstsq - jarts.j_reg_lstsq).max())
    pairs = (("initial", arts.eval_before_after.before, jarts.eval_before_after.before),
             ("adam_final", arts.eval_before_after.after, jarts.eval_before_after.after),
             ("lstsq", arts.eval_lstsq, jlstsq))
    for name, g, w in pairs:
        out[f"eval_{name}_mm"] = max(abs(g.mpjpe - w.mpjpe), abs(g.pa_mpjpe - w.pa_mpjpe))
    return out


def _lstsq_solves(arts, root):
    """JAX's float32 solve against the port's float64 solve, one accumulator."""
    import jax.numpy as jnp
    from jrr_tpu.refine import trainer as jtrainer

    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    manifest = ckpt.ShardManifest(os.path.join(arts.out_dir, "refined"))
    acc = trainer.JRegLstsqAccumulator.zero(256, device="cpu")
    for sid, batch in enumerate(h36m.BatchLoader(h36m.H36MDataset(root), 4, drop_last=True)):
        acc = pipeline._replay_shard(manifest, sid, batch, model, acc)
    w64 = trainer.jreg_lstsq_solve(acc).numpy()
    w32 = np.asarray(jtrainer.jreg_lstsq_solve(
        jtrainer.JRegLstsqAccumulator(*(jnp.asarray(x.numpy()) for x in acc)), 1e-4))
    return float(np.abs(w32 - w64).max())


def pipelines(tmp, root):
    tp = _jax()
    out = {}
    for name, cfg in (("no_silhouette", tp._jax_cfg(False, 15)),
                      ("silhouette_112", tp._jax_cfg(True, 3, image_size=112))):
        run_dir = os.path.join(tmp, name)
        os.makedirs(run_dir)
        jarts, arts, jlstsq = tp._run_both(Path(run_dir), _Patch(), cfg, root)
        out[name] = _gaps(jarts, arts, jlstsq)
        out[name]["lstsq_f32_vs_f64_same_acc"] = _lstsq_solves(arts, root)
    return out


def _double(t):
    return t.double() if torch.is_tensor(t) and t.is_floating_point() else t


def _f64(x):
    x = np.asarray(x)
    return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x


def float_spread(root, jmodel, j_true):
    import jax
    import jax.numpy as jnp
    from jrr_tpu.refine import engine as jengine
    from jrr_tpu.refine import losses as jlosses
    from jrr_tpu.refine import trainer as jtrainer

    tp = _jax()
    jcfg = tp._jax_cfg(True, 3, image_size=112)
    sil = dataclasses.replace(jcfg.refiner.silhouette, interior_skip=False)
    jcfg = dataclasses.replace(jcfg, refiner=dataclasses.replace(jcfg.refiner, silhouette=sil))
    tcfg = convert.pipeline_config(jcfg)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jnp.asarray(j_true), jcfg)
    state = convert.train_state(jstate, tcfg, device="cpu")
    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    model64 = dataclasses.replace(
        model, **{f.name: _double(getattr(model, f.name)) for f in dataclasses.fields(model)})
    batch = next(iter(h36m.BatchLoader(h36m.H36MDataset(root), 4, drop_last=True)))
    init, data = pipeline._batch_to_device_inputs(batch, tcfg, torch.device("cpu"))
    port32 = engine.refine_batch(model, state.j_reg_raw, init, data, tcfg.refiner,
                                 state.pose_disc, state.shape_disc).params
    port64 = engine.refine_batch(
        model64, state.j_reg_raw.double(), type(init)(*map(_double, init)),
        type(data)(*map(_double, data)), tcfg.refiner,
        copy.deepcopy(state.pose_disc).double(), copy.deepcopy(state.shape_disc).double()).params
    ji = jlosses.FrameParams(*(x.numpy() for x in init))
    jd = jlosses.FrameBatch(*(x.numpy() for x in data))
    jax32 = jengine.refine_batch(jmodel, jnp.asarray(j_true), ji, jd, jcfg.refiner,
                                 jstate.pose_disc, jstate.shape_disc).params
    host = jax.tree.map(np.asarray, (jmodel, j_true, ji, jd, jstate.pose_disc,
                                     jstate.shape_disc))
    with jax.enable_x64(True):
        args = jax.tree.map(lambda x: jnp.asarray(_f64(x)), host)
        jax64 = jengine.refine_batch(args[0], args[1], args[2], args[3], jcfg.refiner,
                                     args[4], args[5]).params
        jax64 = jax.tree.map(np.asarray, jax64)

    def gap(a, b):
        return max(float(np.abs(np.asarray(getattr(a, k), np.float64)
                                - np.asarray(getattr(b, k), np.float64)).max())
                   for k in jlosses.FrameParams._fields)

    t = lambda p: type(p)(*(x.numpy() for x in p))  # noqa: E731
    return {
        "jax_f32_vs_f64": gap(jax32, jax64),
        "port_f32_vs_f64": gap(t(port32), t(port64)),
        "port_f64_vs_jax_f64": gap(t(port64), jax64),
        "port_f32_vs_jax_f32": gap(t(port32), jax32),
    }


def main():
    if sys.argv[1:2] == ["--host"]:
        print(json.dumps(_host(sys.argv[2])))
        return
    _jax()
    with tempfile.TemporaryDirectory() as tmp:
        root, jmodel, j_true = _fixture_root(tmp)
        print(json.dumps({"host": host(root)}), flush=True)
        print(json.dumps({"grids": grids()}), flush=True)
        print(json.dumps({"pipeline": pipelines(tmp, root)}), flush=True)
        print(json.dumps({"float_spread": float_spread(root, jmodel, j_true)}), flush=True)


if __name__ == "__main__":
    main()
