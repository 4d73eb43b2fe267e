"""The port stands alone: no module of jrr_tpu_torch, no line of
chip_smoke.py and no port tool (tools/torch_*.py) imports JAX, the JAX
package or h5py; importing every module loads neither them nor scipy or
matplotlib (the SMPL converter needs no scipy, viz imports matplotlib
when it draws); and entry points that create state refuse to fall back to
the CPU when no card is present."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "jrr_tpu_torch"
# h5py too: the port reads HDF5 with its own reader (data/hdf5.py).
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "jrr_tpu", "h5py")
# Imported by no module at import time (a lazy import inside a function is allowed).
NOT_EAGER = ("scipy", "matplotlib")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _port_modules():
    return (
        sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        + sorted((ROOT / "tools").glob("torch_*.py"))
    )


@pytest.mark.parametrize("path", _port_modules(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_checks_cover_the_probes():
    names = {str(p.relative_to(ROOT)) for p in _port_modules()}
    for probe in ("__init__", "kernel_probe", "kernel_probe2", "bf16_probe"):
        assert f"jrr_tpu_torch/probes/{probe}.py" in names


def test_importing_every_module_loads_no_jax():
    mods = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PKG.rglob("*.py"))
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + NOT_EAGER!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_state_entry_points_need_a_card_or_cpu(monkeypatch):
    import numpy as np

    from jrr_tpu_torch import assets, problem
    from jrr_tpu_torch.data import perturbation
    from jrr_tpu_torch.models import discriminator, image_discriminator, smpl
    from jrr_tpu_torch.ops import rotations
    from jrr_tpu_torch.probes import bf16_probe, kernel_probe, kernel_probe2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda **kw: smpl.synthetic_smpl_model(num_verts=96, num_faces=160, **kw),
        lambda **kw: discriminator.PoseDiscriminator(**kw),
        lambda **kw: discriminator.ShapeDiscriminator(**kw),
        lambda **kw: problem.synthetic_problem(batch=1, num_verts=96, image_size=32, **kw),
        lambda **kw: rotations.random_rotmat(np.random.default_rng(0), (2,), **kw),
        lambda **kw: kernel_probe.make_inputs(16, **kw),
        lambda **kw: kernel_probe2.make_inputs(16, **kw),
        lambda **kw: bf16_probe.make_input(16, **kw),
        lambda **kw: smpl.synthetic_smpl_model(num_verts=96, num_faces=160,
                                               thin_appendage_radius=0.0, **kw),
        lambda **kw: assets.load_retrained_j_regressor(**kw),
        lambda **kw: image_discriminator.ImageDiscriminator(**kw),
        lambda **kw: perturbation.gen_random_perturbation(4, **kw),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")
