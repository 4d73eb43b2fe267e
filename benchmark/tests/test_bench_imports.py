"""What a run may load: no top-level `jax`, `jaxlib`, `flax` or `jrr_tpu`
anywhere in the benchmark, nothing of the port in the reference; and a run
without a card, or without the port beside it, prints no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(harness.ROOT)


def _python(code, cwd=ROOT):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_port_load_no_jax():
    names = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]]
    code = (
        "import sys, json\n"
        "from benchmark import harness, program, scene, check, trace, roofline, calibrate\n"
        f"[harness.metric_reader(n) for n in {names!r}]\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    top = set(_python(code))
    assert "jrr_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "jrr_tpu"}


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys, json\n"
        "from benchmark.reference import body, raster, outer\n"
        "from benchmark import check, scene, roofline\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    top = set(_python(code))
    assert not top & {"jax", "jaxlib", "flax", "jrr_tpu", "jrr_tpu_torch"}


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "outer.nosil.b256", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
