"""CPU tests of the benchmark (`python -m pytest benchmark/tests -q`): tiny
sizes, the port run eagerly on the CPU, nothing that needs a card."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(cell, *, silhouette=None, verts=300, faces=100, batch=4, pool=2, steps=2,
         stage_a=5, stage_b=8, unbounded=False):
    """A cell cut to a CPU test's size: a small body, few steps, a small
    pool. `unbounded` raises the rasterizer's capacities (candidates a
    tile, tiles a face, pages a tile) past what the small body needs."""
    config = copy.deepcopy(cell.config)
    config["body"].update(num_verts=verts, num_faces=faces)
    r = config["pipeline"]["refiner"]
    r.update(stage_a_steps=stage_a, stage_b_steps=stage_b)
    if silhouette is not None:
        r["use_silhouette"] = silhouette
    if unbounded:
        r["silhouette"].update(faces_per_tile=256, max_tiles_per_face=16, pages_per_tile=32)
    traffic = dict(cell.traffic, batch=batch, pool_batches=pool)
    limits = dict(cell.limits, steps=steps)
    return cell._replace(config=config, traffic=traffic, limits=limits)


@pytest.fixture
def tiny_cell():
    from benchmark import harness

    def make(name="outer.nosil.b256", **kwargs):
        """A cell of BENCHMARK.json by name, cut to a CPU test's size."""
        return tiny(harness.load_cell(name), **kwargs)

    return make
