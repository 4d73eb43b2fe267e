"""Coarse-to-fine silhouette schedule probe through the port (counterpart
of tools/c2f_probe.py).

On the shape-mismatch problem of `probes/quality.py` (the silhouette
quality probe's, seed 0), the control refines at a single resolution
(`coarse_frac=0`); each c2f variant runs the engine's coarse-to-fine path
(the first `frac` of stage B at image/factor, tile and bin margin divided
alike, the mask mean-pooled, fresh Adam per phase) with the coarse floor
lowered to `min(112, image // factor)`, since the sweep is what locates that
floor. Quality is scored on the fixed blur-0 spec at the full image.

    python -m jrr_tpu_torch.probes.c2f_probe [--batch 32] [--image 224] [--num-verts 6890]
        [--stage-a 200] [--stage-b 100] [--coarse-frac 0.5] [--coarse-factor 2]
        [--betas-perturb 0.6] [--sweep] [--device cuda]

`--sweep` runs (frac, factor) = (0.5, 2), (0.7, 2), (0.5, 4), then a
three-level chain: 35% of stage B at image/4, 35% at image/2, the rest at
the full image, each phase one single-resolution refinement from the
previous call's params on the mask pooled by the factor, its tile size and
margin divided by it.

Each configuration is one refine program (`engine.compile_refine`, the
counterpart of the tool's `jax.jit`). One JSON line per run with the tool's
keys: the scores, the rasterizer's capacity counters (`truncated_tiles`,
`span_clipped`, `dropped_slots`, `max_faces_per_tile`, the worst rebin),
`seconds` of the program's first call, which captures its CUDA graphs, and
`exec_seconds` of a second, identical call, which replays them (the chain:
the sum of its three programs' first calls), each read after the device
has finished. On the card the kernel library's build or load on first use
(cached under `jrr_tpu_torch/_build/` by the sources' hash) also falls in
the first call's `seconds`. Runs on the card unless
`--device cpu` is given (a missing card raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Tuple

from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.config import RefinerConfig
from jrr_tpu_torch.probes import quality
from jrr_tpu_torch.refine import engine

SWEEP_VARIANTS = ((0.5, 2), (0.7, 2), (0.5, 4))
# The three-level chain: (share of stage B, image divisor) of its first two
# phases; the third takes the rest at the full image.
CHAIN = ((0.35, 4), (0.35, 2))
DIGITS = {"mpjpe_mm": 3, "vert_mm": 3, "sil_mse": 6, "iou": 4, "seconds": 1,
          "exec_seconds": 2}


def rcfg(base: RefinerConfig, stage_a: int, stage_b: int, **sil) -> RefinerConfig:
    """`base` at `stage_a` + `stage_b` steps with silhouette fields replaced."""
    return dataclasses.replace(base, stage_a_steps=stage_a, stage_b_steps=stage_b,
                               silhouette=dataclasses.replace(base.silhouette, **sil))


def c2f_config(base: RefinerConfig, image: int, frac: float, factor: int) -> RefinerConfig:
    """A c2f variant of `base`, its coarse floor lowered to reach
    image // factor."""
    return dataclasses.replace(base, silhouette=dataclasses.replace(
        base.silhouette, coarse_frac=frac, coarse_factor=factor,
        coarse_min_image=min(112, image // factor)))


def stats_dict(res) -> Dict[str, int]:
    """The worst rebin's capacity counters under the tool's names ({} when
    the run made no fused bins)."""
    st = res.bin_stats
    if st is None:
        return {}
    return {"truncated_tiles": int(st.truncated_tiles),
            "span_clipped": int(st.span_clipped_faces),
            "dropped_slots": int(st.dropped_slots),
            "max_faces_per_tile": int(st.max_faces_per_tile)}


def record(problem: quality.QualityProblem, name: str, res, seconds: float, extra=None) -> Dict:
    """One run's line (unrounded): scores, `seconds`, then `extra`."""
    mp, vm, sm, iou = quality.score_result(problem, res.vertices, res.params.cam_t)
    return {"run": name, "mpjpe_mm": mp, "vert_mm": vm, "sil_mse": sm, "iou": iou,
            "seconds": seconds, **(extra or {})}


def measure(problem: quality.QualityProblem, name: str, cfg: RefinerConfig) -> Tuple[Dict, object]:
    """(line, RefineResult) of `cfg`: one program (`engine.compile_refine`)
    called twice on the same inputs, the first call's seconds (its capture
    included) and the second's `exec_seconds` (a replay), the second's
    result scored."""
    program = engine.compile_refine(cfg)
    _, first = quality.refine(problem, cfg, program=program)
    res, again = quality.refine(problem, cfg, program=program)
    return record(problem, name, res, first, {**stats_dict(res), "exec_seconds": again}), res


def three_level(problem: quality.QualityProblem, image: int) -> Tuple[Dict, object]:
    """(line, RefineResult) of the three-level chain (`CHAIN`) over
    problem.cfg's stage counts, each phase one program called once;
    `seconds` sums the three calls."""
    base, sil = problem.cfg, problem.cfg.silhouette
    steps = [int(share * base.stage_b_steps) for share, _ in CHAIN]
    steps.append(base.stage_b_steps - sum(steps))
    factors = [factor for _, factor in CHAIN] + [1]
    cur, total, res = problem.init, 0.0, None
    for k, (stage_b, factor) in enumerate(zip(steps, factors)):
        cfg = rcfg(base, base.stage_a_steps if k == 0 else 0, stage_b, coarse_frac=0.0,
                   image_size=image // factor, tile_size=max(sil.tile_size // factor, 1),
                   bin_margin_px=sil.bin_margin_px / factor)
        data = problem.data if factor == 1 else problem.data._replace(
            mask=engine._pool_mask(problem.data.mask, factor))
        res, seconds = quality.refine(problem._replace(data=data), cfg, init=cur)
        total += seconds
        cur = res.params
    name = "c2f_3level_" + "_".join(str(image // f) for f in factors)
    return record(problem, name, res, total, stats_dict(res)), res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--num-verts", type=int, default=6890)
    ap.add_argument("--stage-a", type=int, default=200)
    ap.add_argument("--stage-b", type=int, default=100)
    ap.add_argument("--coarse-frac", type=float, default=0.5)
    ap.add_argument("--coarse-factor", type=int, default=2)
    ap.add_argument("--sweep", action="store_true",
                    help="run frac {0.5, 0.7} x factor {2, 4} variants and the three-level chain")
    ap.add_argument("--betas-perturb", type=float, default=0.6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    problem = quality.shape_mismatch_problem(
        args.batch, args.num_verts, args.image, betas_perturb=args.betas_perturb,
        device=resolve_device(args.device))
    problem = quality.with_steps(problem, args.stage_a, args.stage_b)

    def emit(line):
        print(json.dumps(quality.rounded(line, DIGITS)), flush=True)

    emit(measure(problem, "control_single_res", rcfg(problem.cfg, args.stage_a, args.stage_b,
                                                     coarse_frac=0.0))[0])
    variants = SWEEP_VARIANTS if args.sweep else ((args.coarse_frac, args.coarse_factor),)
    for frac, factor in variants:
        emit(measure(problem, f"c2f_frac{frac}_f{factor}",
                     c2f_config(problem.cfg, args.image, frac, factor))[0])
    if args.sweep:
        emit(three_level(problem, args.image)[0])


if __name__ == "__main__":
    main()
