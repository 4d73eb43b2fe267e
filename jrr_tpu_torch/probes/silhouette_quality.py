"""Silhouette-supervision quality at production settings through the port
(counterpart of tools/silhouette_quality.py).

On the shape-mismatch problem of `probes/quality.py` (full-size body, batch
32, betas off by 0.6), each configuration of `SWEEPS` refines the same
start under each supervision regime of `REGIMES`, and each result is scored
on the fixed blur-0 spec:
- production: the reference's five-term weights (j3d 1e4 dominates);
- no_j3d: j3d weight 0 (mocap-less frames), where j2d and the silhouette
  carry the shape and depth signal alone.

    python -m jrr_tpu_torch.probes.silhouette_quality [--batch 32] [--image 224]
        [--num-verts 6890] [--stage-a 200] [--stage-b 100] [--betas-perturb 0.6]
        [--seed 0] [--thin-appendage-radius 0.0] [--configs NAME ...]
        [--regimes production no_j3d] [--device cuda]

Prints an init line, one JSON line per (regime, config) and one summary line
per regime with a no_sil row, with the tool's keys and rounding.
`--thin-appendage-radius` > 0 builds the thin-structure body (finger-scale
tubes on hands and feet) and adds `vert_mm_thin`, the error over those
vertices. Each `seconds` is one `refine_batch` call's wall time, read after
the device has finished. Runs on the card unless `--device cpu` is given
(a missing card raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Iterable, List, Optional

import torch

from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.config import RefinerConfig
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.probes import quality
from jrr_tpu_torch.refine import losses

# (name, use_silhouette, blur_radius, step_stride, other SilhouetteConfig
# fields), tools/silhouette_quality.py:167-230 in its order.
SWEEPS = (
    # Reference-exact semantics: blur 0, every-step silhouette, single
    # resolution, near-per-step binning, no interior skip.
    ("ref_exact_full", True, 0.0, 1,
     dict(rebin_interval=20, bin_margin_px=6.0, coarse_frac=0.0, interior_skip=False,
          coarse_step_stride=None)),
    ("no_sil", False, 0.0, 1, {}), ("blur_0", True, 0.0, 1, {}),
    ("blur_1e-5", True, 1e-5, 1, {}), ("blur_1e-4", True, 1e-4, 1, {}),
    ("blur_1e-3", True, 1e-3, 1, {}),
    ("stride2", True, 0.0, 2, {}), ("stride4", True, 0.0, 4, {}),
    ("stride2_blur_1e-4", True, 1e-4, 2, {}),
    ("stride2_blur_1e-4_i50", True, 1e-4, 2, dict(rebin_interval=50, bin_margin_px=8.0)),
    ("stride4_blur_1e-4_i50", True, 1e-4, 4, dict(rebin_interval=50, bin_margin_px=8.0)),
    ("stride2_blur_1e-4_i100", True, 1e-4, 2, dict(rebin_interval=100, bin_margin_px=12.0)),
    ("stride2_blur_1e-4_i50_iskip", True, 1e-4, 2,
     dict(rebin_interval=50, bin_margin_px=8.0, interior_skip=True)),
    # The full shipped configuration ± lane packing.
    ("r4_shipped", True, 1e-4, 2, dict(rebin_interval=50, bin_margin_px=8.0, interior_skip=True)),
    ("r4_lanepack", True, 1e-4, 2,
     dict(rebin_interval=50, bin_margin_px=8.0, interior_skip=True, lane_pack=True)),
    # Stride 3, and stride 4 in the coarse phase only.
    ("r4_stride3", True, 1e-4, 3, dict(rebin_interval=50, bin_margin_px=8.0, interior_skip=True)),
    ("r4_coarse_stride4", True, 1e-4, 2,
     dict(rebin_interval=50, bin_margin_px=8.0, interior_skip=True, coarse_step_stride=4)),
    ("r4_stride3_coarse4", True, 1e-4, 3,
     dict(rebin_interval=50, bin_margin_px=8.0, interior_skip=True, coarse_step_stride=4)),
    # The shipped stack with coarse stride 4, ± early fine steps at stride 4.
    ("r4_shipped_c4", True, 1e-4, 2,
     dict(rebin_interval=50, bin_margin_px=8.0, interior_skip=True, coarse_step_stride=4)),
    ("r4_warm4_half", True, 1e-4, 2,
     dict(rebin_interval=50, bin_margin_px=8.0, interior_skip=True, coarse_step_stride=4,
          fine_warm_frac=0.5, fine_warm_stride=4)),
    ("r4_warm4_60", True, 1e-4, 2,
     dict(rebin_interval=50, bin_margin_px=8.0, interior_skip=True, coarse_step_stride=4,
          fine_warm_frac=0.6, fine_warm_stride=4)),
)
REGIMES = (("production", 1e4), ("no_j3d", 0.0))
# The tool's rounding of each printed key (digits).
DIGITS = {"mpjpe_mm": 3, "vert_mm": 3, "sil_mse": 6, "iou": 4, "seconds": 1, "vert_mm_thin": 3}


def config(base: RefinerConfig, use_sil: bool, blur: float, j3d_w: float, stride: int = 1,
           **sil_extra) -> RefinerConfig:
    """`base` with the silhouette on or off, its blur and stride (and any
    other silhouette fields), and the j3d weight replaced."""
    return dataclasses.replace(
        base,
        use_silhouette=use_sil,
        silhouette=dataclasses.replace(base.silhouette, blur_radius=blur, step_stride=stride,
                                       **sil_extra),
        loss_weights=dataclasses.replace(base.loss_weights, j3d=j3d_w),
    )


def _select(table, names: Optional[Iterable[str]]):
    if names is None:
        return list(table)
    unknown = set(names) - {row[0] for row in table}
    if unknown:
        raise ValueError(f"unknown names {sorted(unknown)}; one of {[row[0] for row in table]}")
    return [row for row in table if row[0] in names]


def _thin(problem: quality.QualityProblem, verts) -> Dict[str, float]:
    if problem.thin_idx is None:
        return {}
    return {"vert_mm_thin": quality.thin_vertex_mm(verts, problem.gt_verts, problem.thin_idx)}


def init_row(problem: quality.QualityProblem) -> Dict:
    """The start's scores (the tool's `init` line)."""
    with torch.no_grad():
        verts = losses.forward_frame(problem.model, problem.init).vertices
    mp, vm, sm, iou = quality.score_result(problem, verts, problem.init.cam_t)
    return {"config": "init", "mpjpe_mm": mp, "vert_mm": vm, "sil_mse": sm, "iou": iou,
            **_thin(problem, verts)}


def sweep(problem: quality.QualityProblem, configs: Optional[Iterable[str]] = None,
          regimes: Optional[Iterable[str]] = None, results: Optional[Dict] = None,
          log=None) -> List[Dict]:
    """One row per (regime, config), regimes outer, each from one
    `refine_batch` call under `config(problem.cfg, ...)` and scored on its
    final vertices (unrounded). `results`, when given, receives each
    call's RefineResult under (regime, config); `log` each row."""
    rows = []
    for regime, j3d_w in _select(REGIMES, regimes):
        for name, use_sil, blur, stride, extra in _select(SWEEPS, configs):
            rcfg = config(problem.cfg, use_sil, blur, j3d_w, stride, **extra)
            res, seconds = quality.refine(problem, rcfg)
            mp, vm, sm, iou = quality.score_result(problem, res.vertices, res.params.cam_t)
            row = {"regime": regime, "config": name, "blur_radius": blur, "mpjpe_mm": mp,
                   "vert_mm": vm, "sil_mse": sm, "iou": iou, "seconds": seconds,
                   **_thin(problem, res.vertices)}
            if results is not None:
                results[(regime, name)] = res
            if log is not None:
                log(row)
            rows.append(row)
    return rows


def summary(rows: List[Dict]) -> List[Dict]:
    """Per regime with a no_sil row and another: does the silhouette help,
    and which configuration has the lowest vertex error."""
    out = []
    for regime in dict.fromkeys(r["regime"] for r in rows):
        base = [r for r in rows if r["regime"] == regime and r["config"] == "no_sil"]
        others = [r for r in rows if r["regime"] == regime and r["config"] != "no_sil"]
        if not base or not others:
            continue
        best = min(others, key=lambda r: r["vert_mm"])
        out.append({"summary": regime, "no_sil_vert_mm": base[0]["vert_mm"],
                    "best_config": best["config"], "best_vert_mm": best["vert_mm"],
                    "helps": best["vert_mm"] < base[0]["vert_mm"]})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--num-verts", type=int, default=6890)
    ap.add_argument("--stage-a", type=int, default=200)
    ap.add_argument("--stage-b", type=int, default=100)
    ap.add_argument("--betas-perturb", type=float, default=0.6)
    ap.add_argument("--seed", type=int, default=0,
                    help="problem seed (body, poses, camera); gates compare configs within one")
    ap.add_argument("--thin-appendage-radius", type=float, default=0.0,
                    help="meters; > 0 builds the thin-structure body and adds vert_mm_thin")
    ap.add_argument("--configs", nargs="+", default=None, help="subset of SWEEPS (default: all)")
    ap.add_argument("--regimes", nargs="+", default=None, help="subset of production, no_j3d")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    _select(SWEEPS, args.configs)
    _select(REGIMES, args.regimes)
    dev = resolve_device(args.device)

    model = thin_idx = None
    if args.thin_appendage_radius > 0.0:
        model, aux = smpl_lib.synthetic_smpl_model(
            seed=args.seed, num_verts=args.num_verts, device=dev,
            thin_appendage_radius=args.thin_appendage_radius, return_aux=True)
        thin_idx = aux["appendage_verts"]
    problem = quality.shape_mismatch_problem(
        args.batch, args.num_verts, args.image, seed=args.seed, betas_perturb=args.betas_perturb,
        model=model, thin_idx=thin_idx, device=dev)
    problem = quality.with_steps(problem, args.stage_a, args.stage_b)

    # The tool prints the init line unrounded but for its thin column.
    print(json.dumps(quality.rounded(init_row(problem), {"vert_mm_thin": 3})), flush=True)
    rows = sweep(problem, args.configs, args.regimes,
                 log=lambda row: print(json.dumps(quality.rounded(row, DIGITS)), flush=True))
    for line in summary([quality.rounded(r, DIGITS) for r in rows]):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
