"""Readings that set a cell's limits (and the checks that its control and
faults fail), at the cell's own size, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--faults 3] [--out FILE]
    python3 benchmark/calibrate.py --cell <config>:<traffic> --seeds 1,2 [--control 0]

For each seed: the program's first steps as a run's set-up drives them,
then the plain reference (float32, TF32 off), and the control: the
reference in TF32 put in the program's place. On the first `--faults`
seeds also the reference put in the program's place with a fault: half of
each batch left out (the means over the rest), one frame's refined answer
altered where it is produced (replaced by the next frame's, as a row
mix-up would), and two in the step's evaluations: PA-MPJPE aligned without
the Procrustes rotation, and the evaluation after the regressor's step
reading the regressor from before it. A state left unchanged reads
`change_gap` 1 by construction. On the first `--gates` seeds, what sets
the worst leaf's `grad_gap` (`kinks`). One JSON line per seed on standard
output (and appended to `--out`).
"""

import argparse
import gc
import json
import os
import sys
import time

# The checkout's root, in place of this script's folder (whose module names
# would shadow the standard library's).
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def readings(r):
    """A side's readings as plain numbers: per step its losses, the
    refinement's first losses and pgt; per leaf its first gradient's and
    its change's norms."""
    norm = lambda x: float(x.double().norm())  # noqa: E731
    return {"losses": r.losses, "first": r.first, "pgt_mm": r.pgt_mm,
            "frame_mm": [f.tolist() for f in r.frame_mm],
            "grad_norms": {k: norm(v) for k, v in r.first_grads.items()},
            "change_norms": {k: norm(r.end[k] - r.start[k]) for k in r.end}}


def half_batch(k, batch, gt_verts):
    half = gt_verts.shape[0] // 2
    return type(batch)(tuple(x[:half] for x in batch.init), batch.gt_j2d[:half],
                       batch.gt_j3d[:half], batch.mask[:half]), gt_verts[:half]


def swapped_frame(refined, verts):
    """Frame 0's answer replaced by frame 1's, as a row mix-up would."""
    out = []
    for x in list(refined) + [verts]:
        x = x.clone()
        x[0] = x[1]
        out.append(x)
    return tuple(out[:-1]), out[-1]


def unrotated(nx, reg_raw, verts, gt_mm):
    """`outer.mpjpe` with PA-MPJPE aligned by scale and translation alone."""
    from benchmark.reference import body as body_lib

    pred = body_lib.centred(body_lib.regress(nx, body_lib.normalized_regressor(reg_raw), verts))
    gt = body_lib.centred(gt_mm) / 1000.0
    p, t = pred - pred.mean(dim=1, keepdim=True), gt - gt.mean(dim=1, keepdim=True)
    scale = (p * t).sum(dim=(1, 2)) / (p ** 2).sum(dim=(1, 2))
    aligned = scale[:, None, None] * p + gt.mean(dim=1, keepdim=True)
    err = (pred - gt).norm(dim=-1).mean(dim=1)
    pa = (aligned - gt).norm(dim=-1).mean(dim=1)
    return err.mean() * 1000.0, pa.mean() * 1000.0


def stale_regressor():
    """`outer.mpjpe` whose evaluation after the regressor's step (the second
    of a step's three) reads the regressor of the first."""
    from benchmark.reference import outer as ref

    seen = []

    def evaluate(nx, reg_raw, verts, gt_mm):
        seen.append(reg_raw)
        return ref.mpjpe(nx, seen[-2] if len(seen) % 3 == 2 else reg_raw, verts, gt_mm)

    return evaluate


def kinks(prog, scene, config, got, want):
    """Where the worst leaf's first gradient parts from the reference's: the
    shape prior's ReLU units that the program's refined betas of step 1 and
    the reference's put on different sides of their kink, and the shape
    leaves' first-gradient gaps worked out in float64 by the reference's
    formula: from the program's betas against the reference's (`betas`),
    the program's own gradient against that formula on its betas
    (`arithmetic`), and from the program's betas with the frames that
    cross a kink given the reference's (`kinks_undone`); `rerun`: the
    program's step 1 made again, against the run's (the program leaves its
    state as it was)."""
    import statistics

    import torch

    from benchmark import check, program as program_lib
    from benchmark.reference import body as body_lib, outer as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config["pipeline"]
    batch = check.reference_batch(scene, 0)
    state = ref.initial_state(scene.j_reg_init, scene.pose_w, scene.shape_w, cfg)
    refined = ref.outer_step(body_lib.Numerics(), scene.body, state, batch, cfg)[2]
    s = prog.step(prog.state0, 0)
    nb = batch.init[2].shape[1]
    lo = s.params.shape[1] - 3 - nb
    betas_p = s.params[:, lo:lo + nb].to(refined[2].device).double()
    betas_r = refined[2].double()
    w = {k: v.double() for k, v in scene.shape_w.items()}
    real = batch.init[2].double()

    def units(b):
        h1 = b @ w["fc1.weight"].T + w["fc1.bias"]
        h2 = torch.relu(h1) @ w["fc2.weight"].T + w["fc2.bias"]
        return torch.cat([h1, h2], dim=1)

    def grads(fake):
        with torch.enable_grad():
            sw = {k: v.detach().requires_grad_(True) for k, v in w.items()}
            g = ref._lsgan(body_lib.Numerics(), body_lib.shape_prior, sw, real, fake)[1]
        return {f"shape.{k}": float(x.norm()) for k, x in zip(w, g)}

    median = statistics.median(float(v.double().norm()) for v in want.first_grads.values())

    def gaps(a, b):
        return {k: abs(a[k] - n) / max(n, median) for k, n in b.items()}

    up, ur = units(betas_p), units(betas_r)
    crossed = (up > 0) != (ur > 0)
    frames = crossed.any(dim=1)
    mixed = torch.where(frames[:, None], betas_r, betas_p)
    own = {k: float(m.double().norm()) / (1.0 - 0.9)
           for k, m in program_lib.first_moments(s.state).items() if k.startswith("shape.")}
    gp, gr = grads(betas_p), grads(betas_r)
    return {"frames_crossing": int(frames.sum()), "units_crossing": int(crossed.sum()),
            "margin_of_crossing": float(torch.minimum(up.abs(), ur.abs())[crossed].max())
            if crossed.any() else None,
            "betas_max_abs_gap": float((betas_p - betas_r).abs().max()),
            "betas": gaps(gp, gr), "arithmetic": gaps(own, gp),
            "rerun": gaps(own, {k: float(v.double().norm()) for k, v in got.first_grads.items()
                                if k in own}),
            "kinks_undone": gaps(grads(mixed), gr)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", help="a cell of BENCHMARK.json")
    p.add_argument("--cell", help="config:traffic of a cell BENCHMARK.json does not hold")
    p.add_argument("--steps", type=int, default=3, help="the check's steps, with --cell")
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--gates", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.cache_environment()
    import torch

    from benchmark import check, program as program_lib, scene as scene_lib
    from benchmark.reference import body as body_lib

    if args.workload:
        cell = harness.load_cell(args.workload)
    else:
        cell = harness.files_cell(*args.cell.split(":"), args.steps)
    steps = int(cell.limits["steps"])
    dev = torch.device(args.device)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        scene = scene_lib.make_scene(seed, cell.config, cell.traffic, dev)
        prog = program_lib.Program(scene, cell.config, dev)
        got, _, numbers = harness.first_steps(prog, steps)
        counters = [{n: v for n, v in row.items() if n.startswith(("rasterizer", "mpjpe"))}
                    for row in numbers]
        gc.collect()
        t1 = time.perf_counter()
        want = check.run_reference(scene, cell.config, steps)
        kink_line = kinks(prog, scene, cell.config, got, want) if i < args.gates else None
        del prog
        gc.collect()
        t2 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed, "program_counters": counters,
                "program": check.compare(got, want),
                "seconds": {"program": t1 - t0, "reference": t2 - t1}, "kinks": kink_line,
                "raw": {"program": readings(got), "reference": readings(want)}}
        if args.control:
            control = check.run_reference(scene, cell.config, steps,
                                          nx=body_lib.Numerics(tf32=True))
            line["control"] = check.compare(control, want)
            line["raw"]["control"] = readings(control)
            line["seconds"]["control"] = time.perf_counter() - t2
            del control
        line["unchanged"] = check.compare(want._replace(end=want.start), want)
        if i < args.faults:
            for name, kwargs in (("half_batch", {"fault": half_batch}),
                                 ("swapped_frame", {"alter": swapped_frame}),
                                 ("unrotated", {"evaluate": unrotated}),
                                 ("stale_regressor", {"evaluate": stale_regressor()})):
                faulty = check.run_reference(scene, cell.config, steps, **kwargs)
                line[name] = check.compare(faulty, want)
                line["raw"][name] = readings(faulty)
        if dev.type == "cuda":
            line["device"] = torch.cuda.get_device_name(dev)
            line["power_limit_w"] = harness.power_limit_w()
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del scene, got, want
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
