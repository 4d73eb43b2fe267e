"""Plain reference of the outer training step (scripts/optimize.py:148-337
of the method, as the configuration states it).

Per batch, from the SPIN-like initialisation:
1. stage A: `stage_a_steps` Adam steps on the camera translation alone
   against the mean 2D joint error of the initial body;
2. stage B: `stage_b_steps` Adam steps on (pose, orientation, shape,
   camera) against the per-frame sum j2d·w + silhouette·w + j3d·w +
   pose prior·w + shape prior·w, averaged over the frames; Adam is fresh
   for stage B. With coarse-to-fine, its first `coarse_frac` of the steps
   render the silhouette at size/`coarse_factor` against the 2x2-mean-pooled
   mask (focal scaled alike) and Adam is fresh again for the rest. The
   silhouette term is evaluated on every `stride`-th step of a phase
   (stride `coarse_step_stride` in the coarse phase, `step_stride` in the
   fine one) and scaled by that stride; on the other steps it is absent;
3. one LSGAN Adam step on each prior (SPIN's parameters real, the refined
   ones fake) and one Adam step on the raw regressor against the
   pelvis-centred ground-truth joints on the refined vertices;
4. MPJPE and PA-MPJPE of the regressor before and after its step on the
   refined vertices, and before it on the initial ones.

Adam is optax's: m, v moments, bias corrections 1 - b^t, eps added after
the square root. The priors and the regressor keep their Adam state across
steps; the refinement starts afresh each batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import body as body_lib
from benchmark.reference import raster


class Adam:
    """optax.adam on a list of tensors, in place, its count a Python int."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            p.sub_(self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps))


class Batch(NamedTuple):
    init: tuple  # (pose6d (B, 23, 6), orient6d (B, 1, 6), betas (B, 10), cam_t (B, 3))
    gt_j2d: torch.Tensor  # (B, 17, 2) pixels of the 224² crop
    gt_j3d: torch.Tensor  # (B, 17, 3) millimetres
    mask: torch.Tensor  # (B, S, S) in [0, 1]


class State(NamedTuple):
    """The trained state: the raw regressor and both priors' weights (by
    name), each with its Adam."""

    j_reg: torch.Tensor
    pose_w: dict
    shape_w: dict
    jreg_opt: Adam
    pose_opt: Adam
    shape_opt: Adam


def initial_state(j_reg, pose_w, shape_w, cfg) -> State:
    j_reg = j_reg.detach().clone()
    pose_w = {k: v.detach().clone() for k, v in pose_w.items()}
    shape_w = {k: v.detach().clone() for k, v in shape_w.items()}
    lr_d = cfg["discriminator"]["lr"]
    return State(j_reg, pose_w, shape_w, Adam([j_reg], cfg["jreg"]["lr"]),
                 Adam(list(pose_w.values()), lr_d), Adam(list(shape_w.values()), lr_d))


def pool_mask(mask: torch.Tensor, factor: int) -> torch.Tensor:
    b, s, _ = mask.shape
    t = s // factor
    return mask.reshape(b, t, factor, t, factor).mean(dim=(2, 4))


class _Phase(NamedTuple):
    steps: int
    size: int  # silhouette image side
    stride: int
    mask: torch.Tensor


def _phases(cfg, mask):
    r, sil = cfg["refiner"], cfg["refiner"]["silhouette"]
    n = r["stage_b_steps"]
    coarse = int(sil["coarse_frac"] * n)
    if (r["use_silhouette"] and 0 < coarse and sil["coarse_frac"] > 0
            and sil["image_size"] // sil["coarse_factor"] >= sil["coarse_min_image"]):
        f = sil["coarse_factor"]
        stride_c = sil["coarse_step_stride"] or sil["step_stride"]
        return [_Phase(coarse, sil["image_size"] // f, max(1, stride_c), pool_mask(mask, f)),
                _Phase(n - coarse, sil["image_size"], max(1, sil["step_stride"]), mask)]
    return [_Phase(n, sil["image_size"], max(1, sil["step_stride"]), mask)]


def _stage_b_loss(nx, body, reg_n, state, leaves, batch, cfg, phase, active):
    """(differentiable total, per-term batch means) of one stage-B step. The
    silhouette term enters the total through its gradient in the screen
    vertices (`raster.loss_and_grad`), so the total's gradient is exact."""
    r = cfg["refiner"]
    w = r["loss_weights"]
    cam = r["camera"]
    pose6d, orient6d, betas, cam_t = leaves
    verts = body_lib.smpl_vertices(nx, body, betas, orient6d, pose6d)
    joints = body_lib.regress(nx, reg_n, verts)
    j2d = ((body_lib.screen(joints, cam_t, cam["image_size"], cam["focal_length"])
            - batch.gt_j2d) ** 2).mean(dim=(1, 2))
    j3d = ((body_lib.centred(joints) - body_lib.centred(batch.gt_j3d) / 1000.0) ** 2).mean(
        dim=(1, 2))
    per_frame = j2d * w["j2d"] + j3d * w["j3d"]
    zero = torch.zeros_like(j3d)
    pd = sd = zero
    if r["use_discriminators"]:
        rot6d = torch.cat([orient6d, pose6d], dim=1)
        pd = ((body_lib.pose_prior(nx, state.pose_w, rot6d) - 1.0) ** 2).mean(dim=1)
        sd = ((body_lib.shape_prior(nx, state.shape_w, betas) - 1.0) ** 2).mean(dim=1)
        per_frame = per_frame + pd * w["pose_disc"] + sd * w["shape_disc"]
    total = per_frame.mean()
    sil = zero
    if active:
        s = r["silhouette"]
        sp = raster.spec(phase.size, s["sigma"], s["blur_radius"])
        focal = cam["focal_length"] * phase.size / cam["image_size"]
        xy = body_lib.screen(verts, cam_t, phase.size, focal)
        loss, gxy = raster.loss_and_grad(xy, body.faces, phase.mask, sp)
        sil = loss * phase.stride
        total = total + (xy * (gxy * (phase.stride * w["silhouette"] / verts.shape[0]))).sum()
    value = per_frame.mean() + sil.mean() * w["silhouette"]
    terms = dict(total=value, j2d=j2d.mean(), j3d=j3d.mean(), silhouette=sil.mean(),
                 pose_disc=pd.mean(), shape_disc=sd.mean())
    return total, {k: v.detach() for k, v in terms.items()}


def refine(nx, body, reg_raw, state, batch: Batch, cfg):
    """(refined (pose6d, orient6d, betas, cam_t), vertices, curves): the
    stage-B j3d, pose and shape prior curves, and under "first" stage A's
    first loss and stage B's terms at its first step."""
    r = cfg["refiner"]
    cam = r["camera"]
    reg_n = body_lib.normalized_regressor(reg_raw)
    pose6d, orient6d, betas, cam_t0 = batch.init
    with torch.no_grad():
        fixed = body_lib.regress(nx, reg_n, body_lib.smpl_vertices(nx, body, betas, orient6d,
                                                                   pose6d))
    cam_t = cam_t0.detach().clone().requires_grad_(True)
    opt = Adam([cam_t], r["stage_a_lr"])
    first = {}
    for _ in range(r["stage_a_steps"]):
        with torch.enable_grad():
            pred = body_lib.screen(fixed, cam_t, cam["image_size"], cam["focal_length"])
            loss = ((pred - batch.gt_j2d) ** 2).mean(dim=(1, 2)).mean()
            (g,) = torch.autograd.grad(loss, [cam_t])
        first.setdefault("stage_a", loss.detach())
        opt.step([cam_t], [g])
    leaves = [x.detach().clone() for x in (pose6d, orient6d, betas)] + [cam_t.detach().clone()]
    curves = {"j3d": [], "pose_disc": [], "shape_disc": []}
    use_sil = r["use_silhouette"]
    for phase in _phases(cfg, batch.mask):
        leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
        opt = Adam(leaves, r["stage_b_lr"])
        for s in range(phase.steps):
            active = use_sil and s % phase.stride == 0
            with torch.enable_grad():
                total, terms = _stage_b_loss(nx, body, reg_n, state, leaves, batch, cfg, phase,
                                             active)
                grads = torch.autograd.grad(total, leaves)
            opt.step(leaves, grads)
            for k in curves:
                curves[k].append(terms[k].detach())
            if len(first) < 2:
                first.update((k, terms[k]) for k in ("total", "j2d", "j3d", "pose_disc",
                                                     "shape_disc"))
    leaves = [x.detach() for x in leaves]
    with torch.no_grad():
        verts = body_lib.smpl_vertices(nx, body, leaves[2], leaves[1], leaves[0])
    curves = {k: torch.stack(v) for k, v in curves.items()}
    curves["first"] = first
    return leaves, verts, curves


def similarity_aligned(pred, target):
    """pred (B, N, 3) mapped onto target by the best scale, rotation and
    translation (Umeyama), the reflection folded into the last axis."""
    mu_p, mu_t = pred.mean(dim=1, keepdim=True), target.mean(dim=1, keepdim=True)
    p, t = pred - mu_p, target - mu_t
    var = (p ** 2).sum(dim=(1, 2))
    k = torch.einsum("bni,bnj->bij", p, t)
    u, _, vh = torch.linalg.svd(k)
    v = vh.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(v @ u.transpose(-1, -2)))
    d = torch.ones_like(u[..., 0])
    d[:, 2] = sign
    rot = v @ torch.diag_embed(d) @ u.transpose(-1, -2)
    scale = torch.diagonal(rot @ k, dim1=-2, dim2=-1).sum(-1) / var
    return scale[:, None, None] * torch.einsum("bij,bnj->bni", rot, p) + mu_t


def mpjpe(nx, reg_raw, verts, gt_mm):
    """(MPJPE, PA-MPJPE) in millimetres of the regressor on `verts`."""
    pred = body_lib.centred(body_lib.regress(nx, body_lib.normalized_regressor(reg_raw), verts))
    gt = body_lib.centred(gt_mm) / 1000.0
    err = (pred - gt).norm(dim=-1).mean(dim=1)
    pa = (similarity_aligned(pred, gt) - gt).norm(dim=-1).mean(dim=1)
    return err.mean() * 1000.0, pa.mean() * 1000.0


def _lsgan(nx, prior, weights, real, fake):
    loss = (prior(nx, weights, fake) ** 2).mean() + ((prior(nx, weights, real) - 1.0) ** 2).mean()
    return loss, torch.autograd.grad(loss, list(weights.values()))


def outer_step(nx, body, state: State, batch: Batch, cfg, alter=None, evaluate=None):
    """One outer step: (new state, dict of the step's numbers, refined
    params, refined vertices). The state passed in is left as it was.
    `alter(refined, verts) -> (refined, verts)`, when given, changes the
    refinement's answer where it is produced, and `evaluate` stands in for
    `mpjpe` in the evaluations: faults the check must catch."""
    j_reg = state.j_reg
    refined, verts, curves = refine(nx, body, j_reg, state, batch, cfg)
    if alter is not None:
        refined, verts = alter(refined, verts)
    pose6d, orient6d, betas, _ = batch.init
    new = State(j_reg.clone(), {k: v.clone() for k, v in state.pose_w.items()},
                {k: v.clone() for k, v in state.shape_w.items()},
                _copy_adam(state.jreg_opt), _copy_adam(state.pose_opt),
                _copy_adam(state.shape_opt))
    with torch.enable_grad():
        pw = {k: v.detach().requires_grad_(True) for k, v in state.pose_w.items()}
        sw = {k: v.detach().requires_grad_(True) for k, v in state.shape_w.items()}
        real = torch.cat([orient6d, pose6d], dim=1)
        fake = torch.cat([refined[1], refined[0]], dim=1)
        pd_loss, pd_g = _lsgan(nx, body_lib.pose_prior, pw, real, fake)
        sd_loss, sd_g = _lsgan(nx, body_lib.shape_prior, sw, betas, refined[2])
        jr = j_reg.detach().requires_grad_(True)
        pred = body_lib.regress(nx, body_lib.normalized_regressor(jr), verts)
        jr_loss = ((body_lib.centred(pred) - body_lib.centred(batch.gt_j3d) / 1000.0) ** 2).mean()
        (jr_g,) = torch.autograd.grad(jr_loss, [jr])
    new.pose_opt.step(list(new.pose_w.values()), pd_g)
    new.shape_opt.step(list(new.shape_w.values()), sd_g)
    new.jreg_opt.step([new.j_reg], [jr_g])
    evaluate = evaluate or mpjpe
    with torch.no_grad():
        init_verts = body_lib.smpl_vertices(nx, body, betas, orient6d, pose6d)
        before = evaluate(nx, j_reg, verts, batch.gt_j3d)
        after = evaluate(nx, new.j_reg, verts, batch.gt_j3d)
        at_init = evaluate(nx, j_reg, init_verts, batch.gt_j3d)
    tail = _tail(cfg)
    numbers = dict(
        joint_loss=curves["j3d"][-tail:].mean(),
        pose_disc_gen_loss=curves["pose_disc"][-tail:].mean(),
        shape_disc_gen_loss=curves["shape_disc"][-tail:].mean(),
        pose_discriminator_loss=pd_loss.detach(), shape_discriminator_loss=sd_loss.detach(),
        j_regressor_error=jr_loss.detach(),
        mpjpe_before_jreg_step=before[0], pampjpe_before_jreg_step=before[1],
        mpjpe_after_jreg_step=after[0], pampjpe_after_jreg_step=after[1],
        mpjpe_init=at_init[0], first=curves["first"],
    )
    return new, numbers, refined, verts


def _tail(cfg) -> int:
    """Steps the final values average over: the fine stride's window."""
    r = cfg["refiner"]
    tail = max(1, r["silhouette"]["step_stride"]) if r["use_silhouette"] else 1
    return max(1, min(tail, r["stage_b_steps"]))


def _copy_adam(opt: Adam) -> Adam:
    out = Adam([], opt.lr, opt.b1, opt.b2, opt.eps)
    out.m = [m.clone() for m in opt.m]
    out.v = [v.clone() for v in opt.v]
    out.count = opt.count
    return out


def first_gradients(opt: Adam):
    """The gradients of an Adam's first step, read back from its first moment."""
    if opt.count != 1:
        raise ValueError(f"first gradients need the state after one step, not {opt.count}")
    return [m / (1.0 - opt.b1) for m in opt.m]

