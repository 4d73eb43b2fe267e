"""The benchmark's inputs, made on the device: a synthetic SMPL-sized body,
the H3.6M-sized regressor (true and perturbed) and the two priors' weights
from the configuration's `weights_seed`, and a pool of batches of the
traffic's scene from `--seed`.

A frozen rewrite of the port's synthetic body (`models/smpl.py`,
`synthetic_smpl_model`) and realistic scene (`problem.py`,
`scene="realistic"`), drawn from one `torch.Generator` on the card in a few
large calls instead of numpy on the host: the real SMPL arrays are
license-gated. Sizes come from the configuration file (`body`), the scene's
parameters from the traffic file: `scene` names the generator of the
ground-truth parameters (`SCENES`), `pose` a file of per-joint ranges of
motion under `poses/`. The joints, 2D joints and the binary silhouette of
the ground truth are made by the reference's plain code.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import torch

from benchmark.reference import body as body_lib
from benchmark.reference import raster

# Approximate T-pose rest joints (metres) in SMPL joint order, so that the
# synthetic limbs spread like a body's (the port's `_TPOSE_JOINTS`).
TPOSE = (
    (0.00, 0.00, 0.0), (0.07, -0.08, 0.0), (-0.07, -0.08, 0.0), (0.00, 0.12, 0.0),
    (0.10, -0.50, 0.0), (-0.10, -0.50, 0.0), (0.00, 0.25, 0.0), (0.10, -0.90, 0.0),
    (-0.10, -0.90, 0.0), (0.00, 0.35, 0.0), (0.12, -0.95, 0.12), (-0.12, -0.95, 0.12),
    (0.00, 0.50, 0.0), (0.06, 0.45, 0.0), (-0.06, 0.45, 0.0), (0.00, 0.65, 0.0),
    (0.18, 0.45, 0.0), (-0.18, 0.45, 0.0), (0.45, 0.45, 0.0), (-0.45, 0.45, 0.0),
    (0.70, 0.45, 0.0), (-0.70, 0.45, 0.0), (0.80, 0.45, 0.0), (-0.80, 0.45, 0.0),
)
TORSO_JOINTS = (0, 3, 6, 9, 12)
NEIGHBOURS = 8
# Where each of the 17 H3.6M joints lies on the body, as the mean of two
# SMPL rest joints, in the order of the port's constants.H36M_TO_J17:
# pelvis, left hip, knee, ankle, right hip, knee, ankle, spine, thorax,
# nose, head, left shoulder, elbow, wrist, right shoulder, elbow, wrist.
H36M_ANCHORS = ((0, 0), (1, 1), (4, 4), (7, 7), (2, 2), (5, 5), (8, 8), (3, 6), (12, 12),
                (12, 15), (15, 15), (16, 16), (18, 18), (20, 20), (17, 17), (19, 19), (21, 21))
POSES = Path(__file__).resolve().parent / "poses"


class Frames(NamedTuple):
    """Frames of the scene, batch-first: the initialisation, its ground
    truth and the supervision made from it."""

    init: tuple  # (pose6d (N, 23, 6), orient6d (N, 1, 6), betas (N, nb), cam_t (N, 3))
    gt: tuple  # the same, ground truth
    gt_verts: torch.Tensor  # (N, V, 3) metres
    gt_j2d: torch.Tensor  # (N, 17, 2) crop pixels
    gt_j3d: torch.Tensor  # (N, 17, 3) millimetres
    mask: torch.Tensor  # (N, S, S) binary silhouette, float32


class Scene(NamedTuple):
    body: body_lib.Body
    j_reg_true: torch.Tensor  # (17, V) the regressor the ground truth is made with
    j_reg_init: torch.Tensor  # (17, V) the perturbed copy training starts from
    pose_w: dict  # pose prior weights by name (out, in layout)
    shape_w: dict
    frames: Frames  # pool_batches · batch frames, batch k = rows k·batch:(k+1)·batch
    batch: int
    pool_batches: int

    def batch_rows(self, k: int) -> slice:
        b = k % self.pool_batches
        return slice(b * self.batch, (b + 1) * self.batch)


def _uniform(gen, shape, lo, hi, dev):
    return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo


def _normal(gen, shape, std, dev):
    return torch.randn(shape, generator=gen, device=dev) * std


def make_body(gen, dev, sizes: dict) -> body_lib.Body:
    """Tube surfaces along a T-pose skeleton, each face an anchor vertex
    joined to two of its 8 nearest neighbours among the vertices of its own
    bone, so that faces stay a few centimetres across in every pose, as
    SMPL's do."""
    nv, nf, nj, nb = (sizes[k] for k in ("num_verts", "num_faces", "num_joints", "num_betas"))
    if nj != len(TPOSE):
        raise ValueError(f"the synthetic body has {len(TPOSE)} joints, not {nj}")
    parents = torch.tensor([max(p, 0) for p in body_lib.PARENTS], device=dev)
    j_rest = torch.tensor(TPOSE, device=dev) + _normal(gen, (nj, 3), 0.01, dev)
    owner = torch.randint(0, nj, (nv,), generator=gen, device=dev)
    along = torch.rand((nv, 1), generator=gen, device=dev)
    base = j_rest[owner] * (1.0 - along) + j_rest[parents[owner]] * along
    dirs = torch.randn((nv, 3), generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    torso = torch.isin(owner, torch.tensor(TORSO_JOINTS, device=dev))[:, None]
    radius = torch.where(torso, _uniform(gen, (nv, 1), 0.09, 0.14, dev),
                         _uniform(gen, (nv, 1), 0.04, 0.07, dev))
    v_template = base + dirs * radius
    weights = torch.zeros((nv, nj), device=dev)
    rows = torch.arange(nv, device=dev)
    weights[rows, owner] = 0.8
    weights.index_put_((rows, parents[owner]), torch.full((nv,), 0.2, device=dev),
                       accumulate=True)
    weights = weights / weights.sum(dim=1, keepdim=True)
    nearest = torch.cdist(j_rest, v_template).topk(NEIGHBOURS, largest=False).indices
    j_regressor = torch.zeros((nj, nv), device=dev)
    j_regressor.scatter_(1, nearest, 1.0 / NEIGHBOURS)
    shapedirs = _normal(gen, (nv, 3, nb), 0.01, dev)
    posedirs = _normal(gen, (9 * (nj - 1), 3 * nv), 1e-3, dev)
    anchors = torch.randint(0, nv, (nf,), generator=gen, device=dev)
    d2 = torch.cdist(v_template[anchors], v_template)
    d2[torch.arange(nf, device=dev), anchors] = float("inf")
    d2[owner[anchors][:, None] != owner[None, :]] = float("inf")
    near = d2.topk(NEIGHBOURS, largest=False).indices  # (F, 8), nearest first
    pick = torch.rand((nf, NEIGHBOURS), generator=gen, device=dev).argsort(dim=1)[:, :2]
    faces = torch.stack([anchors, near.gather(1, pick[:, :1])[:, 0],
                         near.gather(1, pick[:, 1:])[:, 0]], dim=1)
    return body_lib.Body(v_template, shapedirs, posedirs, j_regressor, weights, faces)


def make_regressors(gen, body: body_lib.Body, joints: int, per_joint: int = 8):
    """(true, initial): each true row weighs the `per_joint` vertices nearest
    its H3.6M joint on the rest body by U(0.5, 1), as the published H3.6M
    regressor weighs the surface around each joint; training starts from it
    with N(0, 0.08) added to those weights, as from a published regressor a
    little off."""
    if joints != len(H36M_ANCHORS):
        raise ValueError(f"the regressor places {len(H36M_ANCHORS)} H3.6M joints, not {joints}")
    dev = body.v_template.device
    rest = body.j_regressor @ body.v_template
    pairs = torch.tensor(H36M_ANCHORS, device=dev)
    anchors = (rest[pairs[:, 0]] + rest[pairs[:, 1]]) / 2.0
    nearest = torch.cdist(anchors, body.v_template).topk(per_joint, largest=False).indices
    true = torch.zeros((joints, body.v_template.shape[0]), device=dev)
    true.scatter_(1, nearest, _uniform(gen, (joints, per_joint), 0.5, 1.0, dev))
    init = true + _normal(gen, true.shape, 0.08, dev) * (true > 0)
    return true, init


# (out, in) sizes of each prior's linear layers, by parameter name.
POSE_PRIOR = {"conv1": (32, 6), "conv2": (32, 32), "fc1": (1024, 24 * 32), "fc2": (1024, 1024),
              "fc3": (1, 1024)}
SHAPE_PRIOR = {"fc1": (10, 10), "fc2": (5, 10), "fc3": (1, 5)}


def _prior(gen, dev, layers: dict) -> dict:
    """U(±1/√fan_in) weights and biases (torch.nn.Linear's default)."""
    out = {}
    for name, (o, i) in layers.items():
        bound = 1.0 / i ** 0.5
        out[f"{name}.weight"] = _uniform(gen, (o, i), -bound, bound, dev)
        out[f"{name}.bias"] = _uniform(gen, (o,), -bound, bound, dev)
    return out


def make_priors(gen, dev):
    pose = _prior(gen, dev, POSE_PRIOR)
    bound = 1.0 / 32 ** 0.5
    pose["joint_w"] = _uniform(gen, (24, 32), -bound, bound, dev)
    pose["joint_b"] = _uniform(gen, (24,), -bound, bound, dev)
    return pose, _prior(gen, dev, SHAPE_PRIOR)


def random_rotmats(gen, shape, dev) -> torch.Tensor:
    """Uniform random rotations (..., 3, 3) from normalised Gaussian quaternions."""
    q = torch.randn(tuple(shape) + (4,), generator=gen, device=dev)
    w, x, y, z = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(tuple(shape) + (3, 3))


def euler_rotmats(degrees: torch.Tensor) -> torch.Tensor:
    """(..., 3) angles (x, y, z) in degrees -> (..., 3, 3) Rx(x) Ry(y) Rz(z)."""
    c, s = torch.deg2rad(degrees).cos().unbind(-1), torch.deg2rad(degrees).sin().unbind(-1)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])

    def mat(*rows):
        return torch.stack(rows, dim=-1).reshape(c[0].shape + (3, 3))

    rx = mat(one, zero, zero, zero, c[0], -s[0], zero, s[0], c[0])
    ry = mat(c[1], zero, s[1], zero, one, zero, -s[1], zero, c[1])
    rz = mat(c[2], -s[2], zero, s[2], c[2], zero, zero, zero, one)
    return rx @ ry @ rz


def joint_ranges(name: str, joints: int, dev) -> torch.Tensor:
    """(joints, 3, 2) low and high angle of each joint's x, y, z, in degrees,
    from poses/<name>.json."""
    rows = json.loads((POSES / f"{name}.json").read_text())["joints"]
    if len(rows) != joints:
        raise ValueError(f"poses/{name}.json ranges {len(rows)} joints, not {joints}")
    return torch.tensor([row[1:] for row in rows], dtype=torch.float32, device=dev)


def rot6d(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two columns, row by row."""
    return r[..., :2].reshape(r.shape[:-2] + (6,))


@torch.no_grad()
def supervision(body, j_reg_true, gt, cam_cfg: dict, sil_cfg: dict, chunk: int = 256):
    """(gt vertices, 2D joints, 3D joints in mm, binary silhouette) of
    ground-truth params, in chunks of frames."""
    nx = body_lib.Numerics()
    reg_n = body_lib.normalized_regressor(j_reg_true)
    size = sil_cfg["image_size"]
    sp = raster.spec(size, sil_cfg["sigma"], sil_cfg["blur_radius"])
    focal = cam_cfg["focal_length"] * size / cam_cfg["image_size"]
    parts = []
    for lo in range(0, gt[0].shape[0], chunk):
        pose6d, orient6d, betas, cam_t = (x[lo:lo + chunk] for x in gt)
        verts = body_lib.smpl_vertices(nx, body, betas, orient6d, pose6d)
        joints = body_lib.regress(nx, reg_n, verts)
        j2d = body_lib.screen(joints, cam_t, cam_cfg["image_size"], cam_cfg["focal_length"])
        a = raster.alpha(body_lib.screen(verts, cam_t, size, focal), body.faces, sp)
        parts.append((verts, j2d, joints * 1000.0, (a > 0.5).float()))
    return tuple(torch.cat(p) for p in zip(*parts))


def realistic_params(gen, n: int, sizes: dict, traffic: dict, dev) -> tuple:
    """Ground-truth (pose6d, orient6d, betas, cam_t) of `n` frames: each
    joint's angles uniform within its range of motion (`pose`), a uniform
    random global orientation, betas N(0, `betas_sigma`), the body
    `depth_m` away and off centre by `cam_xy_m`."""
    ranges = joint_ranges(traffic["pose"], sizes["num_joints"] - 1, dev)
    u = torch.rand((n,) + ranges.shape[:2], generator=gen, device=dev)
    angles = ranges[..., 0] + u * (ranges[..., 1] - ranges[..., 0])
    lo_xy, hi_xy = traffic["cam_xy_m"]
    lo_z, hi_z = traffic["depth_m"]
    return (
        rot6d(euler_rotmats(angles)),
        rot6d(random_rotmats(gen, (n, 1), dev)),
        _normal(gen, (n, sizes["num_betas"]), traffic["betas_sigma"], dev),
        torch.stack([_uniform(gen, (n,), lo_xy, hi_xy, dev), _uniform(gen, (n,), lo_xy, hi_xy, dev),
                     _uniform(gen, (n,), lo_z, hi_z, dev)], dim=-1),
    )


# Generators of ground-truth parameters, by the traffic file's `scene`.
SCENES = {"realistic": realistic_params}


def make_scene(seed: int, config: dict, traffic: dict, device) -> Scene:
    """Everything a run needs, made on `device`: the body, the regressors
    and the priors' weights from the configuration's `weights_seed` (one
    model, the same in every run, as SMPL is one), the frames from `seed`."""
    if traffic["scene"] not in SCENES:
        raise ValueError(f"unknown scene {traffic['scene']!r}; known: {', '.join(SCENES)}")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(config["weights_seed"]))
    sizes = config["body"]
    body = make_body(gen, dev, sizes)
    j_true, j_init = make_regressors(gen, body, sizes["regressor_joints"])
    pose_w, shape_w = make_priors(gen, dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    b, pool = traffic["batch"], traffic["pool_batches"]
    gt = SCENES[traffic["scene"]](gen, b * pool, sizes, traffic, dev)
    noise = traffic["init_noise"]
    init = tuple(x + _normal(gen, x.shape, noise[k], dev)
                 for x, k in zip(gt, ("pose6d", "orient6d", "betas", "cam_t")))
    refiner = config["pipeline"]["refiner"]
    verts, j2d, j3d, mask = supervision(body, j_true, gt, refiner["camera"], refiner["silhouette"])
    return Scene(body, j_true, j_init, pose_w, shape_w,
                 Frames(init, gt, verts, j2d, j3d, mask), b, pool)
