"""The skinning kernels (`kernels.lbs_skin_fwd`, `lbs_skin_bwd`, csrc/lbs_skin.cu)
on the card, at the benchmark's batches:

    python -m jrr_tpu_torch.probes.skin_probe

For B = 256 and 512 frames of the 6890-vertex, 24-joint body: each kernel's
device ms (`probes.time_ms`, graph-timed) held within 2e-6 of the largest
entry of the plain version in float64 (`smpl.lbs_skin_plain`, the einsum
pair that `smpl_forward` ran before, and autograd through it), the bound,
and the plain version's ms in float32, which is also the library
yardstick: forward, and forward + autograd backward (`library_pair_ms`;
the backward alone is their difference).
"""

from __future__ import annotations

import torch

from jrr_tpu_torch import kernels, probes
from jrr_tpu_torch.models import smpl

SOURCE = "jrr_tpu_torch/csrc/lbs_skin.cu"
BATCHES = (256, 512)
NUM_VERTS, NUM_JOINTS = 6890, 24
REL_TOL = 2e-6  # of the largest float64 entry; float32 rounding reads ~3.5e-7
REPS = 50


def inputs(batch: int, num_verts: int = NUM_VERTS, num_joints: int = NUM_JOINTS, seed: int = 0,
           device="cuda", dtype=torch.float32):
    """(weights, a_flat, v_posed, g): the synthetic body's weights, seeded
    rigid transforms, posed vertices within a metre and a unit cotangent."""
    model = smpl.synthetic_smpl_model(seed=seed, num_verts=num_verts, num_joints=num_joints,
                                      num_faces=160, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    rot, _ = torch.linalg.qr(torch.randn(batch, num_joints, 3, 3, generator=gen,
                                         dtype=torch.float64))
    t = 0.5 * torch.randn(batch, num_joints, 3, generator=gen, dtype=torch.float64)
    a_flat = torch.cat([rot.reshape(batch, num_joints, 9), t], dim=-1)
    v_posed = 0.5 * torch.randn(batch, num_verts, 3, generator=gen, dtype=torch.float64)
    g = torch.randn(batch, num_verts, 3, generator=gen, dtype=torch.float64)
    return tuple(x.to(device=device, dtype=dtype) for x in (model.lbs_weights, a_flat, v_posed, g))


def bound_ms(batch: int, num_verts: int, num_joints: int, backward: bool):
    """(least ms, "bytes" or "operations"): per (frame, vertex) the blend of
    the 12 transform entries, 2·12·J operations, then 21 for the affine map
    (forward); or the blend of the 9 rotation entries, 2·9·J, then 27 for
    dv_posed and g ⊗ v_posed and 2·12·J for da (backward). The weights and
    transforms read once, v_posed read and verts written (forward), v_posed
    and g read and dv_posed and da written (backward)."""
    n = batch * num_verts
    ops = n * (2 * 9 * num_joints + 27 + 2 * 12 * num_joints if backward
               else 2 * 12 * num_joints + 21)
    vertex_arrays = 3 if backward else 2
    byte_count = 4 * (num_verts * num_joints + 12 * batch * num_joints * (2 if backward else 1)
                      + 3 * n * vertex_arrays)
    return probes.bound(byte_count, ops)


def plain_grads(w, a, vp, g):
    """(da, dv_posed) of the plain version: autograd through the einsum pair."""
    a = a.detach().requires_grad_(True)
    vp = vp.detach().requires_grad_(True)
    return torch.autograd.grad(smpl.lbs_skin_plain(w, a, vp), (a, vp), g)


def _rel(got, want) -> float:
    """Largest |got − want| over the largest |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _held(name, pairs) -> float:
    """The largest `_rel` over (got, want) pairs; raises past REL_TOL."""
    err = max(_rel(got, want) for got, want in pairs)
    if err > REL_TOL:
        raise AssertionError(f"{name}: kernel and float64 plain version differ by {err} of the "
                             f"largest entry (tolerance {REL_TOL})")
    return err


def measure_batch(batch: int) -> list:
    w, a, vp, g = inputs(batch)
    w64, a64, vp64, g64 = (x.double() for x in (w, a, vp, g))
    want = smpl.lbs_skin_plain(w64, a64, vp64)
    want_grads = plain_grads(w64, a64, vp64, g64)
    got = kernels.lbs_skin_fwd(w, a, vp)
    got_grads = kernels.lbs_skin_bwd(w, a, vp, g)
    again = kernels.lbs_skin_fwd(w, a, vp), kernels.lbs_skin_bwd(w, a, vp, g)
    plain = smpl.lbs_skin_plain(w, a, vp)
    plain_fwd_ms = probes.time_ms(lambda: smpl.lbs_skin_plain(w, a, vp), REPS)
    plain_pair_ms = probes.time_ms(lambda: plain_grads(w, a, vp, g), REPS)
    common = dict(route="cuda", source=SOURCE, replaces="none (jrr_tpu's SMPL is plain jnp)",
                  batch=batch, num_verts=NUM_VERTS, num_joints=NUM_JOINTS,
                  tolerance=f"{REL_TOL} of the largest float64 entry")
    fwd_bound = bound_ms(batch, NUM_VERTS, NUM_JOINTS, False)
    bwd_bound = bound_ms(batch, NUM_VERTS, NUM_JOINTS, True)
    fwd = dict(
        common, name=f"lbs_skin_fwd.b{batch}", kernel="lbs_skin_fwd_kernel",
        rel_err=_held("lbs_skin_fwd", [(got, want)]), plain_f32_rel_err=_rel(plain, want),
        repeat_equal=bool(torch.equal(again[0], got)),
        ms=probes.time_ms(lambda: kernels.lbs_skin_fwd(w, a, vp), REPS), plain_ms=plain_fwd_ms,
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
        library="the einsum pair (the plain version)", library_ms=plain_fwd_ms)
    bwd = dict(
        common, name=f"lbs_skin_bwd.b{batch}", kernel="lbs_skin_bwd_kernel",
        rel_err=_held("lbs_skin_bwd", zip(got_grads, want_grads)),
        plain_f32_rel_err=max(_rel(p, q) for p, q in zip(plain_grads(w, a, vp, g), want_grads)),
        repeat_equal=all(torch.equal(x, y) for x, y in zip(again[1], got_grads)),
        ms=probes.time_ms(lambda: kernels.lbs_skin_bwd(w, a, vp, g), REPS),
        plain_ms=plain_pair_ms - plain_fwd_ms, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        library="autograd through the einsum pair (forward and backward, less the forward)",
        library_ms=plain_pair_ms - plain_fwd_ms, library_pair_ms=plain_pair_ms)
    return [fwd, bwd]


def measure():
    return [rec for batch in BATCHES for rec in measure_batch(batch)]


if __name__ == "__main__":
    probes.run(measure)
