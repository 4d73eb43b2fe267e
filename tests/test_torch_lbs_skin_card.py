"""The skinning kernels (`kernels.lbs_skin_fwd` / `lbs_skin_bwd`,
csrc/lbs_skin.cu) on the card; each test skips without one. Imports no JAX,
so the card's machine runs it without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_lbs_skin_card.py

- the kernels against the plain version in float64 (the einsum pair and
  autograd through it) at the benchmark's batches (256 and 512 frames of
  6890 vertices), at a ragged batch and vertex count and with 11 joints:
  vertices and both gradients within 2e-6 of the largest entry (float32
  rounding reads ~3.5e-7, the plain version's float32 too);
- two calls equal bit for bit, and a capture replayed equals the eager call;
- `smpl_forward`'s forward and backward launch one kernel each, with no
  (B, V, 12) tensor allocated; an outer step of the outer-step program runs
  its stage-B steps through the backward kernel;
- the wrappers refuse what the kernels do not take.
"""

import dataclasses

import pytest
import torch

from jrr_tpu_torch import kernels
from jrr_tpu_torch.models import smpl
from jrr_tpu_torch.probes import skin_probe

pytestmark = pytest.mark.cuda
REL_TOL = skin_probe.REL_TOL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the skinning kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    return float((got.detach().double() - want.double()).abs().max() / want.double().abs().max())


def _differentiable(a, vp):
    return a.clone().requires_grad_(True), vp.clone().requires_grad_(True)


@pytest.mark.parametrize("batch,num_verts,num_joints",
                         [(256, 6890, 24), (512, 6890, 24), (7, 1001, 24), (3, 300, 11)])
def test_kernels_match_plain_float64(card, batch, num_verts, num_joints):
    w, a, vp, g = skin_probe.inputs(batch, num_verts, num_joints, seed=batch)
    w64, a64, vp64, g64 = (x.double() for x in (w, a, vp, g))
    want = smpl.lbs_skin_plain(w64, a64, vp64)
    want_da, want_dvp = skin_probe.plain_grads(w64, a64, vp64, g64)
    a_, vp_ = _differentiable(a, vp)
    got = smpl.lbs_skin(w, a_, vp_)
    got_da, got_dvp = torch.autograd.grad(got, (a_, vp_), g)
    assert _rel(got, want) <= REL_TOL
    assert _rel(got_da, want_da) <= REL_TOL and _rel(got_dvp, want_dvp) <= REL_TOL
    plain_da, plain_dvp = skin_probe.plain_grads(w, a, vp, g)
    assert _rel(plain_da, want_da) <= REL_TOL and _rel(plain_dvp, want_dvp) <= REL_TOL


def test_two_calls_and_a_replayed_capture_equal_bit_for_bit(card):
    w, a, vp, g = skin_probe.inputs(256)
    first = kernels.lbs_skin_fwd(w, a, vp), *kernels.lbs_skin_bwd(w, a, vp, g)
    second = kernels.lbs_skin_fwd(w, a, vp), *kernels.lbs_skin_bwd(w, a, vp, g)
    assert all(torch.equal(x, y) for x, y in zip(first, second))

    a_, vp_ = _differentiable(a, vp)

    def step():
        out = smpl.lbs_skin(w, a_, vp_)
        return (out, *torch.autograd.grad(out, (a_, vp_), g))

    step()  # the allocator's blocks, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with kernels.captured_launches() as counts, torch.cuda.graph(graph):
        captured = step()
    assert counts == {kernels.lbs_skin_fwd: 1, kernels.lbs_skin_bwd: 1}
    before = [w_.launches for w_ in kernels.SKIN]
    graph.replay()
    kernels.add_launches(counts)
    torch.cuda.synchronize()
    assert [w_.launches for w_ in kernels.SKIN] == [n + 1 for n in before]
    assert all(torch.equal(x, y) for x, y in zip(captured, first))


def test_smpl_forward_launches_each_kernel_once_without_per_vertex_transforms(card):
    model = smpl.synthetic_smpl_model(seed=0, device=card)
    b = 256
    gen = torch.Generator().manual_seed(1)
    rot, _ = torch.linalg.qr(torch.randn(b, 24, 3, 3, generator=gen))
    rot = (rot * torch.linalg.det(rot).sign()[..., None, None]).to(card)
    betas = (0.5 * torch.randn(b, 10, generator=gen)).to(card).requires_grad_(True)
    pose = rot[:, 1:].clone().requires_grad_(True)
    before = [w.launches for w in kernels.SKIN]
    out = smpl.smpl_forward(model, betas, rot[:, :1], pose)
    assert [w.launches for w in kernels.SKIN] == [before[0] + 1, before[1]]
    torch.autograd.grad(out.vertices.square().sum(), (betas, pose))
    assert [w.launches for w in kernels.SKIN] == [before[0] + 1, before[1] + 1]

    # The skinning alone, forward and backward: its peak is the vertices and
    # dv_posed (2 × 21.2 MB at B = 256) and a few MB of scratch, far below
    # one more (B, V, 12) float32 tensor (84.7 MB).
    w, a, vp, g = skin_probe.inputs(b)
    a_, vp_ = _differentiable(a, vp)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(smpl.lbs_skin(w, a_, vp_), (a_, vp_), g)
    torch.cuda.synchronize()
    per_vertex_transforms = b * w.shape[0] * 12 * 4
    outputs = 2 * vp.numel() * 4
    assert torch.cuda.max_memory_allocated() - base < outputs + per_vertex_transforms // 4


def test_outer_step_runs_stage_b_through_the_kernels(card):
    from jrr_tpu_torch import config, problem
    from jrr_tpu_torch.refine import trainer

    model, j_reg, cfg, init, data = problem.synthetic_problem(batch=4, device=card)
    cfg = dataclasses.replace(cfg, stage_a_steps=3, stage_b_steps=4, use_silhouette=False)
    pcfg = config.PipelineConfig(refiner=cfg)
    state = trainer.init_train_state(j_reg, pcfg, seed=3)
    program = trainer.compile_outer_step(pcfg)
    for _ in range(2):  # the capturing step, then a replay
        before = kernels.lbs_skin_bwd.launches
        state, _, result = program(state, model, init, data)
        torch.cuda.synchronize()
        assert kernels.lbs_skin_bwd.launches - before >= cfg.stage_b_steps
        assert bool(torch.isfinite(result.vertices).all())


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    w, a, vp, g = skin_probe.inputs(2, 96)
    for call in (
        lambda: kernels.lbs_skin_fwd(w.double(), a.double(), vp.double()),
        lambda: kernels.lbs_skin_fwd(w, a, vp.cpu()),
        lambda: kernels.lbs_skin_fwd(w, a, vp.transpose(0, 1).contiguous().transpose(0, 1)),
        lambda: kernels.lbs_skin_fwd(torch.zeros(96, 25, device=card),
                                     torch.zeros(2, 25, 12, device=card), vp),
        lambda: kernels.lbs_skin_bwd(w, a, vp, g[:1]),
        lambda: smpl.lbs_skin(w.double(), a.double(), vp.double()),
    ):
        with pytest.raises(ValueError):
            call()
