"""The port's `graft_entry.entry()` against `__graft_entry__.entry()` on the
CPU, at their full size (batch 8, 6890 vertices, 224²).

jrr_tpu's example arguments (its synthetic problem, normalized regressor and
discriminators from PRNGKey(7) and PRNGKey(8)) are carried into the port
(`convert`), and the port's `fn` on them gives jrr_tpu's jitted `fn`'s total
and five terms within TERM_RTOL. The port's own arguments have jrr_tpu's
shapes and its config: the port draws the body's orientation from numpy,
not jax.random, so its values are not jrr_tpu's (tests/test_torch_problem.py
holds the draws that are equal).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from jrr_tpu_torch import convert, graft_entry
from test_torch_spin import torch_threads

TERMS = ("total", "j2d", "j3d", "silhouette", "pose_disc", "shape_disc")
# float32 sums over 8 frames of 50,176 pixels and 17 joints, in another
# order; measured when written: 3.4e-7 at most (the silhouette term).
TERM_RTOL = 1e-5


@pytest.fixture(scope="module")
def entries():
    """jrr_tpu's (fn, args) and its terms; the port's (fn, args) on the CPU.
    Four torch threads: the port's plain loss and gradient at this size take
    most of this file's time."""
    jfn, jargs = ge.entry()
    jtotal, jterms = jax.jit(jfn)(*jargs)
    with torch_threads(4):
        pfn, pargs = graft_entry.entry(device="cpu")
        init, j_reg_norm, data, model, pose_p, shape_p = jargs
        carried = (convert.frame_params(init, device="cpu"), torch.as_tensor(np.array(j_reg_norm)),
                   convert.frame_batch(data, device="cpu"), convert.smpl_model(model, device="cpu"),
                   convert.pose_discriminator(pose_p, device="cpu"),
                   convert.shape_discriminator(shape_p, device="cpu"))
        with torch.no_grad():
            ptotal, pterms = pfn(*carried)
    assert float(jtotal) == float(jterms.total)
    return (jfn, jargs, jterms), (pfn, pargs, ptotal, pterms)


@pytest.mark.parametrize("term", TERMS)
def test_fn_on_jax_arguments_matches_jax(entries, term):
    (_, _, jterms), (_, _, ptotal, pterms) = entries
    want = float(getattr(jterms, term))
    assert float(getattr(pterms, term)) == pytest.approx(want, rel=TERM_RTOL)
    assert float(ptotal) == float(pterms.total)
    assert want != 0.0


def test_arguments_have_jax_shapes_and_config(entries):
    (jfn, jargs, _), (pfn, pargs, _, _) = entries
    jinit, jj, jdata, jmodel, jpose, jshape = jargs
    pinit, pj, pdata, pmodel, ppose, pshape = pargs
    for f in pinit._fields:
        assert tuple(getattr(pinit, f).shape) == tuple(np.shape(getattr(jinit, f))), f
    for f in pdata._fields:
        assert tuple(getattr(pdata, f).shape) == tuple(np.shape(getattr(jdata, f))), f
    assert tuple(pj.shape) == tuple(np.shape(jj)) == (17, 6890)
    # The raw regressor is drawn from numpy in both packages, equal bit for
    # bit; its row normalization rounds within an ulp of jrr_tpu's.
    np.testing.assert_allclose(pj.numpy(), np.asarray(jj), rtol=2.5e-7, atol=0)
    assert pmodel.num_verts == jmodel.num_verts and tuple(pmodel.faces.shape) == jmodel.faces.shape
    for port, jax_params in ((ppose, jpose), (pshape, jshape)):
        assert sum(p.numel() for p in port.parameters()) == sum(
            np.size(v) for v in jax_params.values())
    jcfg = inspect.getclosurevars(jfn).nonlocals["rcfg"]
    assert inspect.getclosurevars(pfn).nonlocals["cfg"] == convert.refiner_config(jcfg)
    assert pinit.cam_t.device.type == "cpu"


def test_entry_needs_a_card_or_cpu(monkeypatch):
    """Without a card the default raises before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
