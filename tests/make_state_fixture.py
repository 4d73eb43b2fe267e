"""Writes tests/data/train_state/state_00000001.npz: a jrr_tpu TrainState
one Adam step in, at V = 96, with the keys and arrays jrr_tpu's
`save_pytree_npz` writes (`checkpoint._flatten`), deflated so the file
stays small:

- the regressor and both discriminators from jrr_tpu's `init_train_state`
  (seed 0), their values rounded to bfloat16 precision (stored float32);
- one step of each of jrr_tpu's three optax Adam optimizers on a gradient
  that is nonzero at a seeded 1% of the entries, so that moments and
  updates sit at known places and transposes or a wrong parameter order
  show.

    python tests/make_state_fixture.py

tests/test_torch_eval.py and chip_smoke.py's product path restore it in the
port. Needs JAX (on the CPU); rerunning rewrites the same file.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "train_state", "state_00000001.npz")
NUM_VERTS = 96


def build_state():
    import jax
    import jax.numpy as jnp
    import optax

    from jrr_tpu.config import PipelineConfig
    from jrr_tpu.refine import trainer

    cfg = PipelineConfig()
    rng = np.random.default_rng(0)
    j_reg = jnp.asarray(rng.uniform(size=(17, NUM_VERTS)).astype(np.float32))
    state = trainer.init_train_state(jax.random.PRNGKey(0), j_reg, cfg)
    state = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16).astype(jnp.float32) if x.dtype == jnp.float32 else x,
        state)

    def sparse_grad(x):
        g = rng.normal(size=x.shape) * (rng.uniform(size=x.shape) < 0.01)
        return jnp.asarray(g.astype(np.float32))

    out = {}
    for name, optim in zip(("j_reg_raw", "pose_disc", "shape_disc"), trainer._make_optims(cfg)):
        params = getattr(state, name)
        opt_field = "jreg_opt" if name == "j_reg_raw" else f"{name}_opt"
        grads = jax.tree.map(sparse_grad, params)
        updates, opt_state = optim.update(grads, getattr(state, opt_field), params)
        out[name], out[opt_field] = optax.apply_updates(params, updates), opt_state
    return state._replace(step=jnp.ones((), jnp.int32), **out)


def main():
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from jrr_tpu.utils import checkpoint

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **checkpoint._flatten(build_state()))


if __name__ == "__main__":
    main()
