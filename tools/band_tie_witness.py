"""Does the Pallas loss+grad kernel's tie band meet its own kernel-test
tolerance at full width? Runs on the CPU, JAX only.

    python3 tools/band_tie_witness.py [--batch 1] [--seed 0] [--chunk 8]

`_fused_lossgrad_kernel` (jrr_tpu/render/silhouette_fused.py:994) routes the
min-distance gradient to every edge within tol = 1e-4·(1+dmin) of the
minimum (silhouette_pallas.py:133-140). Its XLA twin differentiates the plain
α with autodiff, which routes to the exact argmin. The JAX kernel test
(tests/test_silhouette_fused.py:209-214) holds the two to
atol 3e-4·max|twin| + rtol 2e-4 at 96 vertices and 32².

This script builds the synthetic problem of `__graft_entry__` at full width
(6890 vertices, 13776 faces), bins it as stage B does (8 px margin, interior
skip) at both geometries the refinement uses (224²/tile 8, 112²/tile 4),
and compares with the twin:
  - "band": the kernel in interpret mode as shipped;
  - "exact": the same kernel with the band set to zero (exact argmin, ties
    split evenly), which is how the PyTorch port's CUDA kernel routes;
  - "exact_xla": that routing in plain jnp ops with an f32 scatter-add, as
    the port's kernel adds, in place of the Pallas kernel's bf16 hi/lo
    one-hot matmul scatter (silhouette_fused.py:758-801).
Prints one JSON line per geometry: for each variant the largest
|Δ| / (atol + rtol·|twin|) (≤ 1 passes) and the number of table entries
beyond the tolerance.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _exact_corner_row_grads(g, p, dmin, inside, edges, *, inv_sigma, k_pad, total=None):
    """silhouette_pallas._corner_row_grads with tol = 0: the min-distance
    subgradient goes to the edges whose d² equals dmin, split evenly."""
    import jax.numpy as jnp

    from jrr_tpu.render import silhouette_pallas as sp

    one_minus = jnp.maximum(1.0 - p, 1e-30)
    if total is None:
        total = sp._lane_prod(one_minus, keepdims=True)
    dl_dp = g * total / one_minus
    dl_dsd2 = dl_dp * (-inv_sigma) * p * (1.0 - p)
    dl_ddmin = jnp.where(inside, -dl_dsd2, dl_dsd2)
    sel = tuple((e[4] <= dmin).astype(jnp.float32) for e in edges)
    nsel = sel[0] + sel[1] + sel[2]
    route = dl_ddmin * jnp.where(nsel <= 1.0, 1.0, jnp.where(nsel <= 2.0, 0.5, 1.0 / 3.0))
    acc = [jnp.zeros((1, k_pad), jnp.float32) for _ in range(6)]
    ends = ((0, 2), (2, 4), (4, 0))
    for e in range(3):
        _, te, rxe, rye, _ = edges[e]
        w = sel[e] * route * (-2.0)
        a_slot, b_slot = ends[e]
        acc[a_slot] = acc[a_slot] + jnp.sum(w * (1.0 - te) * rxe, axis=0, keepdims=True)
        acc[a_slot + 1] = acc[a_slot + 1] + jnp.sum(w * (1.0 - te) * rye, axis=0, keepdims=True)
        acc[b_slot] = acc[b_slot] + jnp.sum(w * te * rxe, axis=0, keepdims=True)
        acc[b_slot + 1] = acc[b_slot + 1] + jnp.sum(w * te * rye, axis=0, keepdims=True)
    return acc


@contextlib.contextmanager
def _exact_routing():
    from jrr_tpu.render import silhouette_pallas as sp

    saved = sp._corner_row_grads
    sp._corner_row_grads = _exact_corner_row_grads
    try:
        yield
    finally:
        sp._corner_row_grads = saved


def _exact_xla_lossgrad(tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2, dump):
    """(dtx, dty) of Σ(α − mask)² with exact routing, per tile in jnp ops,
    added into the tables in f32 (the dump page's rows stay zero)."""
    import jax
    import jax.numpy as jnp

    from jrr_tpu.render import silhouette_pallas as sp

    t2, lanes = tile * tile, idx.shape[-1]
    i = jnp.arange(t2)

    def one_tile(ox, oy, x, y, m):
        px_x = jnp.broadcast_to(ox + (i % tile).astype(jnp.float32)[:, None], (t2, lanes))
        px_y = jnp.broadcast_to(oy + (i // tile).astype(jnp.float32)[:, None], (t2, lanes))
        rows = (x[0:1], y[0:1], x[1:2], y[1:2], x[2:3], y[2:3])
        p, _, dmin, inside, edges = sp._coverage_rows(px_x, px_y, rows, inv_sigma=inv_sigma,
                                                      blur_px2=blur_px2)
        total = sp._lane_prod(jnp.maximum(1.0 - p, 1e-30), keepdims=True)
        g = 2.0 * ((1.0 - total) - m[:, None])
        acc = _exact_corner_row_grads(g, p, dmin, inside, edges, inv_sigma=inv_sigma,
                                      k_pad=lanes, total=total)
        return jnp.concatenate(acc[0::2]), jnp.concatenate(acc[1::2])  # (3, K) x and y

    def one_frame(tx_f, ty_f, pages_f, idx_f, origin_f, mask_f):
        page = jnp.take_along_axis(pages_f, (idx_f >> 7).reshape(pages_f.shape[0], -1), axis=1)
        pos = page.reshape(idx_f.shape) * 128 + (idx_f & 127)  # (G², 3, K)
        gx, gy = jax.vmap(one_tile)(origin_f[:, 0], origin_f[:, 1], tx_f.reshape(-1)[pos],
                                    ty_f.reshape(-1)[pos], mask_f)
        occupied = (pages_f[:, 0] != dump)[:, None, None]
        add = lambda g: jnp.zeros(tx_f.size).at[pos.reshape(-1)].add(  # noqa: E731
            jnp.where(occupied, g, 0.0).reshape(-1)).reshape(tx_f.shape).at[dump].set(0.0)
        return add(gx), add(gy)

    return jax.vmap(one_frame)(tx, ty, pages, idx, origin, mask_tiles)


def _violation(got, want):
    """(max |Δ| / (3e-4·max|want| + 2e-4·|want|), entries above 1)."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    ratio = np.abs(got - want) / (3e-4 * scale + 2e-4 * np.abs(want))
    return float(ratio.max()), int((ratio > 1.0).sum())


def _row(dtx, dty, twin, t0):
    vx, nx = _violation(dtx, twin[0])
    vy, ny = _violation(dty, twin[1])
    return {"max_tolerance_use": max(vx, vy), "entries_beyond": nx + ny,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chunk", type=int, default=8, help="tiles per interpret-mode grid step")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import __graft_entry__ as entry
    from jrr_tpu.refine import engine, losses
    from jrr_tpu.render import silhouette_fused as sf

    model, _, cfg, init, data = entry._synthetic_problem(
        batch=args.batch, num_verts=6890, image_size=224, seed=args.seed
    )
    cfg = cfg.refiner
    verts = losses.forward_frame(model, init).vertices
    for geometry in ("fine", "coarse"):
        gcfg, mask = cfg, data.mask
        if geometry == "coarse":
            sil, f = cfg.silhouette, cfg.silhouette.coarse_factor
            gcfg = dataclasses.replace(cfg, silhouette=dataclasses.replace(
                sil, image_size=sil.image_size // f, tile_size=sil.tile_size // f,
                bin_margin_px=sil.bin_margin_px / f,
            ))
            mask = engine._pool_mask(mask, f)
        spec = losses.rasterizer_spec(gcfg)
        bins = sf.compute_fused_bins(verts, model, init.cam_t, spec)
        bins = sf.apply_interior_skip(bins, verts, model, init.cam_t, spec)
        _, tx, ty, inv_sigma, blur_px2 = sf._prep_kernel_inputs(verts, model, init.cam_t, spec, bins)
        mask_tiles = sf.image_to_tiles(mask, spec.tile_size)
        consts = (spec.tile_size, inv_sigma, blur_px2)
        dump = sf.dump_page_id(model.num_verts)

        def twin_loss(tx_, ty_):
            tiles = sf.fused_tiles_alpha_xla(tx_, ty_, bins.pages, bins.idx, bins.origin, *consts)
            return jnp.sum((tiles - mask_tiles) ** 2)

        twin = jax.grad(twin_loss, argnums=(0, 1))(tx, ty)
        row = {"geometry": geometry, "batch": args.batch, "seed": args.seed,
               "image": spec.image_size, "tile": spec.tile_size,
               "occupied_tiles": int(jnp.sum(bins.pages[:, :, 0] != dump))}
        for name, ctx in (("band", contextlib.nullcontext()), ("exact", _exact_routing())):
            t0 = time.perf_counter()
            with ctx:
                _, dtx, dty = sf._fused_lossgrad_impl(
                    tx, ty, bins.pages, bins.idx, bins.origin, mask_tiles, *consts, dump,
                    args.chunk, True,
                )
            row[name] = _row(dtx, dty, twin, t0)
        t0 = time.perf_counter()
        dtx, dty = _exact_xla_lossgrad(
            tx, ty, bins.pages, bins.idx, bins.origin, mask_tiles, *consts, dump
        )
        row["exact_xla"] = _row(dtx, dty, twin, t0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
