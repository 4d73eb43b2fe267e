"""The product loop on every card of this host, against one card.

    python3 jrr_tpu_torch/probes/multi_gpu.py [--frames 512] [--same-card N] [--split N]

Writes `chip_smoke.py`'s product fixtures (full width, SPIN-crop depth) and
both packs, runs `run_pipeline(demo=True, loader="auto")` at the shipped
defaults (batch 256) as one process on cuda:0, then the same call as one
process per card over NCCL (`chip_smoke.run_multi_gpu`:
`multihost.launch_local`, torch.cuda.device_count() processes), or with
`--same-card N` as N processes sharing cuda:0 over gloo (the same split of
every batch into rows, without NCCL or a second card).

At one process the two runs must be equal bit for bit. At more, the
refinement's result depends on how a batch is split into rows, at the
level of O(0.1-1) on this problem (`--split N` shows it in one process:
the first batch refined whole and as N row blocks, each mean scaled by
1/N, a repeat of the whole bit for bit), so they are compared, not held
(chiprun_out/multi_gpu_differences.json). What is held is what the
processes compute: shard 0, refined from the initial state on each
process's rows, must equal the same blocks refined in this process bit
for bit. Prints one JSON line with both runs' seconds and product frames/s,
then the card's name and power limit. Frames/s are host-bound: compare them
within one call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _split_refine(cfg, model, j_reg, data_root, n):
    """(whole, whole again, [block params]) of the first product batch:
    `refine_batch` on all its rows, and on each of n row blocks with
    batch_share 1/n, from the initial train state's discriminators."""
    import torch

    from jrr_tpu_torch.data import native_pipeline
    from jrr_tpu_torch.pipeline import _frame_batch, _stored_init
    from jrr_tpu_torch.refine import engine, trainer

    batch = next(native_pipeline.PackedH36MDataset(data_root, cfg.data.split).batches(
        cfg.data.batch_size, seed=cfg.data.shuffle_seed, epoch=0, drop_last=True))
    dev = model.v_template.device
    init, data = _stored_init(batch, dev), _frame_batch(batch, cfg, dev)
    j = torch.as_tensor(j_reg, dtype=torch.float32, device=dev)
    state = trainer.init_train_state(j, cfg, seed=cfg.seed)

    def refine(rows, share):
        res = engine.refine_batch(model, state.j_reg_raw, type(init)(*(x[rows] for x in init)),
                                  type(data)(*(x[rows] for x in data)), cfg.refiner,
                                  state.pose_disc, state.shape_disc, batch_share=share)
        return dict(res.params._asdict(), joints3d=res.joints3d)

    b = init.cam_t.shape[0]
    blocks = [refine(slice(k * b // n, (k + 1) * b // n), 1.0 / n) for k in range(n)]
    return refine(slice(None), 1.0), refine(slice(None), 1.0), blocks


def _split_report(whole, again, blocks):
    """Per array: the largest |blocks − whole| and the entries beyond 1e-5
    and 1e-2, and whether the whole repeats bit for bit."""
    import torch

    out = {"blocks": len(blocks),
           "repeat_bit_for_bit": all(torch.equal(whole[k], again[k]) for k in whole)}
    for k, w in whole.items():
        d = (torch.cat([blk[k] for blk in blocks]) - w).abs()
        out[k] = [float(d.max()), int((d > 1e-5).sum()), int((d > 1e-2).sum()), d.numel()]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=512, help="fixture frames (batches of 256)")
    p.add_argument("--same-card", type=int, default=0, metavar="N",
                   help="N processes sharing cuda:0 over gloo instead of one per card")
    p.add_argument("--split", type=int, default=0, metavar="N",
                   help="only the one-process split check of the first batch into N blocks")
    args = p.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    import chip_smoke as cs
    from jrr_tpu_torch import config, kernels
    from jrr_tpu_torch.data import fixtures, native_pipeline
    from jrr_tpu_torch.models import smpl
    from jrr_tpu_torch.pipeline import demo_regressors, run_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    cfg = config.PipelineConfig()
    model = smpl.synthetic_smpl_model(seed=0, device="cuda:0")
    j_true, j_initial = demo_regressors(model.num_verts, cfg.seed)
    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "fixtures")
        fixtures.write_fixture_dataset(data_root, args.frames, seed=cfg.seed, model=model,
                                       j_reg_raw=j_true, depth_range=cs.PRODUCT_DEPTH)
        native_pipeline.pack_dataset(data_root)
        native_pipeline.build_pack2(data_root)
        if args.split:
            rec = _split_report(*_split_refine(cfg, model, j_initial, data_root, args.split))
            print(json.dumps(dict(rec, batch=cfg.data.batch_size)), flush=True)
            print(cs._card(), flush=True)
            return 0
        out_dir = os.path.join(tmp, "one_card")
        kernels.reset_launches()
        t0 = time.perf_counter()
        arts = run_pipeline(cfg, data_root=data_root, out_dir=out_dir, demo=True, model=model,
                            loader="auto")
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        ref = dict(out_dir=out_dir, launches=cs._read_launches(), acc=arts.accumulator,
                   evals={"initial": arts.eval_before_after.before,
                          "adam_final": arts.eval_before_after.after, "lstsq": arts.eval_lstsq},
                   optimize_seconds=arts.seconds["optimize"])
        cs.PRODUCT_FRAMES = args.frames
        world = args.same_card or torch.cuda.device_count()
        rec = cs.run_multi_gpu(data_root, ref, tmp, world=world,
                               backend="gloo" if args.same_card else "nccl")
        if world > 1:
            whole, again, blocks = _split_refine(cfg, model, j_initial, data_root, world)
            with np.load(os.path.join(tmp, "multi_gpu", "run", "refined", "shard_000000.npz")) as f:
                shard0 = {k: torch.as_tensor(f[k], device=model.v_template.device)
                          for k in whole}
            rec["split"] = _split_report(whole, again, blocks)
            rec["shard0_equals_blocks"] = {
                k: bool(torch.equal(torch.cat([blk[k] for blk in blocks]), shard0[k]))
                for k in whole}
    print(json.dumps(dict(rec, frames=args.frames, one_card_seconds=one_s)), flush=True)
    print(cs._card(), flush=True)
    return 0 if all(rec.get("shard0_equals_blocks", {}).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
