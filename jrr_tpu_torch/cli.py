"""Command-line entry point (counterpart of jrr_tpu/cli.py:25-189).

Usage:
    python -m jrr_tpu_torch.cli --demo                 # synthetic end-to-end run on the card
    python -m jrr_tpu_torch.cli --demo --device cpu    # the same on the CPU
    python -m jrr_tpu_torch.cli --data-root data/h36m --jreg-init J_regressor_h36m.npy

    python -m jrr_tpu_torch.cli --demo --device cpu --vibe-checkpoint vibe_model.pth.tar

Flags follow jrr_tpu's CLI; its `--platform` is `--device {cuda,cpu}` here
(default cuda, and `--demo` too runs on the card). `--loader native` names
a part that is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import dataclasses

from jrr_tpu_torch.config import (
    DataConfig, DiscriminatorConfig, JRegConfig, PipelineConfig, RefinerConfig,
    SilhouetteConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Joint-regressor refinement on one GPU")
    p.add_argument("--name", default="jrr_tpu_torch_run")
    p.add_argument("--demo", action="store_true", help="synthetic hermetic run")
    p.add_argument("--data-root", default=None)
    p.add_argument("--out", default="output")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument(
        "--train-epochs", type=int, default=1,
        help="optimization passes over the split, reshuffled per epoch "
        "(reference: --train_epochs, scripts/args.py:7)",
    )
    p.add_argument(
        "--split", default="validation", choices=["train", "validation"],
        help="dataset split to optimize over (reference effective behavior: "
        "validation, scripts/optimize.py:133)",
    )
    p.add_argument("--stage-a-steps", type=int, default=1000)
    p.add_argument("--stage-b-steps", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=1e-2, help="refinement lr (both stages)")
    p.add_argument("--disc-learning-rate", type=float, default=1e-3)
    p.add_argument("--j-reg-lr", type=float, default=1e-2)
    p.add_argument(
        "--jreg-snapshot-interval", type=int, default=None,
        help="snapshot the Adam-path J-regressor to <out>/jreg_snapshots/ every N batches",
    )
    p.add_argument("--no-silhouette", action="store_true")
    p.add_argument("--no-discriminators", action="store_true")
    p.add_argument("--silhouette-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--jreg-init", default=None,
        help="initial (17, V) joint regressor file (.npy/.npz/.pt); the "
        "reference uses SPIN's J_regressor_h36m.npy",
    )
    p.add_argument(
        "--spin-checkpoint", default=None,
        help="SPIN torch checkpoint (model_checkpoint.pt); enables live "
        "per-batch SPIN initialization (reference: scripts/optimize.py:164-182)",
    )
    p.add_argument(
        "--spin-mean-params", default=None,
        help="SPIN smpl_mean_params.npz (init_pose/shape/cam buffers)",
    )
    p.add_argument(
        "--vibe-checkpoint", default=None,
        help="VIBE torch checkpoint (gen_state_dict layout); runs the VIBE "
        "consumer eval after retraining (reference: main.py:26, "
        "scripts/test.py:141-166)",
    )
    p.add_argument(
        "--meva-checkpoint", default=None,
        help="MEVA torch checkpoint (gen_state_dict layout); runs the MEVA "
        "consumer eval after retraining (reference: main.py:27, "
        "scripts/test.py:167-195)",
    )
    p.add_argument(
        "--consumer-seqlen", type=int, default=None,
        help="sequence length for the consumer evals (reference chunks video "
        "into seqlen-16 sequences, scripts/test.py:254-273); default 16, "
        "4 under --demo",
    )
    p.add_argument(
        "--loader", default="auto", choices=["auto", "python", "native"],
        help="host input pipeline: python = H36MDataset + BatchLoader; native "
        "(the C++ pack loader) is not ported yet and raises, as does auto when "
        "a frames.jrrpack exists",
    )
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--wandb-log", action="store_true")
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the run computes; cuda needs a card and fails without one",
    )
    return p


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    refiner = RefinerConfig(
        stage_a_steps=args.stage_a_steps,
        stage_b_steps=args.stage_b_steps,
        stage_a_lr=args.learning_rate,
        stage_b_lr=args.learning_rate,
        silhouette=SilhouetteConfig(image_size=args.silhouette_size),
        use_silhouette=not args.no_silhouette,
        use_discriminators=not args.no_discriminators,
    )
    return PipelineConfig(
        refiner=refiner,
        discriminator=DiscriminatorConfig(lr=args.disc_learning_rate),
        jreg=JRegConfig(lr=args.j_reg_lr, snapshot_interval=args.jreg_snapshot_interval),
        data=DataConfig(
            batch_size=args.batch_size, shuffle_seed=args.seed,
            train_epochs=args.train_epochs, split=args.split,
        ),
        seed=args.seed,
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    if args.demo:
        # Demo defaults: the full five-term objective at a small size — the
        # silhouette at a 56² working resolution (the fixture masks are 224²,
        # mean-pooled 4× on ingest), at most 100 + 30 steps, batch ≤ 8.
        cfg = dataclasses.replace(
            cfg,
            refiner=dataclasses.replace(
                cfg.refiner,
                stage_a_steps=min(cfg.refiner.stage_a_steps, 100),
                stage_b_steps=min(cfg.refiner.stage_b_steps, 30),
                silhouette=dataclasses.replace(
                    cfg.refiner.silhouette,
                    image_size=min(cfg.refiner.silhouette.image_size, 56),
                ),
            ),
            data=dataclasses.replace(cfg.data, batch_size=min(args.batch_size, 8)),
        )

    wandb_run = None
    if args.wandb_log:
        try:
            import wandb

            wandb_run = wandb.init(project="jrr_tpu_torch", name=args.name)
        except Exception as e:  # no wandb, or no network
            print(f"wandb unavailable ({e}); falling back to JSONL only")

    from jrr_tpu_torch.pipeline import run_pipeline
    from jrr_tpu_torch.utils.logging import MetricsLogger

    logger = MetricsLogger(
        path=args.metrics_jsonl or f"{args.out}/metrics.jsonl", wandb_run=wandb_run
    )
    try:
        run_pipeline(
            cfg, data_root=args.data_root, out_dir=args.out, demo=args.demo,
            logger=logger, jreg_init_path=args.jreg_init,
            spin_checkpoint=args.spin_checkpoint, spin_mean_params=args.spin_mean_params,
            loader=args.loader,
            vibe_checkpoint=args.vibe_checkpoint, meva_checkpoint=args.meva_checkpoint,
            consumer_seqlen=args.consumer_seqlen or (4 if args.demo else 16),
            device=args.device,
        )
    finally:
        logger.close()


if __name__ == "__main__":
    main()
