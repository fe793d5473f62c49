"""Command-line entry point (`feature_point_cnn_tpu/main.py:24-271`): the
same subcommands, flags and defaults.

  python -m feature_point_cnn_tpu_torch.main train --synthetic-path D      # MagicPoint
  python -m feature_point_cnn_tpu_torch.main train --coco-path D --generate-points \\
      --magic-point-weights CKPT                                           # self-label
  python -m feature_point_cnn_tpu_torch.main train --coco-path D \\
      --magic-point-weights CKPT                                           # SuperPoint
  python -m feature_point_cnn_tpu_torch.main train --coco-path D --magic-point
  python -m feature_point_cnn_tpu_torch.main inference --weights-path W [--source 0]
  python -m feature_point_cnn_tpu_torch.main export --weights-path W --out extract.pt2
  python -m feature_point_cnn_tpu_torch.main export --weights-path W --pjrt-out DIR \
      [--abi packed|full] [--top-n N] [--batch B] [--input-dtype u8] [--gray]

Under ``torchrun --nproc-per-node=N -m feature_point_cnn_tpu_torch.main
train ...`` each rank joins the job (`parallel/distributed.py::initialize`,
NCCL with a card a rank) and trains data-parallel; outside torchrun
``initialize`` does nothing.

Weights paths are ``weights/*.npz`` snapshots or directories of the port's
checkpoints (`utils/checkpoint.py`).  Everything runs on the card; each
subcommand's body is a function of ``(opt, config, device)`` that tests
call with ``device="cpu"``.  Export keeps JAX's flag names: ``--out``
writes the `torch.export` extract program where JAX writes StableHLO, and
``--pjrt-out`` the native serving bundle (an AOTInductor ``model.pt2`` and
``meta.json``) where JAX writes a PJRT bundle.  The XLA compilation cache of
the JAX CLI has no counterpart (the kernels cache their builds in
``build/torch_kernels/``, the native packages in ``build/torch_serve/``).
"""

from __future__ import annotations

import argparse
from typing import Optional

from feature_point_cnn_tpu_torch.config import SuperPointConfig

def build_parser() -> argparse.ArgumentParser:
    cfg = SuperPointConfig()
    p = argparse.ArgumentParser(description="SuperPoint framework, PyTorch/CUDA port")
    p.add_argument("--H", type=int, default=480)
    p.add_argument("--W", type=int, default=640)
    p.add_argument("--nms-dist", type=int, default=cfg.nms_dist)
    p.add_argument("--conf-thresh", type=float, default=cfg.confidence_thresh)
    p.add_argument("--nn-thresh", type=float, default=cfg.nn_thresh)
    p.add_argument("--max-keypoints", type=int, default=cfg.max_keypoints)
    p.add_argument("--no-write-statistics", action="store_true")

    sub = p.add_subparsers(dest="run_mode", required=True)

    inf = sub.add_parser("inference")
    inf.add_argument("--weights-path", required=True,
                     help=".npz snapshot or checkpoint directory")
    inf.add_argument("--source", default="synthetic",
                     help="'synthetic', camera id, or video path")
    inf.add_argument("--max-frames", type=int, default=0)
    inf.add_argument("--no-show", action="store_true")

    tr = sub.add_parser("train")
    tr.add_argument("--checkpoint-path", default="checkpoints")
    tr.add_argument("--batch-size", type=int, default=cfg.batch_size)
    tr.add_argument("--grad-accum-steps", type=int, default=1,
                    help="accumulate gradients across k full batches")
    tr.add_argument("--steps-per-call", type=int, default=1,
                    help="k optimizer steps a host call (device-resident data "
                         "only; on the card, replays of a CUDA graph of the step)")
    tr.add_argument("--microbatch-steps", type=int, default=1,
                    help="split each batch into k sequential microbatches "
                         "inside the step (~k-fold less activation memory)")
    tr.add_argument("--epochs", type=int, default=cfg.epochs)
    tr.add_argument("--magic-point", action="store_true")
    tr.add_argument("--synthetic-path")
    tr.add_argument("--coco-path")
    tr.add_argument("--generate-points", action="store_true")
    tr.add_argument("--relabel", action="store_true",
                    help="with --generate-points: regenerate labels even for "
                         "items that already have an output npz (the default "
                         "skips them, which resumes an interrupted run)")
    tr.add_argument("--magic-point-weights", default="checkpoints_magicpoint")
    tr.add_argument("--limit", type=int, default=0,
                    help="cap items for self-labeling (debug)")
    tr.add_argument("--shard-index", type=int, default=0,
                    help="self-labeling: this process's shard of the file list")
    tr.add_argument("--num-shards", type=int, default=1,
                    help="self-labeling: total shards of the file list")
    tr.add_argument("--descriptor-loss", default=cfg.descriptor_loss,
                    choices=["hinge", "hinge_hn", "mse"],
                    help="joint-phase descriptor loss (train/loss.py)")
    tr.add_argument("--photometric-augment", action="store_true",
                    help="on-device photometric augmentation during training")
    tr.add_argument("--snapshot-path", default=None,
                    help="write a portable .npz weight snapshot here after "
                         "every epoch's checkpoint")
    tr.add_argument("--data-placement", default="auto",
                    choices=("auto", "device", "host"),
                    help="'device' keeps the whole packed split in device "
                         "memory and gathers batches there; 'auto' picks it "
                         "whenever the packed split fits")

    ex = sub.add_parser("export")
    ex.add_argument("--weights-path", required=True)
    ex.add_argument("--out", default="superpoint_extract.shlo",
                    help="the extract program, saved by torch.export.save "
                         "(load it with torch.export.load), unless --pjrt-out")
    ex.add_argument("--raw-weights", default=None,
                    help="write the portable single-file .npz weight snapshot "
                         "(utils/weights.py), loadable wherever --weights-path is")
    ex.add_argument("--pjrt-out", default=None,
                    help="native serving bundle directory: model.pt2 (the frame "
                         "program as an AOTInductor package, compiled for the "
                         "device) and meta.json, for csrc/serve/superpoint_serve")
    ex.add_argument("--abi", default="packed", choices=["full", "packed"])
    ex.add_argument("--top-n", type=int, default=256)
    ex.add_argument("--batch", type=int, default=1,
                    help="frames a program call (packed only)")
    ex.add_argument("--fold-bn", action="store_true",
                    help="fold BatchNorms into the convolutions of the exported "
                         "program; the .npz snapshot keeps live BatchNorm")
    ex.add_argument("--input-dtype", default="f32", choices=["f32", "u8"])
    ex.add_argument("--gray", action="store_true",
                    help="1-channel ABI input")
    return p


def config_from_args(opt) -> SuperPointConfig:
    cfg = SuperPointConfig(
        nms_dist=opt.nms_dist,
        confidence_thresh=opt.conf_thresh,
        nn_thresh=opt.nn_thresh,
        max_keypoints=opt.max_keypoints,
    )
    if opt.run_mode == "train":
        if opt.batch_size % opt.microbatch_steps != 0:
            raise SystemExit(
                f"--batch-size {opt.batch_size} must be divisible by "
                f"--microbatch-steps {opt.microbatch_steps}"
            )
        cfg = cfg.replace(
            batch_size=opt.batch_size,
            grad_accum_steps=opt.grad_accum_steps,
            microbatch_steps=opt.microbatch_steps,
            train_steps_per_call=opt.steps_per_call,
            epochs=opt.epochs,
            photometric_augment=opt.photometric_augment,
            descriptor_loss=opt.descriptor_loss,
        )
    return cfg


def _loaders(cfg, path, test_size: int = 0, device_resident: str = "auto",
             device=None):
    from feature_point_cnn_tpu_torch.data.device_store import make_loader
    from feature_point_cnn_tpu_torch.data.packed import open_dataset

    train = make_loader(open_dataset(path, "train"), cfg.batch_size, cfg.max_points,
                        device_resident=device_resident, device=device)
    # the test split is capped like the reference's SuperPoint trainer
    # (1000 items) so the per-epoch eval stays cheap
    test = make_loader(open_dataset(path, "test", size=test_size), cfg.batch_size,
                       cfg.max_points, shuffle=False,
                       device_resident=device_resident, device=device)
    return train, test


def run_inference(opt, cfg: SuperPointConfig, device=None) -> dict:
    from feature_point_cnn_tpu_torch.inference.demo import run_demo
    from feature_point_cnn_tpu_torch.parallel import distributed

    distributed.initialize(device=device)

    stats = run_demo(opt.weights_path, cfg, source=opt.source, width=opt.W,
                     height=opt.H, max_frames=opt.max_frames,
                     show=not opt.no_show, device=device)
    print(stats)
    return stats


def run_export(opt, cfg: SuperPointConfig, device=None) -> None:
    """``--pjrt-out`` writes the native bundle (`export_native`), else
    ``--out`` the extract program (`export_program`), with the frontend on
    ``device``.  ``--raw-weights`` also writes the portable ``.npz``
    snapshot, which keeps the live-BatchNorm topology whatever ``--fold-bn``
    says, as the JAX export does."""
    from feature_point_cnn_tpu_torch.inference.wrapper import (
        SuperPointFrontend,
        load_state,
    )
    from feature_point_cnn_tpu_torch.utils.weights import save_weights

    if opt.fold_bn:
        cfg = cfg.replace(fold_bn=True)
    frontend = SuperPointFrontend(cfg, weights_path=opt.weights_path, device=device)
    if opt.pjrt_out:
        frontend.export_native(
            opt.pjrt_out, (opt.H, opt.W), abi=opt.abi, top_n=opt.top_n,
            batch=opt.batch, input_dtype=opt.input_dtype,
            input_channels=1 if opt.gray else None,
        )
    else:
        frontend.export_program(opt.out, (opt.H, opt.W))
    if opt.raw_weights:
        _, state = load_state(opt.weights_path)
        save_weights(opt.raw_weights, state)
        print(f"[export] raw weights -> {opt.raw_weights}")


def run_train(opt, cfg: SuperPointConfig, device=None) -> None:
    from feature_point_cnn_tpu_torch.parallel import distributed
    from feature_point_cnn_tpu_torch.train.trainer import Trainer

    distributed.initialize(device=device)

    write_stats = not opt.no_write_statistics
    placement = {"auto": "auto", "device": "on", "host": "off"}[opt.data_placement]
    common = dict(checkpoint_dir=opt.checkpoint_path, write_statistics=write_stats,
                  snapshot_path=opt.snapshot_path, device=device)
    if opt.synthetic_path:
        print("MagicPoint training on synthetic shapes...")
        train, test = _loaders(cfg, opt.synthetic_path, device_resident=placement,
                               device=device)
        Trainer(cfg, "magicpoint", train, test, **common).train()
    elif opt.coco_path and opt.generate_points:
        print("Self-labeling COCO with homography adaptation...")
        from feature_point_cnn_tpu_torch.selflabel.coco import preprocess_coco

        preprocess_coco(opt.coco_path, opt.magic_point_weights, cfg, limit=opt.limit,
                        shard_index=opt.shard_index, num_shards=opt.num_shards,
                        skip_existing=not opt.relabel, device=device)
    elif opt.coco_path and opt.magic_point:
        print("MagicPoint training on labeled COCO...")
        train, test = _loaders(cfg, opt.coco_path, device_resident=placement,
                               device=device)
        Trainer(cfg, "magicpoint", train, test, **common).train()
    elif opt.coco_path:
        print("SuperPoint joint training...")
        train, test = _loaders(cfg, opt.coco_path, test_size=1000,
                               device_resident=placement, device=device)
        Trainer(cfg, "superpoint", train, test,
                magicpoint_checkpoint_dir=opt.magic_point_weights, **common).train()
    else:
        raise SystemExit("train requires --synthetic-path or --coco-path")


RUN = {"inference": run_inference, "export": run_export, "train": run_train}


def main(argv=None, device: Optional[str] = None):
    """Parse ``argv`` and run the subcommand on ``device`` (``None``:
    ``cuda``); returns what the subcommand returns."""
    opt = build_parser().parse_args(argv)
    return RUN[opt.run_mode](opt, config_from_args(opt), device)


if __name__ == "__main__":
    main()
