"""Train the tissue segmenter on HU-pseudo-labeled phantoms.

Port of eitx/scripts/train_tissue.py, with the same flags and outputs:
thorax phantoms -> pseudo-labels -> Trainer (train/trainer.py) -> the
``.train`` file, an EMA deployment checkpoint (EMA params + batch stats +
``meta``, in the JAX package's msgpack format, loadable by either
package's TissueSegmenter(weights=...)) and a held-out IoU report against
the pseudo-labels (the reference's own quality metric,
scripts/accuracy_calculate.py). Everything runs on ``--device``: the
card unless the caller asks for the CPU. ``--arch yolo12`` trains
ultralytics' YOLO12 segmenter (area attention) on the same trainer; no
serving runner builds that network yet, so its run writes both files but
takes no held-out report.

Usage:
    python -m eitx_torch.scripts.train_tissue --steps 1200 --batch 8 \
        --imgsz 512 --out weights/tissue_n_512.msgpack [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np


def pregenerate(n: int, imgsz: int, max_instances: int, seed: int,
                rich: bool = False, mask_res: int = None,
                store_u8: bool = False, anatomy_frac: float = 0.0,
                pv_sigma_max: float = 0.0, wide_pose: bool = False,
                geometry_frac: float = 0.0,
                geometry_scale=(0.70, 1.15), device="cuda"):
    """n phantom samples with targets; pseudo-labels on ``device``."""
    from ..train.phantoms import phantom_batch

    rng = np.random.default_rng(seed)
    return phantom_batch(n, imgsz, max_instances, rng, return_labels=True,
                         rich=rich, mask_res=mask_res, store_u8=store_u8,
                         anatomy_frac=anatomy_frac,
                         pv_sigma_max=pv_sigma_max, wide_pose=wide_pose,
                         geometry_frac=geometry_frac,
                         geometry_scale=geometry_scale, device=device)


def evaluate_checkpoint(
    ckpt_path: str, imgsz: int, variant: str, n_eval: int = 32,
    seed: int = 777, rich: bool = False, anatomy: bool = False,
    conf=0.3, max_det: int = None, nms_iou: float = 0.45,
    tta_fill: bool = False, device="cuda",
) -> dict:
    """Held-out macro IoU of the trained segmenter vs pseudo-labels.

    ``anatomy=True`` evaluates on the discrete-instance layout with the
    serving NMS budget (max_det=64 — real anatomy fragments bone into
    20+ instances; 16 slots crowd muscle/fat out, see scripts/
    eval_ood_fixture.py)."""
    from ..eval.metrics import evaluate_dataset
    from ..models.yolo.infer import TissueSegmenter
    from ..train.phantoms import phantom_batch

    seg = TissueSegmenter(
        imgsz=imgsz, weights=ckpt_path, variant=variant,
        max_det=max_det or (64 if anatomy else 16), conf=conf,
        iou=nms_iou, tta_fill=tta_fill, device=device,
    )
    held = phantom_batch(
        n_eval, imgsz, 48 if anatomy else 12, np.random.default_rng(seed),
        return_labels=True, rich=rich,
        anatomy_frac=1.0 if anatomy else 0.0, device=device,
    )
    imgs_u8 = (held["images"][..., 0] * 255).astype(np.uint8)
    # quality composition — the path the per-request pipeline serves
    pred = seg.segment_labels(imgs_u8, chunk=8, compose_full=True)
    # evaluator masks use the class_id + 1 convention (0 = background)
    results = evaluate_dataset(
        zip(held["labels"] + 1, pred + 1), n_classes=4
    )
    per_class_iou = {
        name: round(results[cid]["iou"], 4)
        for cid, name in enumerate(("bone", "muscles", "lung", "fat"))
    }
    return {
        "macro_iou": round(
            float(np.mean([results[c]["iou"] for c in range(4)])), 4
        ),
        "per_class_iou": per_class_iou,
        "pixel_accuracy": round(
            float(np.mean([results[c]["accuracy"] for c in range(4)])), 4
        ),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="train tissue segmenter in-repo")
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--imgsz", type=int, default=256)
    p.add_argument("--variant", default="n")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--n-train", type=int, default=384)
    p.add_argument("--out", default="weights/tissue_n_256.msgpack")
    p.add_argument("--eval-n", type=int, default=32)
    p.add_argument("--report", default=None,
                   help="write the eval JSON report here")
    p.add_argument("--rich", action="store_true",
                   help="train on the widened phantom distribution "
                        "(harder rotations/asymmetry/calcifications); "
                        "the report then carries evals on BOTH "
                        "distributions")
    p.add_argument("--anatomy-frac", type=float, default=0.0,
                   help="fraction of training samples drawn from the "
                        "discrete-instance anatomy layout (separate "
                        "muscle groups / articulated bone — the real "
                        "fixture's instance statistics); >0 adds an "
                        "anatomy-distribution eval to the report and "
                        "wants --max-instances ~40")
    p.add_argument("--max-instances", type=int, default=12,
                   help="per-image instance-target budget; the anatomy "
                        "layout produces 25-50 connected components per "
                        "slice, and instances beyond the budget silently "
                        "train as background")
    p.add_argument("--mask-res", type=int, default=0,
                   help="mask supervision resolution (0 = imgsz/2, the "
                        "higher-res default; pass imgsz/4 for legacy "
                        "proto-res supervision)")
    p.add_argument("--mask-topk", type=int, default=160,
                   help="mask loss over only the K best positive anchors "
                        "(0 = all-anchor legacy path)")
    p.add_argument("--proto-stride", type=int, default=4, choices=(2, 4),
                   help="proto mask-grid stride; 2 = high-res proto head "
                        "(eitx extension — bone/fat are resolution-bound "
                        "at stride 4). Recorded in checkpoint meta and "
                        "adopted automatically at inference")
    p.add_argument("--cls-w", type=float, default=0.5,
                   help="classification-loss gain (TrainConfig.cls_w; "
                        "default 0.5 = reference-recipe balance). The "
                        "confidence-calibration lever: the pinned OOD "
                        "failures are detections scoring just under the "
                        "0.3 serving threshold (whole muscle groups to "
                        "background, one posed lung at conf 0.2) — a "
                        "higher gain pushes marginal true detections "
                        "over it")
    p.add_argument("--mask-class-weights", default=None,
                   help="comma-separated per-class mask-loss weights "
                        "(bone,muscles,lung,fat), e.g. '1.5,0.8,0.8,1.6'; "
                        "upweights lagging classes, keep the mean ~1")
    p.add_argument("--wide-pose", action="store_true",
                   help="widen the TRAINING pose distribution to the "
                        "serving-pose family the posed OOD eval covers "
                        "(tilt to ~26 deg, zoom-out to 0.65, wider "
                        "shifts; train/phantoms.py:thorax_phantom_hu). "
                        "Eval distributions are unaffected.")
    p.add_argument("--pv-sigma-max", type=float, default=0.0,
                   help="partial-volume augmentation: per-sample Gaussian "
                        "blur of the training IMAGE (sigma ~ U(0, max) "
                        "px) while labels stay crisp — real CT boundaries "
                        "are PSF mixtures, the phantoms' piecewise-"
                        "constant tissues are not; 0 disables (default, "
                        "bit-identical streams)")
    p.add_argument("--geometry-frac", type=float, default=0.0,
                   help="fraction of training samples drawn from posed "
                        "renderings of the REAL patient-derived training "
                        "geometries (reference trials 2-5, harvested by "
                        "harvest_trials.py; trials 1 and 6 stay "
                        "eval-only). The round-5 lever for the "
                        "anatomy-layout-shaped OOD failures; wants "
                        "--max-instances ~48 (58-62 polygons/slice)")
    p.add_argument("--geometry-scale", default="0.70,1.15",
                   help="zoom range of the real-geometry stream "
                        "(comma pair). Trials 2-5 natively fill ~0.57 "
                        "of the frame; reaching the eval fixture's "
                        "frame-filling 0.82 scale needs ~1.45")
    p.add_argument("--mosaic-prob", type=float, default=0.0,
                   help="fraction of training samples replaced by a "
                        "quadrant mosaic of four store samples at half "
                        "scale (on-device; train/data.py): cross-scale "
                        "supervision + seam-truncated and small "
                        "instances. Mosaics hold up to 4x the store's "
                        "instances under random budget selection, so "
                        "pass --max-instances ABOVE the cache's budget "
                        "(e.g. 120 over a 40-instance store); 0 keeps "
                        "the batch stream bit-identical")
    p.add_argument("--data-seed", type=int, default=0,
                   help="phantom pregeneration seed (use a fresh seed "
                        "when continuing training from a checkpoint so "
                        "the continuation sees new data)")
    p.add_argument("--init-from", default=None,
                   help="warm-start from a deployment checkpoint (EMA "
                        "params + batch stats); the net is fully "
                        "convolutional, so a 256-trained checkpoint "
                        "fine-tunes at 512 directly")
    p.add_argument("--resume", action="store_true",
                   help="restore the full TrainState (params + optimizer "
                        "+ batch stats) from <out>.train and run --steps "
                        "MORE steps; the EMA restarts from the restored "
                        "params and re-converges within ~2*tau steps")
    p.add_argument("--arch", default="yolo11", choices=("yolo11", "yolo12"),
                   help="the network (TrainConfig.arch): eitx's YOLOv11, or "
                        "YOLO12 with area attention (trained and written, "
                        "not evaluated: no serving runner builds it)")
    p.add_argument("--device", default="cuda",
                   help="where the phantoms are labelled and the network "
                        "trains and is evaluated (cpu only when asked)")
    p.add_argument("--data-cache", default=None,
                   help="npz path for the pregenerated phantom set: "
                        "loaded when it exists, else generated and "
                        "saved. Pregeneration is host-bound (~minutes "
                        "per thousand 512^2 phantoms on one core), so a "
                        "cache written ahead of time lets a queued run "
                        "start stepping immediately. The caller owns "
                        "cache/flag consistency (imgsz, rich, mask-res, "
                        "seed are NOT hashed into the file).")
    args = p.parse_args(argv)
    if args.resume and args.init_from:
        p.error("--resume and --init-from conflict: --resume restores "
                "the full TrainState from <out>.train and would silently "
                "ignore --init-from")
    if args.mask_class_weights and \
            len(args.mask_class_weights.split(",")) != 4:
        p.error("--mask-class-weights needs exactly 4 values "
                "(bone,muscles,lung,fat)")
    mask_res = args.mask_res or args.imgsz // 2
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("eitx_torch.train_tissue")

    from ..core.device import resolve_device
    from ..models.yolo.checkpoint import (
        torch_to_flax_tree,
        write_msgpack_checkpoint,
    )
    from ..train.checkpoint import save_checkpoint
    from ..train.trainer import TrainConfig, Trainer, fit

    device = resolve_device(args.device)
    t0 = time.time()
    if args.data_cache and os.path.exists(args.data_cache):
        log.info("loading phantom cache %s...", args.data_cache)
        with np.load(args.data_cache) as z:
            data = {k: z[k] for k in z.files}
        if data["images"].shape[0] != args.n_train:
            raise SystemExit(
                f"cache has {data['images'].shape[0]} samples, "
                f"--n-train is {args.n_train}"
            )
    else:
        log.info("pregenerating %d phantoms...", args.n_train)
        data = pregenerate(args.n_train, args.imgsz, args.max_instances,
                           seed=args.data_seed, rich=args.rich,
                           mask_res=mask_res, store_u8=True,
                           anatomy_frac=args.anatomy_frac,
                           pv_sigma_max=args.pv_sigma_max,
                           wide_pose=args.wide_pose,
                           geometry_frac=args.geometry_frac,
                           geometry_scale=tuple(
                               float(v)
                               for v in args.geometry_scale.split(",")
                           ), device=device)
        if args.data_cache:
            np.savez(args.data_cache,
                     **{k: v for k, v in data.items() if k != "labels"})
            log.info("phantom cache written to %s", args.data_cache)
    # the dense per-pixel label map is an eval-side artifact; training
    # consumes images/boxes/classes/masks/valid only — don't keep an
    # (N, imgsz, imgsz) int array pinned in host RAM
    data.pop("labels", None)
    log.info("data ready in %.1fs", time.time() - t0)

    # the LR schedule is indexed by the optimizer count, which a resume
    # restores from the checkpoint — total_steps must extend past it or
    # the cosine tail evaluates to ~0 LR and the continuation is a no-op
    start_step, resume_tree = 0, None
    if args.resume:
        from ..models.yolo.convert import restore_checkpoint_tree

        # one msgpack decode serves both the step peek (needed BEFORE the
        # Trainer so the LR schedule extends past the restored count) and
        # the state restore below
        resume_tree = restore_checkpoint_tree(args.out + ".train")
        start_step = int(resume_tree["step"])
    cfg = TrainConfig(
        imgsz=args.imgsz, variant=args.variant, lr=args.lr, arch=args.arch,
        total_steps=start_step + args.steps,
        warmup_steps=min(100, args.steps // 10),
        max_instances=args.max_instances, mask_topk=args.mask_topk,
        proto_stride=args.proto_stride, cls_w=args.cls_w,
        mask_class_w=(
            tuple(float(w) for w in args.mask_class_weights.split(","))
            if args.mask_class_weights else None
        ),
    )
    trainer = Trainer(cfg, device=device)
    if args.resume:
        from ..train.checkpoint import load_checkpoint

        trainer.state = load_checkpoint(args.out + ".train", trainer.state,
                                        tree=resume_tree)
        lr_now = trainer.lr_at(trainer.state.step)
        log.info("resumed TrainState from %s.train at step %d "
                 "(lr here %.2e, decaying to 0 over %d more steps)",
                 args.out, trainer.state.step, lr_now, args.steps)
    elif args.init_from:
        from ..models.yolo.checkpoint import flax_to_torch_state
        from ..models.yolo.convert import (
            merge_state_dict,
            restore_checkpoint_tree,
        )
        from ..train.trainer import TrainState

        tree = restore_checkpoint_tree(args.init_from)
        ckpt = flax_to_torch_state(tree["params"],
                                   tree.get("batch_stats") or {})
        # tolerant merge: layers the checkpoint doesn't cover (e.g. the
        # extra proto stage when warm-starting a --proto-stride 2 graph
        # from a stride-4 checkpoint) keep their fresh initialization
        params, _, missed, unused = merge_state_dict(
            trainer.state.params,
            {k: v for k, v in ckpt.items()
             if not k.endswith(("running_mean", "running_var"))},
        )
        if missed:
            log.info("warm start left %d params fresh: %s", len(missed),
                     ", ".join(sorted({m.rsplit(".", 2)[0] for m in missed})))
        if unused:
            log.warning(
                "warm start DROPPED %d trained checkpoint tensors with no "
                "home in this graph (wrong --proto-stride/--variant?): %s",
                len(unused), ", ".join(sorted(unused)[:8]),
            )
        stats, _, _, _ = merge_state_dict(
            trainer.state.batch_stats,
            {k: v for k, v in ckpt.items()
             if k.endswith(("running_mean", "running_var"))},
        )
        trainer.state = TrainState(
            params=params, batch_stats=stats,
            opt_state=trainer.init_opt_state(),
        )
        log.info("warm-started from %s", args.init_from)
    from ..train.phantoms import phantom_batch

    val = phantom_batch(args.batch, args.imgsz, args.max_instances,
                        np.random.default_rng(555), mask_res=mask_res,
                        store_u8=True, anatomy_frac=args.anatomy_frac,
                        device=device)
    # device-resident batching: the whole store lives on the device and
    # each step draws a gather + flip batch there (train/data.py)
    from ..train.data import device_batches

    metrics, ema_params = fit(
        trainer,
        # seed offset by the restored step: a --resume continuation draws
        # a fresh batch stream instead of replaying the original prefix
        device_batches(data, args.batch,
                       seed=args.data_seed + start_step,
                       mosaic_prob=args.mosaic_prob,
                       mosaic_budget=(args.max_instances
                                      if args.mosaic_prob else 0),
                       device=device),
        steps=args.steps,
        checkpoint_path=args.out + ".train",
        checkpoint_every=max(200, args.steps // 4),
        val_batch=val,
    )
    save_checkpoint(args.out + ".train", trainer.state)
    # deployment checkpoint: EMA params + final batch stats
    payload = {
        "params": torch_to_flax_tree(ema_params)[0],
        "batch_stats": torch_to_flax_tree(trainer.state.batch_stats)[1],
        "meta": {
            "variant": args.variant, "imgsz": args.imgsz, "nc": 4,
            # total optimizer steps across all resumes, not this run's
            "steps": int(trainer.state.step),
            "final_loss": float(metrics["loss"]),
            "mask_res": mask_res, "mask_topk": args.mask_topk,
            "proto_stride": args.proto_stride,
            # loss-recipe provenance: a non-default run's artifacts must
            # be distinguishable from the baseline recipe (r3 advice)
            "cls_w": args.cls_w,
            "mask_class_w": (args.mask_class_weights or None),
        },
    }
    if args.arch != "yolo11":
        payload["meta"]["arch"] = args.arch
    write_msgpack_checkpoint(args.out, payload)
    log.info("saved %s (train wall %.1fs)", args.out, time.time() - t0)

    report = {} if args.arch != "yolo11" else evaluate_checkpoint(
        args.out, args.imgsz, args.variant, n_eval=args.eval_n,
        device=device,
    )
    if args.rich and report:
        report["rich_distribution_eval"] = evaluate_checkpoint(
            args.out, args.imgsz, args.variant, n_eval=args.eval_n,
            rich=True, device=device,
        )
    if args.anatomy_frac > 0 and report:
        report["anatomy_distribution_eval"] = evaluate_checkpoint(
            args.out, args.imgsz, args.variant, n_eval=args.eval_n,
            anatomy=True, device=device,
        )
    report["final_train_metrics"] = {
        k: round(v, 4) for k, v in metrics.items()
    }
    report["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(report))
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
