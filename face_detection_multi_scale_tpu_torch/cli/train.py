"""Training CLI on one card (or the CPU with --device cpu).

    python -m face_detection_multi_scale_tpu_torch.cli.train \
        --data data.yaml --model yolov7-face [--device cpu]

The JAX package's cli/train.py (the reference train.py:582-619 argparse;
defaults: cfg yolov7-face, hyp scratch.p6, img 960, kpt-label 5) with
every flag it takes, plus `--device`. The loop is the JAX one: host
dataloader + target assignment, the train step (forward, loss,
backward, nesterov SGD or Adam, ramped EMA) with gradient accumulation
to the nominal batch across epochs, image weights, multi-scale, logging,
per-epoch validation on the EMA weights (infer/validate.validate, whose
keep mask on the card is one `nms_keep` launch a batch), last/best
checkpoints by fitness, resume, and the stripped EMA weights
`best_inference.npz` at the end (the JAX package's .npz layout, which
`FaceDetector(torch_weights=)` and the JAX loader both read).

`--dtype bfloat16` is mixed-precision training, as in the JAX CLI: the
model computes in bf16 (`YoloFace(spec, dtype=)`: bf16 convs, float32
BN statistics, float32 implicit priors and loss), while the parameters,
gradients, optimizer state, EMA and checkpoints stay float32; the
epoch-end validate runs the bf16 model on the EMA parameters. The
reference's amp.autocast (train.py:364,425), with no GradScaler: bf16
has float32's exponent range.

Not ported here: data parallel training over several processes; it
raises.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch


def load_data_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="yolov7-face",
                    help="zoo name or reference cfg yaml path")
    ap.add_argument("--data", required=True, help="dataset yaml")
    ap.add_argument("--hyp", default="scratch.p6",
                    help="hyp preset name or yaml path")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--img-size", type=int, default=960)
    ap.add_argument("--kpt-label", type=int, default=5)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="bfloat16 = mixed precision: convs compute in "
                         "bf16; parameters, optimizer state and loss "
                         "reductions stay float32")
    ap.add_argument("--weights", default=None,
                    help="initial weights: torch .pt or inference .npz")
    ap.add_argument("--resume", nargs="?", const=True, default=False)
    ap.add_argument("--noautoanchor", action="store_true")
    ap.add_argument("--noval", action="store_true")
    ap.add_argument("--nosave", action="store_true",
                    help="skip checkpoint writing (train.py:594)")
    ap.add_argument("--async-checkpoint", action="store_true",
                    help="overlap checkpoint disk writes with the next "
                         "epoch's training (a background thread; same "
                         "crash contract as the sync path — the atomic "
                         "swap runs at completion)")
    ap.add_argument("--adam", action="store_true",
                    help="Adam optimizer, betas=(momentum, 0.999) "
                         "(train.py:182-185)")
    ap.add_argument("--single-cls", action="store_true",
                    help="treat every label as class 0 (train.py:597)")
    ap.add_argument("--label-smoothing", type=float, default=0.0,
                    help="BCE label smoothing eps (train.py:358)")
    ap.add_argument("--linear-lr", action="store_true")
    ap.add_argument("--cache-images", action="store_true")
    ap.add_argument("--workers", type=int, default=8,
                    help="loader sample-fetch threads (reference "
                         "dataloader workers, utils/datasets.py:59-87)")
    ap.add_argument("--loader-mode", default="thread",
                    choices=["thread", "process"],
                    help="'process' assembles each batch in a worker "
                         "process (the reference's worker processes); "
                         "'thread' shares one Python interpreter and "
                         "tops out near 1 core of label assembly")
    ap.add_argument("--project", default="runs/train")
    ap.add_argument("--name", default="exp")
    ap.add_argument("--exist-ok", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-batch-size", type=int, default=None)
    ap.add_argument("--nominal-batch", type=int, default=64,
                    help="accumulate gradients up to this total batch")
    ap.add_argument("--min-warmup-steps", type=int, default=1000,
                    help="warmup iteration floor (reference: 1000)")
    ap.add_argument("--multi-scale", action="store_true",
                    help="random batch resize +/-50%% in stride steps "
                         "(train.py:417-422)")
    ap.add_argument("--freeze-until", type=int, default=None,
                    metavar="N",
                    help="freeze graph nodes 0..N (train.py:101-153)")
    ap.add_argument("--image-weights", action="store_true",
                    help="per-epoch weighted image resampling by class "
                         "rarity x (1-mAP)^2 (train.py:374-385)")
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--evolve", type=int, nargs="?", const=300,
                    default=None, metavar="GENERATIONS",
                    help="hyperparameter evolution mode (train.py:674-754)")
    ap.add_argument("--wandb", action="store_true",
                    help="log to Weights & Biases if available")
    ap.add_argument("--no-tensorboard", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu runs "
                         "without one)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.evolve:
        return run_evolve(args)
    return train_run(args)


def _device(args) -> torch.device:
    """The one device of the run; raises for what the port cannot do."""
    if (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "training over several processes (DDP with SyncBN semantics, "
            "ROADMAP queue 1, module 8) is not ported yet; it waits for "
            "the data-parallel run_network (module 7)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return device


def train_run(args, hyp_override=None, quiet=False, datasets=None):
    """One training run of `args` (main's namespace). `datasets`, if
    given, is (train_ds, val_ds or None) in place of the ones `--data`
    names (FaceDataset instances, e.g. served from memory)."""
    from face_detection_multi_scale_tpu_torch.data.dataset import (
        DataLoader, FaceDataset)
    from face_detection_multi_scale_tpu_torch.eval.metrics import fitness
    from face_detection_multi_scale_tpu_torch.infer.validate import validate
    from face_detection_multi_scale_tpu_torch.models import zoo
    from face_detection_multi_scale_tpu_torch.models.convert import (
        jax_to_state_dict, load_reference_state_dict, load_torch_checkpoint)
    from face_detection_multi_scale_tpu_torch.models.model import (
        YoloFace, init_weights)
    from face_detection_multi_scale_tpu_torch.models.spec import load_spec
    from face_detection_multi_scale_tpu_torch.train import (
        checkpoint as CKPT)
    from face_detection_multi_scale_tpu_torch.train.autoanchor import (
        check_anchors)
    from face_detection_multi_scale_tpu_torch.train.hyp import get_hyp
    from face_detection_multi_scale_tpu_torch.train.targets import (
        build_targets_batched)
    from face_detection_multi_scale_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, ema_model, freeze_summary,
        make_accum_steps, make_train_step, zero_grads_like)
    from face_detection_multi_scale_tpu_torch.utils.general import (
        increment_path)
    from face_detection_multi_scale_tpu_torch.utils.profiling import (
        MetricsLogger)

    device = _device(args)
    save_dir = increment_path(Path(args.project) / args.name, args.exist_ok)
    ckpt_dir = save_dir / "weights"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    ckpt_writer = (CKPT.AsyncCheckpointWriter()
                   if args.async_checkpoint else None)
    save_ckpt = ckpt_writer.save if ckpt_writer else CKPT.save_checkpoint

    hyp = dict(hyp_override) if hyp_override else get_hyp(args.hyp)
    if args.label_smoothing:
        hyp["label_smoothing"] = args.label_smoothing
    spec = (load_spec(args.model) if args.model.endswith(".yaml")
            else zoo.get_spec(args.model))
    if datasets is None:
        data = load_data_config(args.data)
        spec.nc = int(data.get("nc", 1))
    nc = spec.nc

    # resuming reattaches to the original tracker run via the id stored
    # in the checkpoint metadata (check_wandb_resume, wandb_utils.py:42-53)
    resume_run_id = (CKPT.peek_meta(str(ckpt_dir), "last").get("wandb_id")
                     if args.resume else None)
    logger = MetricsLogger(str(save_dir),
                           use_tensorboard=not args.no_tensorboard,
                           use_wandb=args.wandb, config=vars(args),
                           run_id=resume_run_id)

    # snapshot run config (train.py:54-57)
    with open(save_dir / "opt.json", "w") as f:
        json.dump(vars(args), f, indent=2, default=str)
    with open(save_dir / "hyp.json", "w") as f:
        json.dump(hyp, f, indent=2)

    if datasets is not None:
        train_ds, val_ds = datasets
        if args.noval:
            val_ds = None
    else:
        train_ds = FaceDataset(data["train"], img_size=args.img_size,
                               augment=True, hyp=hyp,
                               kpt_label=args.kpt_label,
                               stride=spec.max_stride,
                               cache_images=args.cache_images,
                               single_cls=args.single_cls)
        val_ds = None
        if not args.noval and data.get("val"):
            val_ds = FaceDataset(data["val"], img_size=args.img_size,
                                 augment=False, hyp=hyp,
                                 kpt_label=args.kpt_label,
                                 stride=spec.max_stride,
                                 single_cls=args.single_cls)

    try:
        from face_detection_multi_scale_tpu_torch.utils.train_plots import (
            plot_labels)
        plot_labels(train_ds.labels, str(save_dir))
    except Exception as e:  # noqa: BLE001 — plots are optional
        print(f"plot_labels skipped: {e}")

    if not args.noautoanchor:
        anchors, bpr = check_anchors(train_ds.labels, train_ds.shapes,
                                     spec, thr=hyp["anchor_t"],
                                     imgsz=args.img_size)
        spec.anchors = tuple(tuple(float(v) for v in a.reshape(-1))
                             for a in anchors)

    # the model after autoanchor, so its spec holds the anchors; seeded
    # like the JAX init_model (its own draws: the same seed gives other
    # weights than the JAX package's)
    model = YoloFace(spec, dtype=getattr(torch, args.dtype))
    init_weights(model, torch.Generator().manual_seed(args.seed))
    if args.weights:
        if args.weights.endswith(".npz"):
            model.load_state_dict(jax_to_state_dict(
                CKPT.load_inference_weights(args.weights)))
        else:
            load_reference_state_dict(
                model, load_torch_checkpoint(args.weights))
    model.to(device).train()

    loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                        seed=args.seed, workers=args.workers,
                        mode=args.loader_mode)
    steps_per_epoch = max(len(loader), 1)

    # gradient accumulation to the nominal batch (train.py:157,437)
    accumulate = max(round(args.nominal_batch / args.batch_size), 1)
    cfg = TrainConfig(
        epochs=args.epochs, steps_per_epoch=steps_per_epoch,
        lr0=hyp["lr0"], lrf=hyp["lrf"], momentum=hyp["momentum"],
        # weight decay scaled by total_batch*accumulate/nbs
        # (train.py:157-159); both factors derive from --nominal-batch
        weight_decay=hyp["weight_decay"] * args.batch_size * accumulate
        / args.nominal_batch,
        warmup_epochs=hyp["warmup_epochs"],
        min_warmup_steps=args.min_warmup_steps,
        warmup_momentum=hyp["warmup_momentum"],
        warmup_bias_lr=hyp["warmup_bias_lr"],
        batch_size=args.batch_size, linear_lr=args.linear_lr,
        freeze_until=args.freeze_until,
        optimizer="adam" if args.adam else "sgd")
    if args.freeze_until is not None:
        nfrz, ntrn, frz_layers = freeze_summary(model, args.freeze_until)
        total = nfrz + ntrn
        print(f"Freezing layers 0..{args.freeze_until}: "
              f"{sorted(frz_layers)} | frozen {nfrz:,} / trainable "
              f"{ntrn:,} params "
              f"({ntrn / max(total, 1) * 100:.2f}% trainable)")

    state = create_train_state(model, optimizer=cfg.optimizer)
    start_epoch = 0
    best_fitness = -1.0
    if args.resume:
        state, meta = CKPT.load_checkpoint(str(ckpt_dir), "last", state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_fitness = float(meta.get("best_fitness", -1.0))
        print(f"resumed from epoch {start_epoch}")

    if accumulate > 1:
        grad_fn, apply_fn = make_accum_steps(model, cfg, hyp, args.img_size)
        print(f"accumulating gradients over {accumulate} micro-batches")
    else:
        step_fn = make_train_step(model, cfg, hyp, args.img_size)

    results_path = save_dir / "results.txt"
    grads_acc = None
    # global micro-iteration counter (the reference's `ni`,
    # train.py:396-414): drives both the accumulation cadence and — via
    # apply_fn's sched_step — the warmup/cosine schedule; resumes where
    # the interrupted run left off
    ni = start_epoch * steps_per_epoch
    last_opt_step = ni
    class_weights = None
    maps = np.zeros(nc)
    for epoch in range(start_epoch, args.epochs):
        if args.image_weights:
            # weighted image resampling (train.py:374-385): class rarity
            # x (1 - per-class mAP)^2, drawn with an epoch-seeded RNG
            from face_detection_multi_scale_tpu_torch.utils.general import (
                labels_to_class_weights, labels_to_image_weights)
            if class_weights is None:
                class_weights = labels_to_class_weights(train_ds.labels, nc)
            cw = class_weights * (1 - maps) ** 2 / nc
            iw = labels_to_image_weights(train_ds.labels, nc=nc,
                                         class_weights=cw)
            rng = random.Random(args.seed + epoch)
            train_ds.indices = rng.choices(range(train_ds.n), weights=iw,
                                           k=train_ds.n)
        loader.set_epoch(epoch)
        t0 = time.time()
        mloss = torch.zeros(6, device=device)
        nb = 0
        t_wait = 0.0  # time blocked on the input pipeline
        batch_iter = iter(loader)
        while True:
            tw = time.time()
            item = next(batch_iter, None)
            t_wait += time.time() - tw
            if item is None:
                break
            images, labels, paths, shapes = item
            if args.multi_scale:
                # random size in [0.5, 1.5] x img_size rounded to the
                # stride grid; labels are normalized so only the target
                # grids change
                gs = spec.max_stride
                sz = random.randrange(args.img_size // 2,
                                      args.img_size * 3 // 2 + gs, gs)
                if sz != images.shape[1]:
                    import cv2

                    images = np.stack([
                        cv2.resize(im, (sz, sz),
                                   interpolation=cv2.INTER_LINEAR)
                        for im in images])
            batch_grids = [(images.shape[1] // st, images.shape[2] // st)
                           for st in spec.strides]
            if epoch == start_epoch and nb < 3:
                try:
                    from face_detection_multi_scale_tpu_torch.utils.\
train_plots import plot_images
                    plot_images(images, labels, paths,
                                str(save_dir / f"train_batch{nb}.jpg"),
                                nkpt=args.kpt_label)
                except Exception:  # noqa: BLE001 — plots are optional
                    pass
            targets = build_targets_batched(
                labels, len(images), spec, batch_grids,
                anchor_t=hyp["anchor_t"])
            if accumulate > 1:
                # global iteration counter: the optimizer applies every
                # `accumulate` micro-batches ACROSS epochs
                # (train.py:409,437: ni - last_opt_step >= accumulate)
                if grads_acc is None:
                    grads_acc = zero_grads_like(state.params)
                state, grads_acc, loss, comps = grad_fn(
                    state, images, targets, grads_acc)
                ni += 1
                if ni - last_opt_step >= accumulate:
                    state = apply_fn(state, grads_acc, ni - 1)
                    grads_acc = zero_grads_like(state.params)
                    last_opt_step = ni
            else:
                state, loss, comps = step_fn(state, images, targets)
            mloss += comps
            nb += 1
            if nb % args.log_interval == 0:
                c = (mloss / nb).cpu().numpy()
                gstep = epoch * steps_per_epoch + nb
                logger.log(gstep, {
                    "train/box_loss": c[0], "train/obj_loss": c[1],
                    "train/cls_loss": c[2], "train/kpt_loss": c[3],
                    "train/kptv_loss": c[4], "train/total_loss": c[5],
                    "x/lr": cfg.lr_at(gstep, "kernel")})
                if not quiet:
                    print(f"epoch {epoch} step {nb}/{steps_per_epoch} "
                          f"box {c[0]:.4f} obj {c[1]:.4f} cls {c[2]:.4f} "
                          f"kpt {c[3]:.4f} kptv {c[4]:.4f} "
                          f"total {c[5]:.4f}")
        c = (mloss / max(nb, 1)).cpu().numpy()
        dt = time.time() - t0
        if nb:
            # input-pipeline health: fraction of the epoch blocked on the
            # loader; >30% means raise --workers / --cache-images
            wait_frac = t_wait / max(dt, 1e-9)
            logger.log((epoch + 1) * steps_per_epoch,
                       {"x/loader_wait_frac": wait_frac})
            if not quiet:
                print(f"  loader wait {t_wait:.1f}s / epoch {dt:.1f}s "
                      f"({wait_frac * 100:.0f}% input-bound, "
                      f"{args.workers} workers)")

        fit = -1.0
        results = {}
        if val_ds is not None:
            results = validate(
                ema_model(state), val_ds,
                batch_size=args.val_batch_size or args.batch_size)
            fit = fitness(results["mp"], results["mr"], results["map50"],
                          results["map"])
            # feeds next epoch's image-weights resample (the reference's
            # `maps`, train.py:377,489)
            maps[:] = results["map"]
        if results:
            logger.log((epoch + 1) * steps_per_epoch, {
                "metrics/precision": results["mp"],
                "metrics/recall": results["mr"],
                "metrics/mAP_0.5": results["map50"],
                "metrics/mAP_0.5:0.95": results["map"],
                "metrics/fitness": fit})
        with open(results_path, "a") as f:
            f.write(f"{epoch} " + " ".join(f"{v:.5f}" for v in c) + " "
                    + json.dumps(results) + f" {dt:.1f}s\n")
        meta = {"epoch": epoch, "best_fitness": best_fitness,
                "fitness": fit, "results": results,
                "wandb_id": logger.run_id}
        if not args.nosave:  # train.py:594 final-epoch-only
            save_ckpt(str(ckpt_dir), "last", state, meta)
        if fit > best_fitness:
            best_fitness = fit
            meta["best_fitness"] = best_fitness
            if not args.nosave:
                save_ckpt(str(ckpt_dir), "best", state, meta)
        print(f"epoch {epoch} done in {dt:.1f}s "
              f"loss {c[5]:.4f} fitness {fit:.4f}")

    # finalize: strip to EMA inference weights (strip_optimizer
    # equivalent)
    if ckpt_writer is not None:
        # an in-flight async save must be durable before finalize
        ckpt_writer.close()
    loader.close()
    # results.png from the metrics JSONL (plot_results, train.py:540-544)
    try:
        from face_detection_multi_scale_tpu_torch.utils.train_plots import (
            plot_results)
        plot_results(str(save_dir / "metrics.jsonl"),
                     str(save_dir / "results.png"))
    except Exception as e:  # noqa: BLE001 — plots are optional
        print(f"plot_results skipped: {e}")
    final_path = ckpt_dir / "best_inference.npz"
    CKPT.save_inference_weights(str(final_path),
                                CKPT.strip_to_inference(state))
    # version the stripped weights as a tracker artifact when a run is
    # active (log_model, wandb_utils.py:201-215)
    logger.log_artifact(final_path, f"run_{logger.run_id}_model",
                        type="model", metadata={"fitness": best_fitness})
    logger.close()
    print(f"training complete -> {save_dir}")
    train_run.last = {"fitness": best_fitness, "save_dir": str(save_dir),
                      "state": state}
    return 0


def run_evolve(args):
    """Hyperparameter evolution: short training runs per generation,
    fitness-ranked ledger (reference train.py:674-754)."""
    from face_detection_multi_scale_tpu_torch.train.evolve import evolve
    from face_detection_multi_scale_tpu_torch.train.hyp import get_hyp

    base_hyp = get_hyp(args.hyp)
    gen_args = argparse.Namespace(**vars(args))
    gen_args.evolve = None
    gen_args.noval = False
    gen_args.exist_ok = True

    counter = {"gen": 0}

    def train_once(hyp):
        counter["gen"] += 1
        gen_args.name = f"{args.name}_evolve{counter['gen']}"
        train_run(gen_args, hyp_override=hyp, quiet=True)
        info = getattr(train_run, "last", {})
        return float(info.get("fitness", -1.0)), {
            k: v for k, v in info.items() if k != "state"}

    ledger = str(Path(args.project) / "evolve.txt")
    best = evolve(train_once, base_hyp, generations=args.evolve,
                  ledger_path=ledger, seed=args.seed)
    out = Path(args.project) / "hyp_evolved.json"
    with open(out, "w") as f:
        json.dump(best, f, indent=2)
    # evolution scatter (plot_evolution, utils/plots.py role)
    try:
        from face_detection_multi_scale_tpu_torch.utils.train_plots import (
            plot_evolution)
        plot_evolution(ledger, str(Path(args.project) / "evolve.png"))
    except Exception as e:  # noqa: BLE001 — plots are optional
        print(f"plot_evolution skipped: {e}")
    print(f"evolution complete; best hyp -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
