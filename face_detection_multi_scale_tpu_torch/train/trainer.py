"""The training engine: SGD with the reference's 3-group semantics (or
Adam), warmup + one-cycle cosine schedule, EMA, gradient accumulation.

The port's counterpart of the JAX package's train/trainer.py, each JAX
function at its name, in eager PyTorch: autograd differentiates the
unfused `YoloFace` in train mode (cuDNN's convolutions and their
backward), and the optimizer updates the module's parameters in place.
The step computes in the model's dtype, as the JAX step does: a float32
model in full float32 (cuDNN's TF32 off), a `YoloFace(spec,
dtype=torch.bfloat16)` in bf16 mixed precision (bf16 convs, float32 BN
statistics, implicit priors and loss). Either way the parameters, their
gradients, the optimizer state and the EMA are float32, and the images
enter as float32 / 255 (the first conv casts them).

Reference parity (train.py):
  * 3 param groups — BN scales & implicit priors (no decay), conv
    kernels (weight decay), biases (no decay, separate warmup lr)
    (train.py:161-189)
  * nesterov SGD, momentum 0.937 (train.py:182-185)
  * one-cycle cosine lr per epoch: lf(e) = ((1+cos(pi e/E))/2)(1-lrf)+lrf
    (utils/general.py:220-222, train.py:194-198)
  * linear warmup over max(3 epochs, 1000 iters): lr from 0 (biases: from
    warmup_bias_lr) to lr0*lf(epoch); momentum from 0.8 to 0.937
    (train.py:406-414)
  * loss gain scaling by level count / nc / image area (train.py:347-349)
  * EMA decay 0.9999 * (1 - exp(-updates/2000)) (utils/torch_utils.py:285)

As in the JAX package, the EMA averages the parameters only; the BN
running statistics stay the live model's, and an EMA model pairs the
averaged parameters with them (`ema_model`). BatchNorm updates its
running variance with the biased batch variance (models/layers.BatchNorm,
flax's rule). A frozen parameter (`freeze_until`) has requires_grad
False: it gets no gradient and no update, while its BN statistics still
update in train mode.

Under a data mesh (parallel/mesh.py, one process a card; `mesh=` of
`make_train_step` and `make_accum_steps`) each rank steps on its rows of
the global batch: BatchNorm takes the global batch's statistics, the
loss divides by the global counts, the gradients are summed over the
ranks before the apply, and every rank applies the same update, so the
parameters stay identical across ranks and equal (to float32 rounding)
those of one process stepping on the global batch, as the JAX package's
step over its mesh does.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from face_detection_multi_scale_tpu_torch.models.layers import (
    set_batchnorm_mesh)
from face_detection_multi_scale_tpu_torch.models.model import (
    YoloFace, full_fp32)
from face_detection_multi_scale_tpu_torch.parallel.mesh import (
    active_mesh, all_reduce_tensors)
from face_detection_multi_scale_tpu_torch.train.loss import (
    compute_loss_batched, targets_to_device)

Tensors = Dict[str, torch.Tensor]


def one_cycle_lf(epoch, epochs: int, lrf: float) -> float:
    """Cosine interpolation 1 -> lrf over `epochs` (utils/general.py:220)."""
    return ((1 + math.cos(math.pi * epoch / epochs)) / 2) * (1 - lrf) + lrf


def scale_loss_gains(hyp: Dict[str, float], nl: int, nc: int,
                     img_size: int) -> Dict[str, float]:
    """Reference loss-gain renormalization (train.py:347-349)."""
    h = dict(hyp)
    h["box"] = hyp["box"] * 3.0 / nl
    h["cls"] = hyp["cls"] * nc / 80.0 * 3.0 / nl
    h["obj"] = hyp["obj"] * (img_size / 640.0) ** 2 * 3.0 / nl
    return h


def _param_group(name: str, param: torch.Tensor) -> str:
    """Classify a parameter: 'kernel' (a conv or linear weight, decayed),
    'bias' (conv, linear and BN biases), or 'other' (BN weights, the
    implicit priors, Sum's and the ACON activations' parameters, no
    decay) — train.py:161-180; the JAX leaves `kernel` / `bias` / the
    rest."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and param.ndim in (2, 4):
        return "kernel"
    if leaf == "bias":
        return "bias"
    return "other"


def _layer_index(name: str) -> Optional[int]:
    """Graph-node index of a parameter from its top-level module name
    (`model.{i}.`), the reference's param-name parsing
    (train.py:113-119)."""
    parts = name.split(".")
    if len(parts) > 1 and parts[0] == "model" and parts[1].isdigit():
        return int(parts[1])
    return None


def _frozen(name: str, freeze_until) -> bool:
    li = _layer_index(name)
    return freeze_until is not None and li is not None and li <= freeze_until


def freeze_tree(model: YoloFace, freeze_until) -> Dict[str, bool]:
    """Freeze graph nodes 0..freeze_until (the reference --freeze-until,
    train.py:101-146): set requires_grad False on their parameters (True
    on every other) and return {name: frozen}. BN running statistics
    still update in train mode, as they do for the reference's
    requires_grad=False layers under model.train()."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = _frozen(name, freeze_until)
        p.requires_grad_(not out[name])
    return out


def freeze_summary(model: YoloFace, freeze_until):
    """(frozen_param_count, trainable_param_count, frozen_layer_indices)
    — the reference's freezing report (train.py:121-146)."""
    frozen = trainable = 0
    layers = set()
    for name, p in model.named_parameters():
        if _frozen(name, freeze_until):
            frozen += p.numel()
            layers.add(_layer_index(name))
        else:
            trainable += p.numel()
    return frozen, trainable, sorted(layers)


@dataclasses.dataclass
class TrainState:
    """The live model (its parameters and BN buffers), the optimizer's
    buffers and the EMA, each keyed by parameter name."""
    model: YoloFace
    momentum_buf: Tensors  # SGD momentum / Adam first moment
    ema_params: Tensors
    step: int = 0          # optimizer applies
    ema_updates: int = 0
    # Adam second moment; None for SGD (no memory cost)
    second_moment: Optional[Tensors] = None

    @property
    def params(self) -> Tensors:
        return dict(self.model.named_parameters())


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 300
    steps_per_epoch: int = 1000
    lr0: float = 0.01
    lrf: float = 0.2
    momentum: float = 0.937
    weight_decay: float = 0.0005
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    nominal_batch: int = 64
    batch_size: int = 64
    ema_decay: float = 0.9999
    linear_lr: bool = False
    # the reference floors warmup at 1000 iterations (train.py:398);
    # configurable so tiny datasets can actually leave warmup
    min_warmup_steps: int = 1000
    # freeze graph nodes 0..freeze_until (reference --freeze-until,
    # train.py:101-146); None trains all layers
    freeze_until: Any = None
    # "sgd" (nesterov, the default) or "adam" (reference --adam,
    # train.py:182-185)
    optimizer: str = "sgd"

    @property
    def warmup_steps(self) -> int:
        return max(int(round(self.warmup_epochs * self.steps_per_epoch)),
                   self.min_warmup_steps, 1)

    def lr_at(self, step, group: str) -> float:
        """Per-step lr for a param group, reproducing the per-iteration
        warmup interpolation over the per-epoch scheduled lr
        (train.py:406-414)."""
        epoch = math.floor(step / self.steps_per_epoch)
        if self.linear_lr:
            lf = (1 - epoch / self.epochs) * (1.0 - self.lrf) + self.lrf
        else:
            lf = one_cycle_lf(epoch, self.epochs, self.lrf)
        lr = self.lr0 * lf
        nw = self.warmup_steps
        if step >= nw:
            return lr
        start = self.warmup_bias_lr if group == "bias" else 0.0
        frac = min(max(step / nw, 0.0), 1.0)
        return start + (lr - start) * frac

    def momentum_at(self, step) -> float:
        nw = self.warmup_steps
        if step >= nw:
            return self.momentum
        frac = min(max(step / nw, 0.0), 1.0)
        return self.warmup_momentum + \
            (self.momentum - self.warmup_momentum) * frac


def create_train_state(model: YoloFace, optimizer: str = "sgd"
                       ) -> TrainState:
    """A fresh state around `model` (its weights are the starting point):
    zero optimizer buffers and an EMA equal to the parameters."""
    params = dict(model.named_parameters())
    zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
    return TrainState(
        model=model, momentum_buf=zeros(),
        ema_params={n: p.detach().clone() for n, p in params.items()},
        second_moment=zeros() if optimizer == "adam" else None)


def _by_group(params: Tensors) -> Dict[str, List[str]]:
    """The trainable (requires_grad) parameter names of each group."""
    out: Dict[str, List[str]] = {"kernel": [], "bias": [], "other": []}
    for name, p in params.items():
        if p.requires_grad:
            out[_param_group(name, p)].append(name)
    return {g: names for g, names in out.items() if names}


@torch.no_grad()
def sgd_apply(cfg: TrainConfig, params: Tensors, grads: Tensors,
              bufs: Tensors, step) -> None:
    """Nesterov SGD with coupled weight decay on kernels and per-group lr,
    torch.optim.SGD's semantics (train.py:182-189), in place. Frozen
    parameters (requires_grad False) pass through unchanged."""
    mom = cfg.momentum_at(step)
    for grp, names in _by_group(params).items():
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        b = [bufs[n] for n in names]
        if grp == "kernel":
            g = torch._foreach_add(g, p, alpha=cfg.weight_decay)
        torch._foreach_mul_(b, mom)
        torch._foreach_add_(b, g)
        d_p = torch._foreach_add(g, b, alpha=mom)  # nesterov
        torch._foreach_add_(p, d_p, alpha=-cfg.lr_at(step, grp))


@torch.no_grad()
def adam_apply(cfg: TrainConfig, params: Tensors, grads: Tensors,
               m: Tensors, v: Tensors, sched_step, apply_step) -> None:
    """torch.optim.Adam semantics with betas=(momentum, 0.999), eps 1e-8,
    coupled L2 on kernels (the reference --adam path, train.py:183-189),
    in place. The warmup lr interp is evaluated at `sched_step` (the
    global micro-iteration, like SGD); the bias correction counts
    optimizer APPLIES (`apply_step`, torch's per-param step counter).
    beta1 is NOT warmed — the reference warmup writes g['momentum'] only
    when the group has one (train.py:412-414), and Adam groups don't."""
    b1, b2, eps = cfg.momentum, 0.999, 1e-8
    t = apply_step + 1
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for grp, names in _by_group(params).items():
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        mi = [m[n] for n in names]
        vi = [v[n] for n in names]
        if grp == "kernel":
            g = torch._foreach_add(g, p, alpha=cfg.weight_decay)
        torch._foreach_mul_(mi, b1)
        torch._foreach_add_(mi, g, alpha=1.0 - b1)
        torch._foreach_mul_(vi, b2)
        torch._foreach_addcmul_(vi, g, g, value=1.0 - b2)
        denom = torch._foreach_sqrt(torch._foreach_div(vi, bc2))
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mi, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(p, upd, alpha=-cfg.lr_at(sched_step, grp))


def optimizer_apply(cfg: TrainConfig, state: TrainState, grads: Tensors,
                    sched_step) -> None:
    """Dispatch SGD / Adam on the state's parameters, in place."""
    if cfg.optimizer == "adam":
        adam_apply(cfg, state.params, grads, state.momentum_buf,
                   state.second_moment, sched_step, state.step)
    else:
        sgd_apply(cfg, state.params, grads, state.momentum_buf, sched_step)


@torch.no_grad()
def ema_update(cfg: TrainConfig, ema_params: Tensors, params: Tensors,
               updates: int) -> None:
    """ModelEMA ramped decay (utils/torch_utils.py:269-303), in place, over
    every parameter (frozen ones too, as the JAX tree map does)."""
    d = cfg.ema_decay * (1 - math.exp(-updates / 2000.0))
    names = list(ema_params)
    e = [ema_params[n] for n in names]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, [params[n].detach() for n in names],
                        alpha=1.0 - d)


def ema_model(state: TrainState) -> YoloFace:
    """A copy of the live model in eval mode with the EMA parameters and
    the live BN statistics (the JAX package validates and strips
    `{"params": ema_params, "batch_stats": batch_stats}`)."""
    model = copy.deepcopy(state.model).eval().requires_grad_(False)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema_params[name])
    return model


def _images(images, param: torch.Tensor) -> torch.Tensor:
    """A batch on the parameters' device and in their dtype; uint8
    batches normalize there (the imgs/255 of the reference batch loop,
    train.py:403)."""
    x = torch.as_tensor(images).to(param.device, non_blocking=True)
    if not x.is_floating_point():
        return x.to(param.dtype) / 255.0
    return x.to(param.dtype)


def _grad_fn(model: YoloFace, h: Dict[str, float], mesh=None):
    """(images, targets) -> (loss, components, grads of the trainable
    parameters) of `model` in train mode (its BN statistics update), in
    its compute dtype; TF32 off for whatever computes in float32. Under a
    mesh, the images and targets are this rank's rows, the loss and
    components are the global batch's, and the gradients this rank's
    share of the global gradient (the step sums them over the ranks)."""
    spec = model.spec

    def run(images, targets):
        model.train()
        param = next(model.parameters())
        x = _images(images, param)
        targets = targets_to_device(targets, param.device)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        with full_fp32():
            raws = model(x)
            loss, components = compute_loss_batched(
                raws, targets, h, nc=spec.nc, nkpt=spec.nkpt, gr=1.0,
                mesh=mesh)
            grads = torch.autograd.grad(loss, [p for _, p in named])
        loss, components = loss.detach(), components.detach()
        if mesh is not None:
            both = torch.cat([loss.reshape(1), components])
            all_reduce_tensors(mesh, [both])
            loss, components = both[0], both[1:]
        return loss, components, {n: g for (n, _), g in zip(named, grads)}

    return run


def _attach(model: YoloFace, cfg: TrainConfig, mesh):
    """The step's hold on the model: `cfg.freeze_until` on its
    requires_grad flags and, under a mesh, the mesh on its BatchNorms.
    Returns the mesh the step runs over: None for no mesh or a world of
    one without a process group."""
    freeze_tree(model, cfg.freeze_until)
    mesh = active_mesh(mesh)
    if mesh is not None:
        set_batchnorm_mesh(model, mesh)
    return mesh


def _optimize(cfg: TrainConfig, state: TrainState, grads: Tensors,
              sched_step) -> None:
    """One optimizer apply and EMA update, the counters advanced."""
    optimizer_apply(cfg, state, grads, sched_step)
    state.ema_updates += 1
    ema_update(cfg, state.ema_params, state.params, state.ema_updates)
    state.step += 1


def make_train_step(model: YoloFace, cfg: TrainConfig,
                    hyp: Dict[str, float], img_size: int,
                    mesh=None) -> Callable:
    """The train step `step(state, images, targets) -> (state, loss,
    components)`: forward, loss, backward, one optimizer apply and one EMA
    update, in place on `state` (whose model is `model`). `images` are a
    uint8 or float NHWC batch, `targets` the arrays of
    `build_targets_batched`; both move to the model's device. Applies
    `cfg.freeze_until` to the model's requires_grad flags.

    With `mesh` (a parallel.mesh.DataMesh) every rank calls the step with
    its rows of the global batch (`parallel.mesh.shard_batch`); the
    model's BatchNorms take the mesh, the gradients are summed over it in
    one collective a dtype before the apply, and the loss and components
    returned are the global batch's."""
    h = scale_loss_gains(hyp, model.spec.nl, model.spec.nc, img_size)
    mesh = _attach(model, cfg, mesh)
    run = _grad_fn(model, h, mesh)

    def step_fn(state: TrainState, images, targets):
        loss, components, grads = run(images, targets)
        if mesh is not None:
            all_reduce_tensors(mesh, grads)
        _optimize(cfg, state, grads, state.step)
        return state, loss, components

    return step_fn


def make_accum_steps(model: YoloFace, cfg: TrainConfig,
                     hyp: Dict[str, float], img_size: int, mesh=None):
    """Gradient-accumulation pair: `grad_fn(state, images, targets,
    grads_acc)` adds one micro-batch's gradients into `grads_acc` (the
    loss.backward() accumulation semantics, train.py:409,437-442) and
    `apply_fn(state, grads, sched_step)` performs one optimizer + EMA
    step with the lr/momentum schedule evaluated at the global
    micro-iteration `sched_step` (the reference's `ni`): warmup and the
    per-epoch cosine schedule count micro-batches, not applies, so with
    accumulation the schedule is not driven off state.step.

    With `mesh`, as `make_train_step`: `grad_fn` takes this rank's rows
    and returns the global loss and components, and `grads_acc` holds
    this rank's share; `apply_fn` sums the accumulated gradients over the
    mesh once, in place, before the optimizer (the reference's DDP
    no_sync accumulation; the JAX package sums global gradients at each
    micro-step, the same sum up to rounding)."""
    h = scale_loss_gains(hyp, model.spec.nl, model.spec.nc, img_size)
    mesh = _attach(model, cfg, mesh)
    run = _grad_fn(model, h, mesh)

    def grad_fn(state: TrainState, images, targets, grads_acc: Tensors):
        loss, components, grads = run(images, targets)
        names = list(grads)
        torch._foreach_add_([grads_acc[n] for n in names],
                            [grads[n] for n in names])
        return state, grads_acc, loss, components

    def apply_fn(state: TrainState, grads: Tensors, sched_step):
        if mesh is not None:
            all_reduce_tensors(mesh, grads)
        _optimize(cfg, state, grads, sched_step)
        return state

    return grad_fn, apply_fn


def zero_grads_like(params: Tensors) -> Tensors:
    return {n: torch.zeros_like(p) for n, p in params.items()}

