"""Everything a run feeds the program and the reference, made from the
seed on the device in a few large calls: the weights, as a state dict with
the reference key names, and the uint8 frames.

Seeded weights with arbitrary BN statistics collapse a deep network: its
output barely varies over the image, every conf of a level lies within
rounding of the others, and which rows clear a gate or survive the NMS is
decided by the last bits. So the BN statistics are measured instead, as
training leaves them: each BN's running mean and variance are those of
its input over a few of the run's frames, the variance divided by
`bn_out_std` squared, so that each normalised channel varies with that
std times its gamma. Near 1 the net is critical, and 0.85 keeps it from
amplifying rounding while conf still spreads over the image."""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import model as RM

# lecun-normal: a normal truncated to +-2 std, rescaled to unit variance
TRUNC_STD = 0.87962566103423978


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one of a run's independent streams."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % 2 ** 63)


def _leaf_kind(key: str, shape) -> str:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) == 4:
        return "kernel"
    if leaf == "implicit":
        return "implicit"
    if ".bn." in key or key.endswith(("running_mean", "running_var")):
        return {"weight": "bn_weight", "bias": "bn_bias",
                "running_mean": "bn_mean", "running_var": "bn_var"}[leaf]
    return "bias"


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights: conv kernels lecun-normal (fan-in variance,
    truncated at 2 std), conv biases N(0, 0.1), BN gamma U(0.8, 1.2), beta
    N(0, 0.1), mean N(0, 0.1), var U(0.5, 1.5), ImplicitA N(0, 0.02) and
    ImplicitM 1 + N(0, 0.02). One draw per distribution, split by leaf."""
    shapes = RM.state_dict_shapes(cfg)
    kinds = {k: _leaf_kind(k, s) for k, s in shapes.items()}
    gen = generator(seed, device, 0)

    def flat(kind):
        keys = [k for k in shapes if kinds[k] == kind]
        return keys, sum(math.prod(shapes[k]) for k in keys)

    out: Dict[str, torch.Tensor] = {}

    def split(keys, buf):
        off = 0
        for k in keys:
            n = math.prod(shapes[k])
            out[k] = buf[off:off + n].view(shapes[k])
            off += n

    keys, n = flat("kernel")
    buf = torch.empty(n, device=device)
    torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=gen)
    split(keys, buf)
    for k in keys:
        out[k].mul_(math.sqrt(1.0 / math.prod(shapes[k][1:])) / TRUNC_STD)
    normal = [("bias", 0.0, 0.1), ("bn_bias", 0.0, 0.1),
              ("bn_mean", 0.0, 0.1), ("implicit", 0.0, 0.02)]
    uniform = [("bn_weight", 0.8, 1.2), ("bn_var", 0.5, 1.5)]
    for dist, params in (("normal", normal), ("uniform", uniform)):
        groups = [(flat(kind), lo, hi) for kind, lo, hi in params]
        total = sum(n for (_, n), _, _ in groups)
        buf = (torch.randn if dist == "normal" else torch.rand)(
            total, generator=gen, device=device)
        off = 0
        for (keys, n), a, b in groups:
            part = buf[off:off + n]
            part.mul_(b).add_(a) if dist == "normal" else \
                part.mul_(b - a).add_(a)
            split(keys, part)
            off += n
    for k, kind in kinds.items():
        if kind == "implicit" and ".im." in k:
            out[k].add_(1.0)
    return out


@torch.no_grad()
def calibrate_bn(cfg: Dict, weights: Dict[str, torch.Tensor],
                 images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
    """`weights` with every BN's running mean and variance measured on
    `images_u8` (uint8 NHWC) by the reference in float32, layer after
    layer, the variance divided by `cfg["seeded_weights"]["bn_out_std"]`
    squared."""
    std = cfg["seeded_weights"]["bn_out_std"]
    model = RM.Reference(cfg).to(images_u8.device)
    model.load_state_dict(weights, strict=False)
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_running_stats()
            mod.momentum = None  # the running stats are this batch's
            mod.train()
    with RM.no_tf32():
        model(images_u8.permute(0, 3, 1, 2).float() / 255.0)
    out = dict(weights)
    for k, v in model.state_dict().items():
        if k.endswith("running_mean"):
            out[k] = v
        elif k.endswith("running_var"):
            out[k] = v / std ** 2
    return out


def make_frames(seed: int, count: int, shape, device) -> torch.Tensor:
    """`count` uint8 frames of `shape` (h, w, 3) of uniform noise."""
    gen = generator(seed, device, 1)
    return torch.randint(0, 256, (count, *shape), generator=gen,
                         dtype=torch.uint8, device=device)
