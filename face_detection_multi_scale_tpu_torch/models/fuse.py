"""BatchNorm folding for serving.

Counterpart of the JAX package's models/fuse.py `fold_bn`, applied to the
torch modules, with the same pairing rules (computed in float64, stored in
the parameters' dtype, as the reference's `.fuse()`, models/yolo.py:441-449,
and the JAX fold do):

  * a BN fed directly by one bias-free conv folds into it: w' = w * g,
    b' = beta - mu * g, g = gamma / sqrt(var + eps), and the BN becomes an
    identity, so serving runs conv + bias only. The pairs, by the BN's
    name in its parent module: `bn` after `conv` (ConvBN), `bnN` after
    `convN` (DWConvblock), and in a Sequential index N after index N - 1
    (ShuffleBlock's branches, ConvBnReluMaxpool's `conv`);
  * any other BN (BottleneckCSP's `bn`, fed by a concat) becomes a
    precomputed affine: weight g, bias beta - mu * g, running mean 0 and
    running variance 1 - eps, so its normalization is the identity.

Do not train a folded model: the running statistics are gone by design.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn


def _conv_partner(parent: nn.Module, bn_name: str) -> Optional[str]:
    """The name of the bias-free conv in `parent` that feeds its BN
    `bn_name` directly, or None."""
    if bn_name == "bn":
        cand = "conv"
    elif re.fullmatch(r"bn\d+", bn_name):
        cand = "conv" + bn_name[2:]
    elif isinstance(parent, nn.Sequential) and bn_name.isdigit():
        cand = str(int(bn_name) - 1)
    else:
        return None
    conv = parent._modules.get(cand)
    if isinstance(conv, nn.Conv2d) and conv.bias is None:
        return cand
    return None


@torch.no_grad()
def fold_bn(model: nn.Module) -> nn.Module:
    """Fold every BatchNorm of `model` for serving, in place; returns
    `model`."""
    for parent in list(model.modules()):
        for name, bn in list(parent.named_children()):
            if not isinstance(bn, nn.BatchNorm2d):
                continue
            g = bn.weight.double() / torch.sqrt(bn.running_var.double()
                                                + bn.eps)
            bias = bn.bias.double() - bn.running_mean.double() * g
            conv_name = _conv_partner(parent, name)
            if conv_name is not None:
                conv = parent._modules[conv_name]
                w = conv.weight.double() * g.reshape(-1, 1, 1, 1)
                conv.weight.copy_(w.to(conv.weight.dtype))
                conv.bias = nn.Parameter(bias.to(conv.weight.dtype))
                setattr(parent, name, nn.Identity())
            else:
                bn.weight.copy_(g.to(bn.weight.dtype))
                bn.bias.copy_(bias.to(bn.bias.dtype))
                bn.running_mean.zero_()
                bn.running_var.fill_(1.0 - bn.eps)
    return model
