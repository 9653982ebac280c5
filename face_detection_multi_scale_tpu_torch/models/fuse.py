"""Conv+BN folding for serving.

Counterpart of the JAX package's models/fuse.py `fold_bn`, applied to the
torch modules: every ConvBN's BatchNorm folds into its conv
(w' = w * g, b' = beta - mu * g, g = gamma / sqrt(var + eps)), computed in
float64 and stored in the conv's dtype, as the reference's `.fuse()`
(models/yolo.py:441-449) and the JAX fold do. The BN module is removed,
so serving runs conv + bias only. Do not train a fused model: the running
statistics are gone by design.
"""

from __future__ import annotations

import torch
from torch import nn

from face_detection_multi_scale_tpu_torch.models.layers import ConvBN


@torch.no_grad()
def fold_bn(model: nn.Module) -> nn.Module:
    """Fold every ConvBN's BN into its conv, in place; returns `model`."""
    for mod in model.modules():
        if not isinstance(mod, ConvBN) or mod.bn is None:
            continue
        conv, bn = mod.conv, mod.bn
        g = bn.weight.double() / torch.sqrt(bn.running_var.double()
                                            + bn.eps)
        w = conv.weight.double() * g.reshape(-1, 1, 1, 1)
        b = bn.bias.double() - bn.running_mean.double() * g
        conv.weight.copy_(w.to(conv.weight.dtype))
        conv.bias = nn.Parameter(b.to(conv.weight.dtype))
        mod.bn = None
    return model
