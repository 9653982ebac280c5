"""The plain reference network: a YOLOv7-face model built from the layer
table of a configuration file, in float32 with TF32 off.

Written for the benchmark from the published cfg semantics (the
yolov7-face repository's models/common.py and models/yolo.py), not taken
from the program under test. Module names follow the reference
checkpoints (`model.{i}.conv.weight`, `cv1`..`cv7`, `m`, `m_kpt`, `ia`,
`im`), so one state dict feeds both the program and this model. Only the
ops of the two benchmarked models are built: Conv, Concat, SPPCSPC,
nn.Upsample, ReOrg, MP, SPF and the IKeypoint head.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in full float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _act(name):
    if name == "leaky":
        return lambda x: F.leaky_relu(x, 0.1)
    return F.silu


class ConvBN(nn.Module):
    """Conv2d without bias, BatchNorm (eps 1e-3), activation."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act="silu"):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS)
        self.act = _act(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class SPPCSPC(nn.Module):
    def __init__(self, c1, c2):
        super().__init__()
        c_ = c2
        self.cv1 = ConvBN(c1, c_)
        self.cv2 = ConvBN(c1, c_)
        self.cv3 = ConvBN(c_, c_, 3)
        self.cv4 = ConvBN(c_, c_)
        self.cv5 = ConvBN(4 * c_, c_)
        self.cv6 = ConvBN(c_, c_, 3)
        self.cv7 = ConvBN(2 * c_, c2)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        pools = [F.max_pool2d(x1, k, 1, k // 2) for k in (5, 9, 13)]
        y1 = self.cv6(self.cv5(torch.cat([x1, *pools], 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))


class Op(nn.Module):
    """A parameter-free node."""

    def __init__(self, op, args):
        super().__init__()
        self.op, self.args = op, args

    def forward(self, x):
        op = self.op
        if op == "Concat":
            return torch.cat(x, 1)
        if op == "Upsample":
            return F.interpolate(x, scale_factor=2.0, mode="nearest")
        if op == "ReOrg":
            return torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                              x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1)
        if op == "MP":
            return F.max_pool2d(x, 2, 2)
        if op == "SPF":
            for _ in range((int(self.args[0]) - 1) // 2):
                x = F.max_pool2d(x, 3, 1, 1)
            return x
        raise NotImplementedError(op)


class IKeypoint(nn.Module):
    """Implicit detection head with landmark convs: raw maps (B, na*no,
    ny, nx) per level, det channels then kpt channels."""

    def __init__(self, cfg, ch):
        super().__init__()
        na = len(cfg["anchors"][0]) // 2
        no_det, no_kpt = cfg["nc"] + 5, 3 * cfg["nkpt"]
        self.m = nn.ModuleList(nn.Conv2d(c, no_det * na, 1) for c in ch)
        self.ia = nn.ModuleList(Implicit(c, 0.0) for c in ch)
        self.im = nn.ModuleList(Implicit(no_det * na, 1.0) for _ in ch)
        if cfg["dw_conv_kpt"]:
            def tower(c):
                mods = []
                for _ in range(5):
                    mods += [ConvBN(c, c, 3, g=c), ConvBN(c, c, 1)]
                return nn.Sequential(*mods, ConvBN(c, c, 3, g=c),
                                     nn.Conv2d(c, no_kpt * na, 1))
            self.m_kpt = nn.ModuleList(tower(c) for c in ch)
        else:
            self.m_kpt = nn.ModuleList(nn.Conv2d(c, no_kpt * na, 1)
                                       for c in ch)

    def forward(self, xs):
        return [torch.cat([self.m[i](x + self.ia[i].implicit)
                           * self.im[i].implicit, self.m_kpt[i](x)], 1)
                for i, x in enumerate(xs)]


class Implicit(nn.Module):
    def __init__(self, c, start):
        super().__init__()
        self.implicit = nn.Parameter(torch.full((1, c, 1, 1), start))


class Reference(nn.Module):
    """The model of a configuration file's `layers` table."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        ch: List[int] = []
        mods = []
        self.froms = []
        used = set()
        for i, (f, n, op, args) in enumerate(cfg["layers"]):
            f = [f] if isinstance(f, int) else list(f)
            f = [j if j >= 0 else i + j for j in f]
            self.froms.append(f)
            used.update(j for j in f if j != i - 1)
            c_in = [ch[j] if j >= 0 else 3 for j in f]
            if op == "Conv":
                act = args[-1] if isinstance(args[-1], str) else "silu"
                mods.append(ConvBN(c_in[0], args[0], args[1], args[2],
                                   act=act))
                c2 = args[0]
            elif op == "SPPCSPC":
                mods.append(SPPCSPC(c_in[0], args[0]))
                c2 = args[0]
            elif op == "IKeypoint":
                mods.append(IKeypoint(cfg, c_in))
                c2 = 0
            else:
                mods.append(Op(op, args))
                c2 = {"Concat": sum(c_in), "ReOrg": 4 * c_in[0]}.get(
                    op, c_in[0])
            ch.append(c2)
        self.model = nn.ModuleList(mods)
        self.keep = used

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NCHW float input in [0, 1] -> the head's raw maps."""
        saved: Dict[int, torch.Tensor] = {}
        for i, (f, m) in enumerate(zip(self.froms, self.model)):
            inp = [x if j == i - 1 else saved[j] for j in f]
            x = m(inp if len(f) > 1 or isinstance(m, IKeypoint) else inp[0])
            if i in self.keep:
                saved[i] = x
        return x


def state_dict_shapes(cfg: Dict) -> Dict[str, torch.Size]:
    """Key -> shape of every float entry of the reference state dict
    (built on the meta device: nothing allocated)."""
    with torch.device("meta"):
        sd = Reference(cfg).state_dict()
    return {k: v.shape for k, v in sd.items() if v.is_floating_point()}


@torch.no_grad()
def fold_bn(model: Reference) -> Reference:
    """Fold every BatchNorm into the conv before it (in float64), in
    place: w' = w g, b' = beta - mu g, g = gamma / sqrt(var + eps)."""
    for mod in model.modules():
        if isinstance(mod, ConvBN) and isinstance(mod.bn, nn.BatchNorm2d):
            bn, conv = mod.bn, mod.conv
            g = bn.weight.double() / torch.sqrt(bn.running_var.double()
                                                + bn.eps)
            w = conv.weight.double() * g.reshape(-1, 1, 1, 1)
            conv.weight.copy_(w.float())
            conv.bias = nn.Parameter(
                (bn.bias.double() - bn.running_mean.double() * g).float())
            mod.bn = nn.Identity()
    return model


FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 with one scale (its amax over 448), back
    in float32."""
    s = t.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def to_fp8(model: "Reference") -> "Reference":
    """The control's precision: every convolution's weights, input and
    output stored in float8 e4m3, one scale a tensor, the sums in
    float32."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            with torch.no_grad():
                mod.weight.copy_(fp8(mod.weight))
            mod.register_forward_pre_hook(lambda m, args: (fp8(args[0]),))
            mod.register_forward_hook(lambda m, args, out: fp8(out))
    return model


def build(cfg: Dict, state_dict, device, control: bool = False
          ) -> Reference:
    """The folded float32 reference on `device` from a state dict with
    reference key names; with `control`, its convolutions in float8."""
    model = Reference(cfg)
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"state dict does not match the configuration: "
                         f"missing {missing}, unexpected {unexpected}")
    model = fold_bn(model).to(device).eval()
    return to_fp8(model) if control else model


def decode(raws: Sequence[torch.Tensor], cfg: Dict) -> torch.Tensor:
    """Raw maps -> rows (B, N, 5 + nc + 3 nkpt) in input pixels: levels in
    order, anchor-major, raster cells. The head's conv channels are read
    as (na, no) anchor-major, as the published head's view does."""
    na = len(cfg["anchors"][0]) // 2
    nc, nkpt = cfg["nc"], cfg["nkpt"]
    no = nc + 5 + 3 * nkpt
    rows = []
    for lvl, raw in enumerate(raws):
        b, _, ny, nx = raw.shape
        s = float(cfg["strides"][lvl])
        t = raw.float().reshape(b, na, no, ny, nx).permute(0, 1, 3, 4, 2)
        gy, gx = torch.meshgrid(torch.arange(ny, device=raw.device),
                                torch.arange(nx, device=raw.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).float()[None, None]
        anchor = torch.tensor(cfg["anchors"][lvl], device=raw.device
                              ).reshape(1, na, 1, 1, 2)
        sig = torch.sigmoid(t[..., :5 + nc])
        xy = (sig[..., :2] * 2 - 0.5 + grid) * s
        wh = (sig[..., 2:4] * 2) ** 2 * anchor
        k = t[..., 5 + nc:].reshape(b, na, ny, nx, nkpt, 3)
        kxy = (k[..., :2] * 2 - 0.5 + grid[..., None, :]) * s
        kc = torch.sigmoid(k[..., 2:])
        kp = torch.cat([kxy, kc], -1).reshape(b, na, ny, nx, 3 * nkpt)
        rows.append(torch.cat([xy, wh, sig[..., 4:], kp], -1)
                    .reshape(b, -1, no))
    return torch.cat(rows, 1)


def rows_of(model: Reference, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC network inputs -> decoded float32 rows."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    return rows_of_input(model, x)


@torch.no_grad()
def rows_of_input(model: Reference, x: torch.Tensor) -> torch.Tensor:
    """NCHW float32 network input in [0, 1] -> decoded float32 rows."""
    with no_tf32():
        return decode(model(x), model.cfg)
