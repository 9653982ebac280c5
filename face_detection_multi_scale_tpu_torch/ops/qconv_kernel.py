"""The int8 conv of W8A8 serving: the hand-written CUDA kernel and its plain
version.

`qconv` computes one conv of the int8 walk (models/quant.py), fused as the
JAX package's quant.py:518-530, where XLA runs
`conv_general_dilated(..., preferred_element_type=int32)` and fuses the
requant into it:

    y32 = conv(x_q, w_q)                                  exact int32
    z   = act(float32(y32) * alpha[c] + bias[c])          float32, in order
    out = clip(round_half_even(z * inv_out), -127, 127)   int8

x_q is NHWC int8 (B, H, W, Cin), w_q OHWI int8 (Cout, kh, kw, Cin /
groups), alpha and bias float32 (Cout,), inv_out a float32 scalar; act is
"none", "silu", "leaky" (slope 0.1) or "relu"; symmetric pads (ph, pw).
The output is NHWC int8 (B, Ho, Wo, Cout).

Source: csrc/qconv.cu, CUDA C++ for sm_90a, compiled by nvcc at first use
(ops/cuda_build.py) and bound with ctypes; see the source for what bounds
it and its design. PyTorch has no int8 convolution on CUDA (F.conv2d
refuses int8, and `torch._int_mm` is a bare GEMM whose im2col and int32
output would each cost a pass over memory), so there is no library conv
to call.

On a CPU tensor `qconv` runs `qconv_plain`; on a CUDA tensor it launches
the kernel or raises. `qconv.launches` counts the kernel's launches,
`qconv.depthwise_launches` those of them that took the direct path of a
grouped conv (depthwise in the zoo).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from face_detection_multi_scale_tpu_torch.models.layers import act_fn
from face_detection_multi_scale_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "qconv.cu"
# -fmad=false: y * alpha + bias must not contract into an FMA, or the last
# bit of z differs from the plain version's two rounded operations
NVCC_FLAGS = cuda_build.BASE_FLAGS + ("-fmad=false",)
ACTS = {"none": 0, "silu": 1, "leaky": 2, "relu": 3}


def out_hw(h: int, w: int, k: Tuple[int, int], stride: int,
           pads: Tuple[int, int]) -> Tuple[int, int]:
    return ((h + 2 * pads[0] - k[0]) // stride + 1,
            (w + 2 * pads[1] - k[1]) // stride + 1)


def conv_sums(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pads: Tuple[int, int] = (0, 0), groups: int = 1
              ) -> torch.Tensor:
    """The exact int32 sums conv(x_q, w_q), NHWC (B, Ho, Wo, Cout): the
    int8 values through F.conv2d in float64, exact since |sum| <= 127^2 *
    kh * kw * Cin < 2^53 (rounded, so an algorithm that is not exact in
    float64 still lands on the integer)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).double(),
                 w.permute(0, 3, 1, 2).double(), None, stride, tuple(pads),
                 1, groups)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def pre_round(y32: torch.Tensor, alpha: torch.Tensor, bias: torch.Tensor,
              inv_out, act: str) -> torch.Tensor:
    """The float32 epilogue up to the rounding, op by op in the JAX order:
    act(f32(y32) * alpha + bias) * inv_out."""
    yf = y32.float() * alpha
    yf = yf + bias
    return act_fn(act)(yf) * inv_out


def qconv_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                bias: torch.Tensor, inv_out, stride: int = 1,
                pads: Tuple[int, int] = (0, 0), groups: int = 1,
                act: str = "none") -> torch.Tensor:
    """Plain PyTorch `qconv` (torch.round rounds half to even, as
    jnp.round)."""
    z = pre_round(conv_sums(x, w, stride, pads, groups), alpha, bias,
                  inv_out, act)
    return torch.clamp(torch.round(z), -127, 127).to(torch.int8)


def build():
    """Compile csrc/qconv.cu (once per source and flags); returns the
    shared library's path."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fdms_qconv.argtypes = [vp, vp, vp, vp, ctypes.c_float, vp] \
        + [i32] * 13 + [vp]
    lib.fdms_qconv.restype = i32
    return lib


def qconv(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
          bias: torch.Tensor, inv_out, stride: int = 1,
          pads: Tuple[int, int] = (0, 0), groups: int = 1,
          act: str = "none") -> torch.Tensor:
    """One fused int8 conv (see the module docstring). x (B, H, W, Cin)
    int8 and w (Cout, kh, kw, Cin / groups) int8 contiguous, alpha and
    bias float32 (Cout,) contiguous, all on one device; inv_out a float or
    a float32 scalar tensor. Returns (B, Ho, Wo, Cout) int8."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x and w must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    b, h, wd, cin = x.shape
    cout, kh, kw, cg = w.shape
    if groups < 1 or cin % groups or cout % groups or cg * groups != cin:
        raise ValueError(f"w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)} with groups={groups}")
    if tuple(alpha.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"alpha {tuple(alpha.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({cout},)")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or \
            alpha.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"need int8 x and w, float32 alpha and bias, got "
                        f"{x.dtype}, {w.dtype}, {alpha.dtype}, {bias.dtype}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    if stride < 1 or min(pads) < 0:
        raise ValueError(f"bad stride {stride} or pads {pads}")
    if len({t.device for t in (x, w, alpha, bias)}) != 1:
        raise ValueError("x, w, alpha and bias must be on one device")
    ho, wo = out_hw(h, wd, (kh, kw), stride, pads)
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output {ho}x{wo}")
    if x.device.type == "cpu":
        return qconv_plain(x, w, alpha, bias, inv_out, stride, pads, groups,
                           act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, w, alpha, bias)):
        raise ValueError("x, w, alpha and bias must be contiguous")
    if max(x.numel(), w.numel(), b * ho * wo * cout) >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's indexing")
    y = torch.empty((b, ho, wo, cout), dtype=torch.int8, device=x.device)
    err = _library().fdms_qconv(
        x.data_ptr(), w.data_ptr(), alpha.data_ptr(), bias.data_ptr(),
        float(inv_out), y.data_ptr(), b, h, wd, cin, cout, kh, kw, stride,
        pads[0], pads[1], groups, ACTS[act], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qconv kernel launch failed: CUDA error {err}")
    qconv.launches += 1
    if groups > 1:
        qconv.depthwise_launches += 1
    return y


qconv.launches = 0
qconv.depthwise_launches = 0
