"""Building blocks of the flagship graph as torch modules (NCHW, channels_last).

Same math as the JAX package's nn/modules.py, with parameter names that
follow the reference's torch state (`conv`/`bn`, `cv1`, `m.0`,
`ca.shared_MLP.0`, `attn.in_proj_weight`, `mlp.0`, `cv2.0.2`), so weights
carry across by name. Input channels are explicit constructor arguments
(the JAX modules infer them at init); parse_model supplies them.

Weights are cast to the activation's dtype where they are used, as flax
casts its fp32 parameters to the module dtype: a model may hold fp32 master
weights (training) and compute in bf16. In training mode Conv's BatchNorm
keeps flax's semantics, SwinBlock runs the differentiable block and Detect
returns its raw maps only.

Conv and SwinBlock take part in int8 post-training quantization
(ops/quant.py): while `calib` is a dict they record the |max| of what their
int8 products would take, and once their quant buffers are set (None until
then, so absent from the state) they run those products in int8 in eval mode.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.anchors import dfl_decode, dist2bbox, make_anchors
from ..ops.quant import conv_int8
from ..ops.swin import swin_block, swin_block_train
from ..ops.swin_int8 import QNAMES as SWIN_QNAMES
from ..ops.swin_int8 import q8, swin_block_int8, swin_gemm_absmax
from ..utils.fuse import fold_bn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch convention; the flax 0.97


class Conv2d(nn.Conv2d):
    """nn.Conv2d that casts its weight and bias to the input's dtype at use."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def batch_norm_train(bn: nn.BatchNorm2d, y32: torch.Tensor) -> torch.Tensor:
    """BatchNorm in training with flax's semantics: normalise by the batch
    mean and biased variance, then move the running statistics as
    r = 0.97 r + 0.03 s with the BIASED batch variance. torch's batch_norm
    moves running_var with the unbiased v * n / (n - 1); its surplus
    0.03 v / (n - 1), which is (r_new - 0.97 r_old) / n, is taken back, so
    the statistics cost no second pass over y."""
    new_var = bn.running_var.clone()  # batch_norm moves it in place; autograd keeps it for the backward
    out = F.batch_norm(y32, bn.running_mean, new_var, bn.weight, bn.bias, True, BN_MOMENTUM, bn.eps)
    with torch.no_grad():
        n = y32.numel() // y32.shape[1]
        bn.running_var.mul_((1 - BN_MOMENTUM) / n).add_(new_var, alpha=1 - 1 / n)
    return out


def record_amax(calib: Dict[str, torch.Tensor], key: str, t: torch.Tensor) -> None:
    """calib[key] = max(calib[key], |t|.max()) in fp32: a calibration pass's running maximum."""
    amax = t.float().abs().amax()
    calib[key] = torch.maximum(calib[key], amax) if key in calib else amax


class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm(eps 1e-3) + SiLU. The BatchNorm runs in
    fp32 and its output is cast back to the compute dtype, as in the JAX
    package. After `fuse()` the BN is folded into the conv's weight and bias.

    Quantized (buffers w_int8 (O, I, kh, kw), w_scale (O,), x_scale ()), the
    eval forward quantizes its input to x_scale, sums the int8 products
    exactly (ops/quant.py conv_int8), dequantizes in fp32, adds the folded
    bias in fp32 (or applies the BN), casts to the compute dtype and applies
    SiLU, as the JAX package's int8 branch does."""

    QNAMES = ("w_int8", "w_scale", "x_scale")

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.calib: Optional[Dict[str, torch.Tensor]] = None  # running input |max| during calibration
        for name in self.QNAMES:
            self.register_buffer(name, None)

    def forward(self, x):
        if self.calib is not None:
            record_amax(self.calib, "x_amax", x)
        if self.w_int8 is not None and not self.training:
            y = conv_int8(x, self.w_int8, self.w_scale, self.x_scale, self.conv.stride[0], self.conv.padding[0])
            y = self.bn(y) if self.bn is not None else y + self.conv.bias.float().view(1, -1, 1, 1)
            return F.silu(y.to(x.dtype))
        y = self.conv(x)
        if self.bn is not None:
            y = (batch_norm_train(self.bn, y.float()) if self.training else self.bn(y.float())).to(y.dtype)
        return F.silu(y)

    @torch.no_grad()
    def fuse(self):
        """Fold the BatchNorm into the conv's weight and a new bias."""
        if self.bn is None:
            return
        if self.w_int8 is not None:
            raise ValueError("fuse() before quantize_model: folding the BatchNorm would change the weights "
                             "that the int8 copy was made from")
        bn = self.bn
        w, b = fold_bn(self.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        self.conv.weight.copy_(w)
        self.conv.bias = nn.Parameter(b)
        self.bn = None


class Bottleneck(nn.Module):
    """Two 3x3 convs at constant width and an optional residual (C2f's inner block)."""

    def __init__(self, c: int, shortcut: bool):
        super().__init__()
        self.cv1 = Conv(c, c, 3)
        self.cv2 = Conv(c, c, 3)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck of YOLOv8: split, n bottlenecks, concat, merge."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        c = c2 // 2
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv((2 + n) * c, c2)
        self.m = nn.ModuleList(Bottleneck(c, shortcut) for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained k x k stride-1 max pools
    (padding with -inf, as the JAX package's reduce_window)."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(c_ * 4, c2)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


class ChannelAttention(nn.Module):
    """avg and max pool -> shared bias-free 1x1 MLP -> sum -> sigmoid gate."""

    def __init__(self, c1: int, ratio: int = 16):
        super().__init__()
        reduced = max(1, c1 // ratio)
        self.shared_MLP = nn.Sequential(
            Conv2d(c1, reduced, 1, bias=False), nn.ReLU(), Conv2d(reduced, c1, 1, bias=False)
        )

    def forward(self, x):
        avg = x.mean((2, 3), keepdim=True)
        mx = x.amax((2, 3), keepdim=True)
        return torch.sigmoid(self.shared_MLP(avg) + self.shared_MLP(mx))


class SpatialAttention(nn.Module):
    """channel mean and max -> concat -> 7x7 conv -> sigmoid gate."""

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, x):
        y = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return torch.sigmoid(self.conv(y))


class CBAM(nn.Module):
    """x = x * CA(x); x = x * SA(x). The fork's YAML row `CBAM, []` leaves
    channels None, so the ratio resolves to 16."""

    def __init__(self, c1: int, channels: Optional[int] = None):
        super().__init__()
        ratio = 8 if (channels is not None and channels < 128) else 16
        self.ca = ChannelAttention(c1, ratio)
        self.sa = SpatialAttention()

    def forward(self, x):
        x = x * self.ca(x)
        return x * self.sa(x)


class SwinBlock(nn.Module):
    """Window self-attention + MLP on plain (unshifted) 7x7 windows, no
    position bias, LN eps 1e-5, residual from the normed tokens: the fork's
    block. The dim is the runtime channel count (the YAML dim is advisory).

    The forward runs `ops.swin.swin_block` on the NHWC view of the
    channels_last input: the CUDA kernel on the card, the plain version on
    the CPU. Windows past the edge see zero tokens, as the reference pads
    H and W to a multiple of 7 with zeros and crops the output. Inference
    runs the kernel's `fast` mode; training runs `swin_block_train` (exact
    forward, backward kernel), as the reference's custom_vjp does. `impl`
    stays None (choose by device) except where a check forces the plain
    versions on the card to compare with the kernels.

    Quantized (the buffers of ops/swin_int8.QNAMES) and with a head dim that
    is a multiple of 128, the eval forward quantizes its input to
    x_in_scale, runs the int8 block (ops.swin_int8.swin_block_int8) with int8
    input and output and dequantizes with y_out_scale in the compute dtype.
    The head-dim gate is the JAX package's: its TPU runs the int8 kernel only
    there, and a narrower head keeps the float block."""

    QNAMES = SWIN_QNAMES

    def __init__(self, c1: int, num_heads: int = 2, window_size: int = 7):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.impl: Optional[str] = None
        self.norm1 = nn.LayerNorm(c1)
        self.attn = nn.MultiheadAttention(c1, num_heads)  # holds in_proj_weight, out_proj
        self.norm2 = nn.LayerNorm(c1)
        self.mlp = nn.Sequential(nn.Linear(c1, 4 * c1), nn.GELU(), nn.Linear(4 * c1, c1))
        self.calib: Optional[Dict[str, torch.Tensor]] = None  # running |max| of the int8 inputs during calibration
        for name in self.QNAMES:
            self.register_buffer(name, None)

    @property
    def runs_int8(self) -> bool:
        """Quantized, and the head dim a multiple of 128 (the JAX package's gate)."""
        c = self.norm1.weight.numel()  # a multiple of the heads: MultiheadAttention checks it
        return self.qkv_w_int8 is not None and (c // self.num_heads) % 128 == 0

    def kernel_params(self):
        return {
            "ln1_w": self.norm1.weight, "ln1_b": self.norm1.bias,
            "wqkv": self.attn.in_proj_weight, "bqkv": self.attn.in_proj_bias,
            "wout": self.attn.out_proj.weight, "bout": self.attn.out_proj.bias,
            "ln2_w": self.norm2.weight, "ln2_b": self.norm2.bias,
            "w1": self.mlp[0].weight, "b1": self.mlp[0].bias,
            "w2": self.mlp[2].weight, "b2": self.mlp[2].bias,
        }

    def forward(self, x):
        xh = x.permute(0, 2, 3, 1)
        if self.training:
            y = swin_block_train(xh, self.kernel_params(), self.num_heads, self.window_size, impl=self.impl)
        elif self.calib is not None:
            y = self._calibrate(xh)
        elif self.runs_int8:
            q = {k: getattr(self, k) for k in self.QNAMES}
            xq = q8(xh.float(), self.x_in_scale).to(torch.int8)
            y8 = swin_block_int8(xq, self.kernel_params(), q, self.num_heads, self.window_size, in8=True, out8=True,
                                 impl=self.impl)
            y = y8.to(x.dtype) * self.y_out_scale.to(x.dtype)
        else:
            y = swin_block(xh, self.kernel_params(), self.num_heads, self.window_size, fast=True, impl=self.impl)
        return y.permute(0, 3, 1, 2)

    def _calibrate(self, xh):
        """Record the four product inputs' |max| (swin_gemm_absmax), the
        input's and the float block's output's, over the zero-padded windows
        as the JAX package does, and return the float block's output."""
        b, h, w, _ = xh.shape
        ws = self.window_size
        p = self.kernel_params()
        for key, amax in swin_gemm_absmax(xh, p, self.num_heads, ws).items():
            record_amax(self.calib, f"{key}_amax", amax)
        record_amax(self.calib, "xin_amax", xh)
        yp = swin_block(F.pad(xh, (0, 0, 0, (-w) % ws, 0, (-h) % ws)), p, self.num_heads, ws, fast=True,
                        impl=self.impl)
        record_amax(self.calib, "yout_amax", yp)
        return yp[:, :h, :w].contiguous()


class Concat(nn.Module):
    def forward(self, xs: List[torch.Tensor]):
        return torch.cat(xs, 1)


class Upsample(nn.Module):
    """Nearest-neighbour integer upsample."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Detect(nn.Module):
    """Anchor-free YOLOv8 detect head (legacy cls branch).

    Returns ((B, 4 + nc, A) decoded xywh boxes in input pixels followed by
    class sigmoids, the per-level raw maps (B, 4*reg_max + nc, H, W)); in
    training only the raw maps. The decode runs in fp32; the DFL is a
    function, not a module."""

    reg_max = 16  # DFL bins per box side

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int] = (8, 16, 32)):
        super().__init__()
        self.nc = nc
        self.strides = tuple(strides)
        reg_max = self.reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1)) for x in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), Conv2d(c3, nc, 1)) for x in ch
        )

    def bias_init(self):
        """Box logits start at 1, class logits at the prior of 5 objects per 640 px image."""
        with torch.no_grad():
            for a, b, s in zip(self.cv2, self.cv3, self.strides):
                a[-1].bias.fill_(1.0)
                b[-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def forward(self, xs: List[torch.Tensor]):
        feats = [torch.cat([a(x), b(x)], 1) for x, a, b in zip(xs, self.cv2, self.cv3)]
        if self.training:
            return feats
        bsz = feats[0].shape[0]
        no = 4 * self.reg_max + self.nc
        x_cat = torch.cat([f.reshape(bsz, no, -1) for f in feats], 2).float()  # (B, no, A)
        box, cls = x_cat.split((4 * self.reg_max, self.nc), 1)
        anchors, strides = make_anchors([f.shape[2:] for f in feats], self.strides, device=x_cat.device)
        dbox = dist2bbox(dfl_decode(box, self.reg_max), anchors.t()[None]) * strides.t()[None]
        return torch.cat([dbox, cls.sigmoid()], 1), feats
