"""Building blocks of the detect graphs as torch modules (NCHW, channels_last).

Same math as the JAX package's nn/modules.py and nn/modules_extra.py, with
parameter names that follow the reference's torch state (`conv`/`bn`,
`cv1`, `m.0`, `ca.shared_MLP.0`, `attn.in_proj_weight`, `mlp.0`,
`cv2.0.2`, `attn.qkv`, `ffn.0`, `cv3.0.0.0`, `conv.0` of a ghost
bottleneck, `conv1.bn` of a RepConv, `m.0.1.mlp.1` of an area-attention
block), so weights carry across by name. Input channels are explicit
constructor arguments (the JAX modules infer them at init); parse_model
supplies them.

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

import copy
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.anchors import dfl_decode, dist2bbox, make_anchors
from ..ops.nms import e2e_postprocess
from ..ops.quant import conv_int8
from ..ops.rotated import dist2rbox
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


def batch_norm_eval(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """BatchNorm of y (B, C, H, W) by its running statistics, in fp32, on
    the (B*H*W, C) view of the NHWC memory (see Conv.norm)."""
    b, c, h, w = y.shape
    y2 = y.float().permute(0, 2, 3, 1).reshape(-1, c)
    out = F.batch_norm(y2, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
    return out.view(b, h, w, c).permute(0, 3, 1, 2)


def record_amax(calib: Dict[str, torch.Tensor], key: str, t: torch.Tensor) -> None:
    """calib[key] = max(calib[key], |t|.max()) in fp32: a calibration pass's running maximum."""
    amax = t.float().abs().amax()
    calib[key] = torch.maximum(calib[key], amax) if key in calib else amax


def autopad(k, p=None):
    """'same' padding of a kernel k (int or (kh, kw)), unless p is given."""
    if isinstance(k, (tuple, list)):
        return tuple(autopad(x, p) for x in k)
    return k // 2 if p is None else p


def activate(y: torch.Tensor, act) -> torch.Tensor:
    """SiLU for act=True, ReLU for "relu" (the YAML-level override of
    yolov6), none for False: the JAX package's Conv activations."""
    if act is True:
        return F.silu(y)
    return F.relu(y) if act == "relu" else y


class Conv(nn.Module):
    """Conv2d(bias=False, groups g, padding p (default 'same'))
    + BatchNorm(eps 1e-3) + SiLU (ReLU with act="relu", none with
    act=False). The BatchNorm runs in fp32 and its output is cast back to the
    compute dtype, as in the JAX package. After `fuse()` the BN is folded into
    the conv's weight and bias; a Conv with `folds` False (a RepConv branch,
    which the JAX package's fuse_variables leaves unfolded) keeps it.

    Quantized (buffers w_int8 (O, I, kh, kw), w_scale (O,), x_scale ()), the
    eval forward of an ungrouped conv quantizes its input to x_scale, sums
    the int8 products exactly (ops/quant.py conv_int8), dequantizes in fp32,
    adds the folded bias in fp32 (or applies the BN), casts to the compute
    dtype and applies SiLU, as the JAX package's int8 branch does. A grouped
    conv (YOLO11's depth-wise convs) is calibrated and holds the buffers
    too, but keeps its float path: the JAX package gates its int8 branch on
    g == 1."""

    QNAMES = ("w_int8", "w_scale", "x_scale")
    folds = True  # DetectionModel.fuse folds its BatchNorm

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, g: int = 1, act=True, p=None):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p), groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act
        self.calib: Optional[Dict[str, torch.Tensor]] = None  # running input |max| during calibration
        for name in self.QNAMES:
            self.register_buffer(name, None)

    @property
    def runs_int8(self) -> bool:
        """Quantized and ungrouped (the JAX package's gate)."""
        return self.w_int8 is not None and self.conv.groups == 1

    def forward(self, x):
        if self.calib is not None:
            record_amax(self.calib, "x_amax", x)
        if self.runs_int8 and not self.training:
            y = conv_int8(x, self.w_int8, self.w_scale, self.x_scale, self.conv.stride[0], self.conv.padding[0])
            y = self.norm(y) if self.bn is not None else y + self.conv.bias.float().view(1, -1, 1, 1)
            return activate(y.to(x.dtype), self.act)
        y = self.conv(x)
        if self.bn is not None:
            y = self.norm(y).to(y.dtype)
        return activate(y, self.act)

    def norm(self, y: torch.Tensor) -> torch.Tensor:
        """The BatchNorm of the conv output y in fp32: batch statistics in
        training (batch_norm_train), the running ones in eval. Eval runs on
        the (B*H*W, C) view of the NHWC memory: a 4-D input would let cuDNN
        take it, whose check of the batch against its limit a torch.export
        program with a dynamic batch cannot keep (RepConv's branches keep
        their BatchNorms in a BN-folded model), and the 2-D kernel is the
        one the program runs, so a live model and its program agree bit for
        bit."""
        if self.training:
            return batch_norm_train(self.bn, y.float())
        return batch_norm_eval(self.bn, y)

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


class DWConv(Conv):
    """Depth-wise Conv: groups gcd(c1, c2), which is c1 where c2 == c1."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class Bottleneck(nn.Module):
    """Two convs (kernels k, hidden width c2 * e) and a residual where
    shortcut and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1])
        self.add = shortcut and c1 == c2

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
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut, e=1.0) for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C3(nn.Module):
    """CSP bottleneck with 3 convs: n bottlenecks (kernels k) on one 1x1
    branch of c2 / 2 channels, concat with the other, merge."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, k=((1, 1), (3, 3))):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(c1, c_)
        self.cv3 = Conv(2 * c_, c2)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, k=k, e=1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    """C3 with 3x3 kernels in both convs of its bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True):
        super().__init__(c1, c2, n, shortcut, k=((3, 3), (3, 3)))


class C3k2(nn.Module):
    """The CSP block of YOLO11: C2f whose inner blocks are C3k (two 3x3
    bottlenecks) with c3k, else Bottlenecks of hidden width c / 2."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5, shortcut: bool = True):
        super().__init__()
        c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv((2 + n) * c, c2)
        self.m = nn.ModuleList(C3k(c, c, 2, shortcut) if c3k else Bottleneck(c, c, shortcut) for _ in range(n))

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


class Attention(nn.Module):
    """Position-sensitive attention of YOLO11 over all H*W tokens: a 1x1 qkv
    conv whose channels are per head [q (kd) | k (kd) | v (hd)], key_dim
    kd = hd / 2; softmax(q k^T * kd^-0.5) v plus a depth-wise 3x3
    conv of v, then a 1x1 projection. The scores are computed in fp32 from
    the compute-dtype q and k (the JAX package's preferred_element_type
    float32), the softmax in fp32, cast to v's dtype for the product with v.
    No TPU kernel stands behind it: the JAX package leaves it to XLA."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = self.head_dim // 2
        self.scale = self.key_dim ** -0.5
        self.qkv = Conv(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        kd, hd = self.key_dim, self.head_dim
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, self.num_heads, 2 * kd + hd)
        q, k, v = qkv.split((kd, kd, hd), -1)
        scores = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float()) * self.scale
        attn = scores.softmax(-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, h, w, c).permute(0, 3, 1, 2)
        pe = self.pe(v.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        return self.proj(out + pe)


class PSABlock(nn.Module):
    """Attention and a 1x1 feed-forward (2c, SiLU; then c, no activation), each with a residual."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn = nn.Sequential(Conv(c, 2 * c), Conv(2 * c, c, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """YOLO11's CSP wrapper of n PSABlocks (heads of 64 channels) on one half
    of the channels."""

    def __init__(self, c1: int, c2: int, n: int = 1):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1, 2 * self.c)
        self.cv2 = Conv(2 * self.c, c2)
        self.m = nn.Sequential(*(PSABlock(self.c, num_heads=max(1, self.c // 64)) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


class PSA(PSABlock):
    """YOLOv10's position-sensitive attention: a PSABlock (`attn`, `ffn`;
    heads of 64 channels) on one half of the channels, c = c2 e, between a
    1x1 split (`cv1`) and a 1x1 merge (`cv2`)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        c = int(c2 * e)
        super().__init__(c, num_heads=c // 64)
        self.c = c
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv(2 * c, c2)

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        return self.cv2(torch.cat([a, super().forward(b)], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling: k x k stride-1 max pools of one 1x1 branch,
    each k on the same input (padding with -inf), concat, merge."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(c_ * (len(k) + 1), c2)
        self.k = tuple(k)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [F.max_pool2d(y, k, 1, k // 2) for k in self.k], 1))


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (with its bias) that casts its weight and bias to
    the input's dtype at use: yolov6's upsampling row. Its weight is laid out
    (in, out, kh, kw) and flipped in space against the JAX package's
    kernel (utils/jax_import.py)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class C2(nn.Module):
    """CSP bottleneck with 2 convs: split, n bottlenecks on one half, concat
    with the other, merge (yolov8-p6's head)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c)
        self.cv2 = Conv(2 * self.c, c2)
        self.m = nn.Sequential(*(Bottleneck(self.c, self.c, shortcut, e=1.0) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, 1)
        return self.cv2(torch.cat([self.m(a), b], 1))


class GhostConv(nn.Module):
    """Ghost conv: a primary Conv to half the channels, a 5x5 depth-wise
    Conv of it, concatenated (both with SiLU, as the JAX package has it)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: GhostConv to c2 / 2, a depth-wise k x k Conv
    without activation at s=2, GhostConv to c2 (`conv.0` to `conv.2`), plus
    the shortcut: the input at s=1 where c1 == c2, else a 1x1 Conv without
    activation (`shortcut.1`) after, at s=2, a depth-wise one (`shortcut.0`).
    The second GhostConv applies SiLU, as the JAX package's does."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(GhostConv(c1, c_, 1, 1),
                                  DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
                                  GhostConv(c_, c2, 1, 1))
        if s == 2 or c1 != c2:
            self.shortcut = nn.Sequential(DWConv(c1, c1, k, s, act=False) if s == 2 else nn.Identity(),
                                          Conv(c1, c2, 1, 1, act=False))
        else:
            self.shortcut = nn.Identity()

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)


class C3Ghost(C3):
    """C3 whose n bottlenecks are GhostBottlenecks (their residual is their own)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True):
        super().__init__(c1, c2, n, shortcut)
        c_ = c2 // 2
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


class RepConv(nn.Module):
    """The train-time RepVGG conv of YOLOv9: a k x k Conv (`conv1`) and a
    1x1 Conv (`conv2`), both without activation, whose fp32 BatchNorm
    outputs are summed, cast to the compute dtype, then SiLU. As the JAX
    package's fuse_variables, DetectionModel.fuse leaves both branches
    unfolded (`folds` False)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, act=True):
        super().__init__()
        self.conv1 = Conv(c1, c2, k, s, g=g, act=False)
        self.conv2 = Conv(c1, c2, 1, s, g=g, act=False)
        self.conv1.folds = self.conv2.folds = False
        self.act = act

    def forward(self, x):
        y = self.conv1.norm(self.conv1.conv(x)) + self.conv2.norm(self.conv2.conv(x))
        return activate(y.to(x.dtype), self.act)


class RepC3(nn.Module):
    """RT-DETR's CSP block: n RepConvs on one 1x1 branch (`cv1`, `m`), added
    to a second 1x1 branch (`cv2`), then a 1x1 Conv (`cv3`) where the hidden
    width c2 * e is not c2."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(RepConv(c_, c_, 3) for _ in range(n)))
        self.cv3 = Conv(c_, c2, 1, 1) if c_ != c2 else nn.Identity()

    def forward(self, x):
        return self.cv3(self.m(self.cv1(x)) + self.cv2(x))


class LightConv(nn.Module):
    """PP-HGNetV2's light conv: a 1x1 Conv without activation (`conv1`),
    then a depth-wise k x k Conv (`conv2`, ReLU unless act says otherwise)."""

    def __init__(self, c1: int, c2: int, k: int = 1, act="relu"):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act=act)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class HGStem(nn.Module):
    """PP-HGNetV2's stem, stride 4, every Conv with ReLU: a 3x3 stride-2
    Conv, then two branches of the map padded by one at the right and the
    bottom (a 2x2 stride-1 max pool, and two 2x2 unpadded Convs, the second
    on its input padded the same way), concatenated, a 3x3 stride-2 Conv and
    a 1x1 Conv to c2."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = Conv(c1, cm, 3, 2, act="relu")
        self.stem2a = Conv(cm, cm // 2, 2, 1, act="relu", p=0)
        self.stem2b = Conv(cm // 2, cm, 2, 1, act="relu", p=0)
        self.stem3 = Conv(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = Conv(cm, c2, 1, 1, act="relu")

    @staticmethod
    def _pad(x):
        return F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)

    def forward(self, x):
        x = self._pad(self.stem1(x))
        x2 = self.stem2b(self._pad(self.stem2a(x)))
        x1 = F.max_pool2d(x, 2, 1)  # the padded map, no further pad: the reference's ceil-mode pool
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class HGBlock(nn.Module):
    """PP-HGNetV2's block: n Convs (or LightConvs) of width cm and kernel k in
    a chain (`m`), the input and every output concatenated, a 1x1 squeeze
    Conv to c2 / 2 (`sc`) and a 1x1 excite Conv to c2 (`ec`), all with act
    (ReLU); plus the input where shortcut and c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6, lightconv: bool = False,
                 shortcut: bool = False, act="relu"):
        super().__init__()
        block = LightConv if lightconv else Conv
        self.m = nn.ModuleList(block(c1 if i == 0 else cm, cm, k=k, act=act) for i in range(n))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, 1, act=act)
        self.ec = Conv(c2 // 2, c2, 1, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        ys = [x]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, 1)))
        return y + x if self.add else y


class RepBottleneck(Bottleneck):
    """Bottleneck whose first conv is a RepConv."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, k=(3, 3), e: float = 0.5):
        super().__init__(c1, c2, shortcut, k, e)
        self.cv1 = RepConv(c1, int(c2 * e), k[0], 1)


class RepCSP(C3):
    """C3 whose n bottlenecks are RepBottlenecks: the RepNCSP of YOLOv9."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True):
        super().__init__(c1, c2, n, shortcut)
        c_ = c2 // 2
        self.m = nn.Sequential(*(RepBottleneck(c_, c_, shortcut, e=1.0) for _ in range(n)))


class RepNCSPELAN4(nn.Module):
    """CSP-ELAN of YOLOv9: a 1x1 Conv to c3 split in two halves, then two
    chained branches (RepCSP of n bottlenecks, 3x3 Conv; `cv2.0`, `cv2.1`
    and `cv3.0`, `cv3.1`) on the second half, all four concatenated and merged."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.cv1 = Conv(c1, c3)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n), Conv(c4, c4, 3))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), Conv(c4, c4, 3))
        self.cv4 = Conv(c3 + 2 * c4, c2)

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.extend(m(y[-1]) for m in (self.cv2, self.cv3))
        return self.cv4(torch.cat(y, 1))


class ELAN1(nn.Module):
    """The light ELAN of yolov9t: RepNCSPELAN4 with a 3x3 Conv for each branch."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int):
        super().__init__()
        self.cv1 = Conv(c1, c3)
        self.cv2 = Conv(c3 // 2, c4, 3)
        self.cv3 = Conv(c4, c4, 3)
        self.cv4 = Conv(c3 + 2 * c4, c2)

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.extend(m(y[-1]) for m in (self.cv2, self.cv3))
        return self.cv4(torch.cat(y, 1))


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-1 mean with "SAME" padding, as the JAX package's
    reduce_window: zeros past the bottom and right edges, every window / 4,
    so the map keeps its size (the reference's avg_pool2d(x, 2, 1, 0) loses
    a row and a column): two shifted sums of the padded map."""
    xp = F.pad(x, (0, 1, 0, 1))
    y = xp[..., :-1] + xp[..., 1:]
    return (y[..., :-1, :] + y[..., 1:, :]) * 0.25


class ADown(nn.Module):
    """YOLOv9's downsample: the SAME-padded 2x2 mean, split in two halves; a
    3x3 stride-2 Conv of one, a 3x3 stride-2 max pool then 1x1 Conv of the other."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        c = c2 // 2
        self.cv1 = Conv(c1 // 2, c, 3, 2)
        self.cv2 = Conv(c1 // 2, c, 1, 1)

    def forward(self, x):
        x1, x2 = avg_pool_same(x).chunk(2, 1)
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], 1)


class AConv(nn.Module):
    """YOLOv9's light downsample: the SAME-padded 2x2 mean, then a 3x3 stride-2 Conv."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 2)

    def forward(self, x):
        return self.cv1(avg_pool_same(x))


class SPPELAN(nn.Module):
    """SPP-ELAN of YOLOv9: a 1x1 Conv to c3, three chained k x k max pools, concat, merge (`cv5`)."""

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__()
        self.cv1 = Conv(c1, c3)
        self.cv5 = Conv(4 * c3, c2)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv5(torch.cat(ys, 1))


class CBLinear(nn.Module):
    """A k x k conv with a bias whose output splits into the channel groups c2s (a tuple)."""

    def __init__(self, c1: int, c2s: Sequence[int], k: int = 1, s: int = 1):
        super().__init__()
        self.c2s = tuple(c2s)
        self.conv = Conv2d(c1, sum(self.c2s), k, s, autopad(k), bias=True)

    def forward(self, x):
        return self.conv(x).split(self.c2s, 1)


class CBFuse(nn.Module):
    """The sum of the last input and, of each input before it, the group
    idx[i] of a CBLinear's tuple resized to the last input's size as
    jax.image.resize(method="nearest") resizes (half-pixel centres:
    "nearest-exact"; the same as "nearest" where the size grows by an
    integer factor)."""

    def __init__(self, idx: Sequence[int]):
        super().__init__()
        self.idx = tuple(idx)

    def forward(self, xs):
        out = xs[-1]
        for i, x in enumerate(xs[:-1]):
            sel = x[self.idx[i]]
            if sel.shape[2:] != out.shape[2:]:
                sel = F.interpolate(sel, size=out.shape[2:], mode="nearest-exact")
            out = out + sel
        return out


class SCDown(nn.Module):
    """YOLOv10's separable downsample: a 1x1 Conv to c2, then a depth-wise
    k x k stride-s Conv without activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """Depth-wise 7x7 and 3x3 Convs (each with its BatchNorm, no activation)
    summed, then SiLU. fuse() folds each branch's BatchNorm and keeps the two
    branches, as the JAX package's fuse_variables does. Its row takes
    c1 == c2."""

    def __init__(self, c1: int, c2: Optional[int] = None):
        super().__init__()
        if c2 is not None and c2 != c1:
            raise ValueError(f"RepVGGDW keeps its channels: c1={c1}, c2={c2}")
        self.conv = Conv(c1, c1, 7, 1, g=c1, act=False, p=3)
        self.conv1 = Conv(c1, c1, 3, 1, g=c1, act=False, p=1)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """YOLOv10's compact inverted block: depth-wise 3x3, 1x1 to 2 c2 e,
    depth-wise 3x3 (RepVGGDW with lk), 1x1 to c2, depth-wise 3x3 (`cv1.0`
    to `cv1.4`), with a residual where shortcut and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(Conv(c1, c1, 3, g=c1), Conv(c1, 2 * c_, 1),
                                 RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_),
                                 Conv(2 * c_, c2, 1), Conv(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """A C2f whose n blocks are CIB(c, c, shortcut, e=1.0, lk)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False):
        super().__init__(c1, c2, n, shortcut)
        c = c2 // 2
        self.m = nn.ModuleList(CIB(c, c, shortcut, e=1.0, lk=lk) for _ in range(n))


class AAttn(nn.Module):
    """Area attention of YOLO12: a 1x1 qkv Conv whose channels are per head
    [q | k | v] (head dim hd = dim / heads); the flattened rows split into
    `area` stripes of H*W / area tokens each attended on its own,
    softmax(q k^T / sqrt(hd)) v with the scores and softmax in fp32
    (scaled_dot_product_attention), plus a 7x7 depth-wise Conv of v; then
    a 1x1 projection. No TPU kernel stands behind it: the JAX package leaves
    it to XLA."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.area = area if area > 1 else 1
        self.qkv = Conv(dim, 3 * dim, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        nh, hd = self.num_heads, c // self.num_heads
        n = h * w
        if n % self.area:
            raise ValueError(f"area attention: {h}x{w} = {n} tokens do not split into {self.area} areas")
        qkv = self.qkv(x).flatten(2).transpose(1, 2).reshape(b * self.area, n // self.area, nh, 3 * hd)
        q, k, v = qkv.transpose(1, 2).split(hd, -1)  # (B * area, heads, tokens, hd) each
        o = F.scaled_dot_product_attention(q, k, v)

        def image(t):  # (B * area, heads, tokens, hd) -> (B, C, H, W), channels_last
            return t.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)

        return self.proj(image(o) + self.pe(image(v)))


class ABlock(nn.Module):
    """Area attention and a 1x1 MLP (hidden dim * mlp_ratio, SiLU; then dim,
    no activation; `mlp.0`, `mlp.1`), each with a residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, hidden, 1), Conv(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """YOLO12's area-attention C2f: a 1x1 Conv to c_ = c2 * e, n stages, each
    two ABlocks (heads of 32 channels; `m.i.0`, `m.i.1`) with a2, else a C3k
    (`m.i`), all concatenated and merged. With a2 and residual, the output is
    x + gamma * merged, gamma learnable (0.01 at init), computed in fp32
    (the JAX package's fp32 gamma promotes it) and cast to the compute dtype."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True, area: int = 1, residual: bool = False,
                 mlp_ratio: float = 2.0, e: float = 0.5, shortcut: bool = True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv((1 + n) * c_, c2)
        self.gamma = nn.Parameter(torch.full((c2,), 0.01)) if a2 and residual else None
        nh = max(1, c_ // 32)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, nh, mlp_ratio, area) for _ in range(2))) if a2 else C3k(c_, c_, 2, shortcut)
            for _ in range(n))

    def forward(self, x):
        ys = [self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.cv2(torch.cat(ys, 1))
        if self.gamma is None:
            return y
        return (x.float() + self.gamma.view(1, -1, 1, 1) * y.float()).to(x.dtype)


class ResNetBlock(nn.Module):
    """The bottleneck ResNet block: 1x1 (SiLU), 3x3 stride s (SiLU), 1x1 to
    e * c2 (no activation), plus the input or its projection (`shortcut.0`,
    a 1x1 stride-s Conv without activation, where the stride or the width
    changes), through a ReLU."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4):
        super().__init__()
        c3 = e * c2
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, 3, s, p=1)
        self.cv3 = Conv(c2, c3, 1, act=False)
        self.shortcut = nn.Sequential(Conv(c1, c3, 1, s, act=False)) if s != 1 or c1 != c3 else nn.Identity()

    def forward(self, x):
        return F.relu(self.cv3(self.cv2(self.cv1(x))) + self.shortcut(x))


class ResNetLayer(nn.Module):
    """n ResNetBlocks (the first with stride s) in `layer`, or, with
    is_first, the stem: a 7x7 stride-2 Conv (SiLU) and a 3x3 stride-2 max
    pool padded with -inf, as the JAX package pads it."""

    def __init__(self, c1: int, c2: int, s: int = 1, is_first: bool = False, n: int = 1, e: int = 4):
        super().__init__()
        if is_first:
            self.layer = nn.Sequential(Conv(c1, c2, 7, 2, p=3), nn.MaxPool2d(3, 2, 1))
        else:
            self.layer = nn.Sequential(*(ResNetBlock(c1 if i == 0 else e * c2, c2, s if i == 0 else 1, e)
                                         for i in range(n)))

    def forward(self, x):
        return self.layer(x)


class BasicBlock(nn.Module):
    """The two-conv ResNet block of resnet18 and resnet34: 3x3 stride s
    (ReLU), 3x3 (no activation), plus the input or its 1x1 stride-s
    projection (`shortcut.0`), through a ReLU."""

    def __init__(self, c1: int, c2: int, s: int = 1):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, s, act="relu", p=1)
        self.cv2 = Conv(c2, c2, 3, 1, act=False, p=1)
        self.shortcut = nn.Sequential(Conv(c1, c2, 1, s, act=False)) if s != 1 or c1 != c2 else nn.Identity()

    def forward(self, x):
        return F.relu(self.cv2(self.cv1(x)) + self.shortcut(x))


class TorchVision(nn.Module):
    """A torchvision ResNet's feature trunk, built natively as the JAX
    package builds it (no torchvision, no downloaded weights): the stem
    (a ResNetLayer with is_first) and four stages `layer1` to `layer4` of
    widths 64 to 512 (stride 1, then 2), BasicBlocks for resnet18 and
    resnet34 (nn.Sequential), a ResNetLayer of bottlenecks for resnet50; its
    output is (B, c2, H / 32, W / 32), c2 512 (2048 for resnet50). The
    reference's module names are torchvision's (`m.0`, `m.4.0.conv1`), which
    a fused Conv and BatchNorm cannot take: these are the JAX package's
    scopes. Only the trunk form (unwrap, truncate 2: avgpool and fc dropped)
    of these three names is built; `weights` is accepted for the YAML's
    sake."""

    STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3), "resnet50": (3, 4, 6, 3)}

    def __init__(self, c1: int, model: str = "resnet18", weights: str = "DEFAULT", unwrap: bool = True,
                 truncate: int = 2, split: bool = False):
        super().__init__()
        name = str(model)
        if name not in self.STAGES:
            raise NotImplementedError(f"TorchVision backbone '{name}' not supported natively "
                                      f"(available: {sorted(self.STAGES)})")
        if split:
            raise NotImplementedError("TorchVision split=True is not supported")
        if not (unwrap and truncate == 2):
            raise NotImplementedError("only the feature-trunk form (unwrap=True, truncate=2 — drop avgpool+fc) is "
                                      "supported; classification uses the Classify head")
        self.stem = ResNetLayer(c1, 64, is_first=True)
        c = 64
        for si, (w, nblk) in enumerate(zip((64, 128, 256, 512), self.STAGES[name])):
            s = 1 if si == 0 else 2
            if name == "resnet50":
                setattr(self, f"layer{si + 1}", ResNetLayer(c, w, s, n=nblk, e=4))
                c = 4 * w
            else:
                setattr(self, f"layer{si + 1}", nn.Sequential(*(BasicBlock(c if i == 0 else w, w, s if i == 0 else 1)
                                                                for i in range(nblk))))
                c = w
        self.c2 = c

    def forward(self, x):
        x = self.stem(x)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


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
    """Anchor-free YOLOv8 / YOLO11 detect head. The cls branch is two 3x3
    Convs (legacy, YOLOv8), or with legacy=False (YOLO11) a depth-wise 3x3
    then a 1x1 Conv, twice.

    Returns ((B, 4 + nc, A) decoded xywh boxes in input pixels followed by
    class sigmoids, the per-level raw maps (B, 4*reg_max + nc, H, W)); in
    training only the raw maps. The decode runs in fp32; the DFL is a
    function, not a module."""

    reg_max = 16  # DFL bins per box side

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int] = (8, 16, 32), legacy: bool = True):
        super().__init__()
        self.nc = nc
        self.strides = tuple(strides)
        reg_max = self.reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1)) for x in ch
        )
        if legacy:
            self.cv3 = nn.ModuleList(nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), Conv2d(c3, nc, 1)) for x in ch)
        else:
            self.cv3 = nn.ModuleList(
                nn.Sequential(nn.Sequential(self._dw(x), Conv(x, c3, 1)),
                              nn.Sequential(self._dw(c3), Conv(c3, c3, 1)), Conv2d(c3, nc, 1)) for x in ch
            )

    @staticmethod
    def _dw(c: int) -> Conv:
        """The depth-wise 3x3 of the light cls branch."""
        return DWConv(c, c, 3)

    def branches(self):
        """The (box, cls) branch pairs whose last convs take the bias priors."""
        return [(self.cv2, self.cv3)]

    def bias_init(self):
        """Box logits start at 1, class logits at the prior of 5 objects per 640 px image."""
        with torch.no_grad():
            for cv2, cv3 in self.branches():
                for a, b, s in zip(cv2, cv3, self.strides):
                    a[-1].bias.fill_(1.0)
                    b[-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    @staticmethod
    def maps(xs: List[torch.Tensor], cv2, cv3) -> List[torch.Tensor]:
        """The per-level raw maps of one (box, cls) branch pair."""
        return [torch.cat([a(x), b(x)], 1) for x, a, b in zip(xs, cv2, cv3)]

    def decode(self, feats: List[torch.Tensor], xywh: bool = True, angle: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """(B, 4 + nc, A) in fp32: the boxes in input pixels (xywh, or xyxy)
        followed by the class sigmoids. With an OBB head's angles (B, A, 1)
        in fp32 the boxes are rotated: dist2rbox's centre and size, times
        the strides, as the JAX package's Detect decodes them."""
        bsz, no = feats[0].shape[:2]  # 4 * reg_max + the class count (a WorldDetect's: its prompts')
        x_cat = torch.cat([f.reshape(bsz, no, -1) for f in feats], 2).float()  # (B, no, A)
        box, cls = x_cat.split((4 * self.reg_max, no - 4 * self.reg_max), 1)
        anchors, strides = make_anchors([f.shape[2:] for f in feats], self.strides, device=x_cat.device)
        dist = dfl_decode(box, self.reg_max)
        if angle is not None:
            dbox = (dist2rbox(dist.transpose(1, 2), angle, anchors[None]) * strides[None]).transpose(1, 2)
        else:
            dbox = dist2bbox(dist, anchors.t()[None], xywh) * strides.t()[None]
        return torch.cat([dbox, cls.sigmoid()], 1)

    def forward(self, xs: List[torch.Tensor]):
        feats = self.maps(xs, self.cv2, self.cv3)
        if self.training:
            return feats
        return self.decode(feats), feats


class Proto(nn.Module):
    """Mask prototypes at twice the input's resolution: a 3x3 Conv, a 2x2
    stride-2 transposed conv with its bias (`upsample`), a 3x3 Conv, then a
    1x1 Conv to c2 prototypes (the JAX package's nn/heads.py Proto)."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class Segment(Detect):
    """Detect with nm mask coefficients per anchor and nm prototypes (the
    JAX package's nn/heads.py Segment): `proto` runs on the first level,
    and `cv4.i` (two 3x3 Convs of c4 = max(ch[0] // 4, nm) channels, then a
    1x1 conv to nm) gives each level's coefficients.

    Training returns (raw maps, coefficients (B, A, nm), prototypes
    (B, nm, 2 H0, 2 W0)); eval returns ((B, 4 + nc + nm, A) in fp32: the
    Detect layout followed by the coefficients, (raw maps, coefficients,
    prototypes))."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int] = (8, 16, 32), legacy: bool = True,
                 nm: int = 32, npr: int = 256):
        super().__init__(nc, ch, strides, legacy)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), Conv2d(c4, nm, 1)) for x in ch)

    def forward(self, xs: List[torch.Tensor]):
        proto = self.proto(xs[0])
        mc = torch.cat([m(x).flatten(2) for x, m in zip(xs, self.cv4)], 2)  # (B, nm, A)
        feats = self.maps(xs, self.cv2, self.cv3)
        if self.training:
            return feats, mc.transpose(1, 2), proto
        return torch.cat([self.decode(feats), mc.float()], 1), (feats, mc.transpose(1, 2), proto)


class Pose(Detect):
    """Detect with nk keypoints of nd values (x, y and, where nd is 3, a
    visibility logit) per anchor (the JAX package's nn/heads.py Pose):
    `cv4.i` (two 3x3 Convs of c4 = max(ch[0] // 4, nk * nd) channels, then
    a 1x1 conv with its bias to nk * nd) gives each level's raw keypoints,
    channel j * nd + d for keypoint j.

    Training returns (raw maps, raw keypoints (B, A, nk * nd)); eval returns
    ((B, 4 + nc + nk * nd, A) in fp32: the Detect layout followed by the
    decoded keypoints, (raw maps, raw keypoints))."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int] = (8, 16, 32), legacy: bool = True,
                 kpt_shape: Sequence[int] = (17, 3)):
        super().__init__(nc, ch, strides, legacy)
        self.kpt_shape = (int(kpt_shape[0]), int(kpt_shape[1]))
        nkd = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, nkd)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), Conv2d(c4, nkd, 1)) for x in ch)

    def decode_kpts(self, kpt: torch.Tensor, feats: List[torch.Tensor]) -> torch.Tensor:
        """(B, nk * nd, A) raw keypoints -> the same layout in fp32: x and y
        in input pixels, (k * 2 + anchor - 0.5) * stride, and the visibility's
        sigmoid where nd is 3."""
        nk, nd = self.kpt_shape
        b = kpt.shape[0]
        anchors, strides = make_anchors([f.shape[2:] for f in feats], self.strides, device=kpt.device)
        k = kpt.float().reshape(b, nk, nd, -1)
        xy = (k[:, :, :2] * 2.0 + (anchors.t()[None, None] - 0.5)) * strides.t()[None, None]
        out = torch.cat([xy, k[:, :, 2:].sigmoid()], 2) if nd == 3 else xy
        return out.reshape(b, nk * nd, -1)

    def forward(self, xs: List[torch.Tensor]):
        kpt = torch.cat([m(x).flatten(2) for x, m in zip(xs, self.cv4)], 2)  # (B, nk * nd, A)
        feats = self.maps(xs, self.cv2, self.cv3)
        if self.training:
            return feats, kpt.transpose(1, 2)
        return torch.cat([self.decode(feats), self.decode_kpts(kpt, feats)], 1), (feats, kpt.transpose(1, 2))


class OBB(Detect):
    """Detect with ne rotation angles per anchor (the JAX package's
    nn/heads.py OBB): `cv4.i` (two 3x3 Convs of c4 = max(ch[0] // 4, ne)
    channels, then a 1x1 conv with its bias to ne) gives each level's angle
    logits, and the angle is (sigmoid - 0.25) * pi in fp32, in [-pi/4,
    3 pi/4). In eval the angle rotates the Detect decode (dist2rbox).

    Training returns (raw maps, angles (B, A, ne)); eval returns ((B, 4 +
    nc + ne, A) in fp32: the rotated boxes' centre and size in input
    pixels, the class sigmoids and the angles, (raw maps, angles))."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int] = (8, 16, 32), legacy: bool = True,
                 ne: int = 1):
        super().__init__(nc, ch, strides, legacy)
        self.ne = int(ne)
        c4 = max(ch[0] // 4, self.ne)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), Conv2d(c4, self.ne, 1)) for x in ch)

    def forward(self, xs: List[torch.Tensor]):
        logit = torch.cat([m(x).flatten(2) for x, m in zip(xs, self.cv4)], 2)  # (B, ne, A)
        angle = ((logit.float().sigmoid() - 0.25) * math.pi).transpose(1, 2)  # (B, A, ne)
        feats = self.maps(xs, self.cv2, self.cv3)
        if self.training:
            return feats, angle
        return torch.cat([self.decode(feats, angle=angle), angle.transpose(1, 2)], 1), (feats, angle)


class v10Detect(Detect):
    """YOLOv10's NMS-free head: YOLO11's Detect (its light cls branch with
    plain depth-wise Convs, as the JAX package names them) and a one-to-one
    twin of both branches (`one2one_cv2`, `one2one_cv3`) that runs on the
    detached inputs, so its loss reaches no layer before the head.

    Training returns {"one2many": maps, "one2one": maps}. Eval decodes the
    one-to-one maps to xyxy boxes and keeps the top max_det (anchor, class)
    pairs by score (ops/nms.py e2e_postprocess): ((B, max_det, 6) rows of
    x1, y1, x2, y2, score, class, both map dicts). No NMS follows."""

    max_det = 300

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int] = (8, 16, 32)):
        super().__init__(nc, ch, strides, legacy=False)
        self.one2one_cv2 = copy.deepcopy(self.cv2)
        self.one2one_cv3 = copy.deepcopy(self.cv3)

    @staticmethod
    def _dw(c: int) -> Conv:
        return Conv(c, c, 3, g=c)

    def branches(self):
        return [(self.cv2, self.cv3), (self.one2one_cv2, self.one2one_cv3)]

    def forward(self, xs: List[torch.Tensor]):
        maps = {"one2many": self.maps(xs, self.cv2, self.cv3),
                "one2one": self.maps([x.detach() for x in xs], self.one2one_cv2, self.one2one_cv3)}
        if self.training:
            return maps
        return e2e_postprocess(self.decode(maps["one2one"], xywh=False), self.max_det, self.nc), maps


class Linear(nn.Linear):
    """nn.Linear that casts its weight and bias to the input's dtype at use."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Dropout(nn.Module):
    """flax's nn.Dropout: in training each element is kept where a uniform
    draw is below 1 - p and scaled by 1 / (1 - p), else zeroed; the identity
    in eval and at p 0. The draws come from `generator` (the trainer sets a
    seeded torch.Generator on the model's device; None: the global one)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


class Classify(nn.Module):
    """The image classification head: a 1x1 Conv to c_ (1280), the mean
    over H and W, Dropout (`drop`, rate 0 unless the trainer sets the
    `dropout` setting), then `linear` to nc. A list input is concatenated
    on the channels first. Training returns the logits (B, nc) in the
    compute dtype; eval the softmax (B, nc) in fp32, as the JAX package's
    head returns it (the reference's eval returns (softmax, logits))."""

    def __init__(self, c1: int, nc: int = 1000, c_: int = 1280, dropout: float = 0.0):
        super().__init__()
        self.nc = nc
        self.conv = Conv(c1, c_, 1, 1)
        self.drop = Dropout(dropout)
        self.linear = Linear(c_, nc)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(list(x), 1)
        y = self.linear(self.drop(self.conv(x).mean((2, 3))))
        return y if self.training else y.float().softmax(-1)
