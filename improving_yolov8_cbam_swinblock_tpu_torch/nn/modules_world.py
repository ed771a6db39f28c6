"""The YOLO-World blocks as torch modules (the JAX package's nn/modules_world.py).

Text features, (B, K, 512) fp32 for K prompts, thread through the graph
beside the image (nn/tasks.py DetectionModel.forward): `C2fAttn` is
guided by the current text, `ImagePoolingAttn` refines the text from the
image's pooled patches, and `WorldDetect` scores each anchor's embedding
against the original text, so its class count is the number of prompts.
Parameter names follow the reference's torch state (`attn.gl`, `attn.ec`,
`attn.proj_conv`, `attn.bias`, `query.0` and `query.1`, `projections.0`,
`proj`, `cv4.0.bias`, `cv4.0.logit_scale`, `cv4.0.norm`).

The JAX package's behaviours are kept for parity: MaxSigmoidAttnBlock
splits its embedding into heads of ec // nh but divides the scores by
sqrt(c2 // nh); ImagePoolingAttn's LayerNorms have flax's eps of 1e-6;
BNContrastiveHead's BatchNorm has flax's eps 1e-3 and momentum 0.97 (torch
0.03) with flax's biased variance in training; WorldDetect sizes its
class branch by the YAML's nc, not the prompt count. Products of the
text run in fp32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .modules import BN_EPS, BN_MOMENTUM, Bottleneck, Conv, Conv2d, Detect, Linear, batch_norm_eval, batch_norm_train

LN_EPS = 1e-6  # flax's LayerNorm epsilon


class MaxSigmoidAttnBlock(nn.Module):
    """Max-sigmoid attention over the text guides: per head, the largest dot
    of the pixel's embedding (`ec`, a 1x1 Conv where c1 != ec) with the
    projected guides (`gl`), over sqrt(c2 // nh), plus a per-head `bias`,
    sigmoid, (times `scale` if asked) gates the heads of `proj_conv`'s 3x3
    output."""

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512, scale: bool = False):
        super().__init__()
        self.nh, self.hc, self.hc_e = nh, c2 // nh, ec // nh
        self.ec = Conv(c1, ec, 1, act=False) if c1 != ec else None
        self.gl = Linear(gc, ec)
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj_conv = Conv(c1, c2, 3, act=False)
        self.scale = nn.Parameter(torch.ones(1, nh, 1, 1)) if scale else None

    def forward(self, x, guide):
        b, _, h, w = x.shape
        g = self.gl(guide.to(x.dtype)).reshape(b, -1, self.nh, self.hc_e).float()  # (B, K, nh, hc_e)
        embed = (x if self.ec is None else self.ec(x)).reshape(b, self.nh, self.hc_e, h * w).float()
        aw = torch.matmul(embed.transpose(2, 3), g.permute(0, 2, 3, 1)).amax(-1)  # (B, nh, HW): the best guide
        aw = (aw.view(b, self.nh, h, w) / math.sqrt(self.hc) + self.bias.view(1, -1, 1, 1)).sigmoid()
        if self.scale is not None:
            aw = aw * self.scale
        y = self.proj_conv(x)
        return (y.reshape(b, self.nh, self.hc, h, w) * aw[:, :, None].to(y.dtype)).reshape(b, -1, h, w)


class C2fAttn(nn.Module):
    """C2f with a text-guided branch: split, n bottlenecks, then
    MaxSigmoidAttnBlock on the last; the (3 + n) chunks merge in a 1x1."""

    def __init__(self, c1: int, c2: int, n: int = 1, ec: int = 128, nh: int = 1, gc: int = 512,
                 shortcut: bool = False, e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv((3 + n) * c, c2)
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut, k=(3, 3), e=1.0) for _ in range(n))
        self.attn = MaxSigmoidAttnBlock(c, c, nh=nh, ec=ec, gc=gc)

    def forward(self, x, guide):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        ys.append(self.attn(ys[-1], guide))
        return self.cv2(torch.cat(ys, 1))


def _adaptive_max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, C, k, k): the max over each window [floor(i H / k), ceil((i + 1) H
    / k)) by [floor(j W / k), ceil((j + 1) W / k)): nn.AdaptiveMaxPool2d's
    windows, which the JAX package's _adaptive_max_pool slices."""
    return F.adaptive_max_pool2d(x, k)


class ImagePoolingAttn(nn.Module):
    """Text refined by the image: each level's 1x1 projection (`projections.i`,
    biased) max-pooled to k x k patches; the text queries (`query`: LayerNorm
    then Linear) attend over the patches (`key`, `value`) in nh heads, and
    `proj` back to the text width is added to the text (times `scale`, 1
    unless asked)."""

    def __init__(self, ec: int = 256, ch: Sequence[int] = (), ct: int = 512, nh: int = 8, k: int = 3,
                 scale: bool = False):
        super().__init__()
        self.query = nn.Sequential(nn.LayerNorm(ct, eps=LN_EPS), Linear(ct, ec))
        self.key = nn.Sequential(nn.LayerNorm(ec, eps=LN_EPS), Linear(ec, ec))
        self.value = nn.Sequential(nn.LayerNorm(ec, eps=LN_EPS), Linear(ec, ec))
        self.proj = Linear(ec, ct)
        self.scale = nn.Parameter(torch.zeros(1)) if scale else None
        self.projections = nn.ModuleList(Conv2d(c, ec, 1) for c in ch)
        self.ec, self.nh, self.k = ec, nh, k

    @staticmethod
    def _ln_linear(seq: nn.Sequential, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The LayerNorm in fp32, then the Linear in the compute dtype."""
        return seq[1](seq[0](t.float()).to(dtype))

    def forward(self, xs: List[torch.Tensor], text: torch.Tensor) -> torch.Tensor:
        bs, dt = xs[0].shape[0], xs[0].dtype
        hc = self.ec // self.nh
        px = torch.cat([_adaptive_max_pool(p(x), self.k).flatten(2) for p, x in zip(self.projections, xs)], 2)
        px = px.transpose(1, 2)  # (B, levels * k * k, ec)
        q = self._ln_linear(self.query, text, dt).reshape(bs, -1, self.nh, hc).float()
        k = self._ln_linear(self.key, px, dt).reshape(bs, -1, self.nh, hc).float()
        v = self._ln_linear(self.value, px, dt).reshape(bs, -1, self.nh, hc).float()
        aw = (torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hc)).softmax(-1)  # (B, nh, n, k)
        out = torch.matmul(aw, v.transpose(1, 2)).transpose(1, 2).reshape(bs, -1, self.ec)
        out = self.proj(out.to(dt))
        return (out if self.scale is None else out * self.scale) + text


class ContrastiveHead(nn.Module):
    """Region-text cosine similarity: x (B, C, H, W) and w (B, K, C), each
    L2-normalised in fp32 -> (B, K, H, W) logits times exp(`logit_scale`,
    log(1 / 0.07) at init) plus `bias` (-10 at init)."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(torch.ones([]) * math.log(1 / 0.07))

    def forward(self, x, w):
        x = F.normalize(x.float(), dim=1, eps=1e-12)
        w = F.normalize(w.float(), dim=-1, eps=1e-12)
        return torch.einsum("bchw,bkc->bkhw", x, w) * self.logit_scale.exp() + self.bias


class BNContrastiveHead(nn.Module):
    """ContrastiveHead with the region embedding BatchNorm-ed (`norm`, fp32)
    in place of normalised; `logit_scale` -1 at init."""

    def __init__(self, embed: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(embed, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(-1.0 * torch.ones([]))

    def forward(self, x, w):
        x = batch_norm_train(self.norm, x.float()) if self.training else batch_norm_eval(self.norm, x)
        w = F.normalize(w.float(), dim=-1, eps=1e-12)
        return torch.einsum("bchw,bkc->bkhw", x, w) * self.logit_scale.exp() + self.bias


class WorldDetect(Detect):
    """The open-vocabulary Detect head: Detect's box branch (`cv2`), an
    embedding branch (`cv3`: two 3x3 Convs of c3 = max(ch[0], min(nc, 100))
    for the YAML's nc, then a biased 1x1 to `embed`) scored against the text
    by a contrastive head per level (`cv4`, BNContrastiveHead with
    `with_bn`). Its maps are Detect's at nc = the number of prompts, so the
    loss, NMS and the validator take it as a Detect head. Training returns
    the raw maps; eval (Detect's decode, the raw maps)."""

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int] = (8, 16, 32), embed: int = 512,
                 with_bn: bool = False):
        nn.Module.__init__(self)
        self.nc = nc
        self.strides = tuple(strides)
        c2 = max(16, ch[0] // 4, self.reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * self.reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), Conv2d(c3, embed, 1)) for x in ch)
        self.cv4 = nn.ModuleList(BNContrastiveHead(embed) if with_bn else ContrastiveHead() for _ in ch)

    def bias_init(self):
        """The JAX package's init: box logits 1, the embedding convs' biases 0 (the class bias is cv4's -10)."""
        with torch.no_grad():
            for a, b in zip(self.cv2, self.cv3):
                a[-1].bias.fill_(1.0)
                b[-1].bias.zero_()

    def forward(self, xs: List[torch.Tensor], text: torch.Tensor):
        feats = []
        for x, a, b, head in zip(xs, self.cv2, self.cv3, self.cv4):
            box = a(x)
            feats.append(torch.cat([box, head(b(x), text).to(box.dtype)], 1))
        if self.training:
            return feats
        return self.decode(feats), feats
