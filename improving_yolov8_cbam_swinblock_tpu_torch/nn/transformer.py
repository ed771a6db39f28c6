"""RT-DETR's transformer modules as torch modules: AIFI, the deformable decoder and RTDETRDecoder.

Same math as the JAX package's nn/transformer.py, with the reference's torch
names (`ma.in_proj_weight`, `fc1`, `input_proj.0`, `decoder.layers.0.cross_attn.sampling_offsets`,
`enc_output.0`, `dec_bbox_head.0.layers.2`, `denoising_class_embed.weight`),
so weights carry across the bridge (utils/jax_import.py) by name:

  * `MHA` is the JAX package's attention with distinct q, k and v inputs:
    a packed (3C, C) in-projection, fp32 scores of the compute-dtype q and
    k, a boolean mask where True blocks (the blocked scores set to -1e9, not
    -inf), the fp32 softmax cast back for the product with v;
  * LayerNorms run in fp32 with flax's epsilon 1e-6 and cast back to the
    compute dtype; GELU is the exact one;
  * `AIFI` is one post-norm encoder layer over the flattened map with the
    2D sine-cosine table of the reference, x-major flatten quirk and all;
  * `MSDeformAttn` samples each level with `F.grid_sample` (bilinear,
    zeros outside, align_corners False) in fp32: the JAX package's four
    corner gathers, whose out-of-range corners weigh 0, in one library call
    a level. Its backward on the card adds into the value grads with
    atomics, so a train step there does not repeat bit for bit;
  * `RTDETRDecoder` selects its queries by a top-k of the encoder scores in
    which the lower anchor index wins ties (jax.lax.top_k's order; anchors
    outside (0.01, 0.99) all score alike and their logits are +inf), runs
    the decoder layers with the box-refinement ladder, detaching where the
    JAX package stops gradients, and in training prepends the contrastive
    denoising group (`get_cdn_group`), whose size comes from the padded GT
    capacity. Its four random draws come from `dn_generator` (a seeded
    torch.Generator the trainer sets), or from explicit tensors handed in
    with the targets (`targets["dn_draws"]`, `cdn_draws` names them).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.boxes import xywh2xyxy, xyxy2xywh
from ..ops.nms import _topk_first
from .modules import Conv, Linear

LN_EPS = 1e-6  # flax's LayerNorm epsilon


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The logit of x clipped to [0, 1], both terms clipped below at eps."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


class LayerNorm(nn.LayerNorm):
    """flax's LayerNorm (epsilon 1e-6) computed in fp32, cast back to the input's dtype."""

    def __init__(self, c: int):
        super().__init__(c, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class MHA(nn.Module):
    """Multi-head attention with distinct q, k and v inputs (the module docstring)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = Linear(c, c)

    @torch.no_grad()
    def init_jax(self, generator: torch.Generator) -> None:
        """Xavier-uniform projections and zero biases, as the JAX package's init."""
        for w in (self.in_proj_weight, self.out_proj.weight):
            bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            w.uniform_(-bound, bound, generator=generator)
        self.in_proj_bias.zero_()
        self.out_proj.bias.zero_()

    def forward(self, q, k, v, attn_mask: Optional[torch.Tensor] = None):
        n, lq, c = q.shape
        nh = self.num_heads
        hd = c // nh
        w, b = self.in_proj_weight.to(q.dtype), self.in_proj_bias.to(q.dtype)

        def heads(t, i):
            return F.linear(t, w[i * c:(i + 1) * c], b[i * c:(i + 1) * c]).reshape(n, -1, nh, hd).transpose(1, 2)

        q, k, v = heads(q, 0), heads(k, 1), heads(v, 2)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        if attn_mask is not None:  # True = blocked
            attn = attn.masked_fill(attn_mask, -1e9)
        out = torch.matmul(attn.softmax(-1).to(v.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(n, lq, c))


class TransformerEncoderLayer(nn.Module):
    """A post-norm transformer encoder layer (`ma`, `fc1`, `fc2`, `norm1`,
    `norm2`; GELU), without dropout: every packaged graph sets it to 0."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MHA(c1, num_heads)
        self.fc1 = Linear(c1, cm)
        self.fc2 = Linear(cm, c1)
        self.norm1 = LayerNorm(c1)
        self.norm2 = LayerNorm(c1)

    def forward(self, src, pos: Optional[torch.Tensor] = None):
        q = src if pos is None else src + pos
        src = self.norm1(src + self.ma(q, q, src))
        return self.norm2(src + self.fc2(F.gelu(self.fc1(src))))


def sincos_2d_pos(w: int, h: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """(1, w * h, dim) sine-cosine table, built over the (w, h) grid with
    indexing 'ij' while the features flatten (h, w) row-major: the
    reference's quirk, kept so that its weights see the positions they
    were trained with."""
    assert dim % 4 == 0, "embed dim must be divisible by 4"
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = grid_w.reshape(-1, 1) @ omega[None]
    out_h = grid_h.reshape(-1, 1) @ omega[None]
    return np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1)[None]


class AIFI(TransformerEncoderLayer):
    """Attention-based intra-scale feature interaction: one encoder layer over
    the (B, C, H, W) map flattened to (B, H * W, C), with the fixed sincos
    table (cached per shape and device) added to its queries and keys."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__(c1, cm, num_heads)
        self._pos: Dict[tuple, torch.Tensor] = {}

    def forward(self, x):
        b, c, h, w = x.shape
        key = (w, h, c, x.device, x.dtype)
        if key not in self._pos:
            with torch.inference_mode(False):  # a plain tensor: a later train step may save it for its backward
                self._pos[key] = torch.from_numpy(sincos_2d_pos(w, h, c)).to(x.device, x.dtype)
        y = super().forward(x.permute(0, 2, 3, 1).reshape(b, h * w, c), pos=self._pos[key])
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class MLP(nn.Module):
    """num_layers Linear layers (`layers`) with ReLU between them."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(Linear(i, o) for i, o in zip(dims, dims[1:] + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x

    @torch.no_grad()
    def zero_last(self) -> None:
        self.layers[-1].weight.zero_()
        self.layers[-1].bias.zero_()


def _offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """MSDeformAttn's initial sampling offsets: head h samples along the
    direction 2 pi h / n_heads scaled to the unit square, point i at i + 1."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def ms_deform_sample(value: torch.Tensor, shapes: Sequence[Tuple[int, int]], loc: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable sampling in fp32. value (B, sum H W, nh, hd);
    loc (B, Lq, nh, nl, np, 2) normalised x, y; weights (B, Lq, nh, nl, np)
    -> (B, Lq, nh * hd): each level's bilinear samples (zero outside the
    map, align_corners False) weighted and summed over levels and points."""
    bs, _, nh, hd = value.shape
    lq, npnt = loc.shape[1], loc.shape[4]
    out = None
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].float().permute(0, 2, 3, 1).reshape(bs * nh, hd, h, w)
        start += h * w
        grid = (2.0 * loc[:, :, :, lvl] - 1.0).transpose(1, 2).reshape(bs * nh, lq, npnt, 2)
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False)  # (B nh, hd, Lq, np)
        a = weights[:, :, :, lvl].transpose(1, 2).reshape(bs * nh, 1, lq, npnt)
        term = (s * a).sum(-1)
        out = term if out is None else out + term
    return out.reshape(bs, nh * hd, lq).transpose(1, 2)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention: `sampling_offsets` and
    `attention_weights` (softmax over levels and points, fp32) from the
    query, `value_proj` of the flattened features, the samples around each
    query's reference box (offsets scaled by half its size over n_points),
    `output_proj`."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)

    @torch.no_grad()
    def init_jax(self, generator: torch.Generator) -> None:
        """Zero offset and weight kernels, the offsets' direction grid as
        their bias (the JAX package's init)."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(_offset_bias(self.n_heads, self.n_levels, self.n_points)))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query, refer_bbox, value, value_shapes: Sequence[Tuple[int, int]]):
        """query (B, Lq, C); refer_bbox (B, Lq, 1 or nl, 4) xywh in [0, 1];
        value (B, sum H W, C) -> (B, Lq, C)."""
        bs, lq, c = query.shape
        nh, nl, npnt = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value).reshape(bs, -1, nh, c // nh)
        off = self.sampling_offsets(query).reshape(bs, lq, nh, nl, npnt, 2).float()
        aw = self.attention_weights(query).reshape(bs, lq, nh, nl * npnt).float().softmax(-1)
        refer = refer_bbox.float()[:, :, None, :, None]
        loc = refer[..., :2] + off / npnt * refer[..., 2:] * 0.5
        out = ms_deform_sample(value, value_shapes, loc, aw.reshape(bs, lq, nh, nl, npnt))
        return self.output_proj(out.to(query.dtype))


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention (`self_attn`, `norm1`), deformable cross-attention
    (`cross_attn`, `norm2`) and a ReLU feed-forward (`linear1`, `linear2`,
    `norm3`), each with a residual; no dropout."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024, n_levels: int = 4,
                 n_points: int = 4):
        super().__init__()
        self.self_attn = MHA(d_model, n_heads)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, embed, refer_bbox, feats, shapes, attn_mask=None, query_pos=None):
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed, attn_mask=attn_mask))
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm2(embed + self.cross_attn(q, refer_bbox[:, :, None, :], feats, shapes))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


class DeformableTransformerDecoder(nn.Module):
    """The decoder layers (`layers`) and the box-refinement ladder that runs them."""

    def __init__(self, d_model: int, n_heads: int, d_ffn: int, n_levels: int, n_points: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(DeformableTransformerDecoderLayer(d_model, n_heads, d_ffn, n_levels, n_points)
                                    for _ in range(num_layers))

    def forward(self, embed, refer, feats, shapes, bbox_head, score_head, pos_mlp, attn_mask=None):
        """embed (B, Lq, C) and refer (B, Lq, 4) logits -> the per-layer boxes
        (sigmoid xywh, fp32) and class logits (fp32): every layer's in
        training, the last layer's only in eval. In training a layer's
        reference is the previous layer's refined box detached, and from the
        second layer the supervised box refines the previous layer's
        undetached one, as the JAX package's ladder does."""
        dtype = embed.dtype
        output = embed
        refer_s = torch.sigmoid(refer.float())
        boxes, scores = [], []
        last = None
        for i, layer in enumerate(self.layers):
            rs = refer_s.to(dtype)
            output = layer(output, rs, feats, shapes, attn_mask=attn_mask, query_pos=pos_mlp(rs))
            bbox = bbox_head[i](output).float()
            refined = torch.sigmoid(bbox + inverse_sigmoid(refer_s))
            if self.training:
                scores.append(score_head[i](output).float())
                boxes.append(refined if i == 0 else torch.sigmoid(bbox + inverse_sigmoid(last)))
            elif i == len(self.layers) - 1:
                scores.append(score_head[i](output).float())
                boxes.append(refined)
            last = refined
            refer_s = refined.detach() if self.training else refined
        return torch.stack(boxes), torch.stack(scores)


def build_cdn_attn_mask(num_dn: int, max_nums: int, num_group: int, nq: int) -> np.ndarray:
    """The (num_dn + nq)^2 denoising attention mask, True = blocked: the
    matching queries see no denoising query, and each denoising group of
    2 * max_nums queries sees no other group."""
    tgt = num_dn + nq
    m = np.zeros((tgt, tgt), dtype=bool)
    m[num_dn:, :num_dn] = True
    for i in range(num_group):
        lo, hi = max_nums * 2 * i, max_nums * 2 * (i + 1)
        m[lo:hi, hi:num_dn] = True
        m[lo:hi, :lo] = True
    return m


CDN_CLS_NOISE, CDN_BOX_NOISE = 0.5, 1.0  # the denoising group's class-noise ratio and box-noise scale


def cdn_draws(b: int, total: int, num_classes: int, generator: Optional[torch.Generator], device) -> Dict[str, torch.Tensor]:
    """The denoising group's four draws: `flip` (B, total) uniform, `cls`
    (B, total) class ids, `sign` (B, total, 4) in {0, 1}, `part` (B, total,
    4) uniform."""
    kw = {"generator": generator, "device": device}
    return {"flip": torch.rand((b, total), **kw), "cls": torch.randint(0, num_classes, (b, total), **kw),
            "sign": torch.randint(0, 2, (b, total, 4), **kw), "part": torch.rand((b, total, 4), **kw)}


def get_cdn_group(gt_cls, gt_bbox, gt_mask, class_embed, num_classes: int, draws: Dict[str, torch.Tensor],
                  num_dn: int = 100):
    """The fixed-shape contrastive denoising group of the JAX package: the G
    GT slots tiled 2 * ng times (ng = num_dn // G; the first ng copies
    positive, the rest negative), a quarter of the classes (CDN_CLS_NOISE /
    2) drawn anew at random, each box's corners moved by up to half its size
    times CDN_BOX_NOISE (the negatives by one to two halves), padded slots
    zeroed. gt_cls (B, G), gt_bbox (B, G, 4)
    normalised xywh, gt_mask (B, G), class_embed (nc, hd), draws as
    `cdn_draws` makes them for (B, 2 ng G). Returns (embed (B, 2 ng G, hd),
    box logits (B, 2 ng G, 4) fp32, mask (B, 2 ng G), ng)."""
    b, g = gt_cls.shape
    ng = max(1, num_dn // g)
    total = 2 * ng * g
    mask2 = gt_mask.float().repeat(1, 2 * ng)
    cls2 = gt_cls.long().repeat(1, 2 * ng)
    bbox2 = gt_bbox.float().repeat(1, 2 * ng, 1)
    neg = (torch.arange(total, device=gt_cls.device) // g) >= ng
    cls2 = torch.where(draws["flip"] < CDN_CLS_NOISE * 0.5, draws["cls"].long(), cls2)
    known = xywh2xyxy(bbox2)
    diff = (bbox2[..., 2:] * 0.5).repeat(1, 1, 2) * CDN_BOX_NOISE
    sign = draws["sign"].float() * 2.0 - 1.0
    part = draws["part"].float() + neg[None, :, None].float()
    bbox2 = xyxy2xywh((known + part * sign * diff).clamp(0.0, 1.0))
    dn_bbox = inverse_sigmoid(bbox2, eps=1e-6) * mask2[..., None]
    dn_embed = class_embed[cls2.clamp(0, num_classes - 1)] * mask2[..., None].to(class_embed.dtype)
    return dn_embed, dn_bbox, mask2, ng


class RTDETRDecoder(nn.Module):
    """RT-DETR's head: the hybrid encoder's three maps projected to hd
    (`input_proj`), the encoder's per-anchor scores and boxes, the top nq
    anchors as queries, the deformable decoder (`decoder`) with its score and
    box heads. Eval returns ((B, nq, 4 + nc): sigmoid xywh normalised to the
    input, then the class sigmoids, None); training the dict of
    `dec_bboxes` (ndl, B, num_dn + nq, 4), `dec_scores` (ndl, B, num_dn +
    nq, nc) logits, `enc_bboxes` (B, nq, 4) and `enc_scores` (B, nq, nc)
    logits, all fp32, with the denoising group of `targets` (cls, bboxes,
    mask, and optionally dn_draws) in front of the queries."""

    num_dn = 100  # the denoising group's size

    def __init__(self, nc: int = 80, ch: Sequence[int] = (512, 1024, 2048), hd: int = 256, nq: int = 300,
                 ndp: int = 4, nh: int = 8, ndl: int = 6, d_ffn: int = 1024, strides: Sequence[int] = (8, 16, 32)):
        super().__init__()
        self.nc, self.hd, self.nq = nc, hd, nq
        self.strides = tuple(strides)
        self.dn_generator: Optional[torch.Generator] = None  # the denoising draws' generator (the trainer's)
        self.input_proj = nn.ModuleList(Conv(c, hd, 1, act=False) for c in ch)
        self.decoder = DeformableTransformerDecoder(hd, nh, d_ffn, len(ch), ndp, ndl)
        self.denoising_class_embed = nn.Embedding(nc, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.enc_output = nn.Sequential(Linear(hd, hd), LayerNorm(hd))
        self.enc_score_head = Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.dec_score_head = nn.ModuleList(Linear(hd, nc) for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))
        self._anchor_cache: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def init_jax(self, generator: torch.Generator) -> None:
        """The JAX package's init of the head's own leaves: the class embedding
        normal(1), enc_output's Dense xavier-uniform, the score heads' bias
        prior -log(99) / 80 * nc, zero last box layers."""
        self.denoising_class_embed.weight.normal_(0.0, 1.0, generator=generator)
        w = self.enc_output[0].weight
        bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
        w.uniform_(-bound, bound, generator=generator)
        self.enc_output[0].bias.zero_()
        bias_cls = float(-math.log((1 - 0.01) / 0.01)) / 80.0 * self.nc
        for head in [self.enc_score_head, *self.dec_score_head]:
            head.bias.fill_(bias_cls)
        for mlp in [self.enc_bbox_head, *self.dec_bbox_head]:
            mlp.zero_last()

    def anchors(self, shapes: Sequence[Tuple[int, int]], device):
        """((1, A, 4) anchor logits, +inf outside (0.01, 0.99); (1, A, 1)
        validity) of the levels' (h, w), each level's box 0.05 x 2^i wide, in
        fp32 as the JAX package's numpy builds them; cached per shapes and
        device."""
        key = (tuple(shapes), str(device))
        if key not in self._anchor_cache:
            anchors = []
            for i, (h, w) in enumerate(shapes):
                gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
                gxy = (np.stack([gx, gy], -1) + 0.5) / np.asarray([w, h], np.float32)
                wh = np.ones_like(gxy) * 0.05 * (2.0 ** i)
                anchors.append(np.concatenate([gxy, wh], -1).reshape(-1, 4))
            a = np.concatenate(anchors, 0)[None]
            valid = ((a > 0.01) & (a < 0.99)).all(-1, keepdims=True)
            a = np.where(valid, np.log(a / (1 - a)), np.inf).astype(np.float32)
            with torch.inference_mode(False):  # a plain tensor: a later train step may save it for its backward
                self._anchor_cache[key] = (torch.from_numpy(a).to(device),
                                           torch.from_numpy(valid.astype(np.float32)).to(device))
        return self._anchor_cache[key]

    def forward(self, xs: List[torch.Tensor], targets: Optional[Dict[str, torch.Tensor]] = None):
        b = xs[0].shape[0]
        dtype = xs[0].dtype
        hd = self.hd
        shapes = [(x.shape[2], x.shape[3]) for x in xs]
        feats = torch.cat([p(x).permute(0, 2, 3, 1).reshape(b, -1, hd) for p, x in zip(self.input_proj, xs)], 1)

        anchors, valid = self.anchors(shapes, feats.device)
        enc_feats = self.enc_output(valid.to(dtype) * feats)
        enc_scores_all = self.enc_score_head(enc_feats)  # (B, A, nc)
        nq = min(self.nq, enc_scores_all.shape[1])  # the tiny graphs of the tests have fewer anchors
        _, idx = _topk_first(enc_scores_all.float().amax(-1), nq)
        top_feats = enc_feats.gather(1, idx[..., None].expand(-1, -1, hd))
        top_anchors = anchors.expand(b, -1, -1).gather(1, idx[..., None].expand(-1, -1, 4))
        refer = self.enc_bbox_head(top_feats) + top_anchors.to(dtype)  # +inf where the anchor is invalid
        enc_bboxes = torch.sigmoid(refer.float())
        enc_scores = enc_scores_all.gather(1, idx[..., None].expand(-1, -1, self.nc))
        embed = top_feats
        if self.training:  # the queries and their boxes enter the decoder detached, as JAX stops their gradients
            refer, embed = refer.detach(), embed.detach()

        attn_mask = None
        if self.training and targets is not None:
            g = min(targets["cls"].shape[1], max(self.num_dn, 1))
            ng = max(1, self.num_dn // g)
            total = 2 * ng * g
            draws = targets.get("dn_draws") or cdn_draws(b, total, self.nc, self.dn_generator, feats.device)
            dn_embed, dn_bbox, _, _ = get_cdn_group(targets["cls"][:, :g], targets["bboxes"][:, :g],
                                                    targets["mask"][:, :g], self.denoising_class_embed.weight.to(dtype),
                                                    self.nc, draws, self.num_dn)
            embed = torch.cat([dn_embed.to(dtype), embed], 1)
            refer = torch.cat([dn_bbox.to(refer.dtype), refer], 1)
            attn_mask = torch.from_numpy(build_cdn_attn_mask(total, g, ng, nq)).to(feats.device)

        dec_bboxes, dec_scores = self.decoder(embed, refer, feats, shapes, self.dec_bbox_head, self.dec_score_head,
                                              self.query_pos_head, attn_mask=attn_mask)
        if self.training:
            return {"dec_bboxes": dec_bboxes, "dec_scores": dec_scores, "enc_bboxes": enc_bboxes,
                    "enc_scores": enc_scores.float()}
        return torch.cat([dec_bboxes[-1], torch.sigmoid(dec_scores[-1])], -1), None
