"""Int8 post-training quantization (PTQ) of a DetectionModel, in place.

The JAX package's scheme (its ops/quant.py): symmetric int8 with
per-output-channel weight scales, absmax / 127, and per-tensor activation
scales from the running |max| of a calibration sweep, amax / 127.

  calibrate(model, batches)           run uint8 (B, H, W, 3) batches; per
                                      module name, the recorded |max| values
  build_quant_state(model, calib)     {"<module>.<buffer>": tensor}: int8
                                      weights and scales of every Conv and
                                      SwinBlock, from fp32 weights
  load_quant_state(model, state)      set those buffers on the modules
  quantize_model(model, batches)      all three

The JAX package's int8 gate: every module that is a `Conv` in the JAX
package records its input (`x_amax`) and gets int8 weights, grouped ones
included, and runs its product in int8 where it is ungrouped
(Conv.runs_int8, JAX's g == 1): the rows of every graph the port builds
(the fork's, YOLO11, YOLOv3 to v9, YOLOv10, YOLO12, the seg graphs, the
RT-DETR graphs' HGStem, HGBlock, RepC3 and the decoder's `input_proj.i`,
YOLO-World's C2fAttn with its attention's `ec` and `proj_conv`). A
grouped conv (DWConv, SCDown's and RepVGGDW's depth-wise convs, CIB's,
v10Detect's light class branch, GhostConv's cheap op, the `pe` of
Attention and AAttn) keeps its float path; so do YOLO11 Attention's and
AAttn's products, whose qkv and proj Convs go int8. What is a raw conv in
the JAX package stays float and uncalibrated: RepConv's two branches (port
Convs whose BatchNorm RepConv applies itself), CBLinear, the transposed
convs of yolov6 and Proto, the last 1x1 convs of Detect, v10Detect's two
branch sets and Segment's cv4, CBAM's convs and ImagePoolingAttn's
projections; so do the Linears (RT-DETR's AIFI, deformable attention and
decoder, YOLO-World's text products), as the JAX package's
build_quant_variables quantizes only Conv kernels and the SwinBlock's
products. Every SwinBlock records
the inputs of its four products (`qkv_amax`, `out_amax`, `fc1_amax`,
`fc2_amax`), its input (`xin_amax`) and its float output (`yout_amax`).
Quantize a BN-folded model as the JAX package's bench and exporter do:
fuse() first, since folding changes the weights afterwards.

conv_int8 takes one stride and one padding for both axes, with no
dilation: quantize_model refuses an ungrouped Conv that has other ones
(no packaged graph does) rather than compute another convolution.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn as nn
import torch.nn.functional as F

from .swin_int8 import QKEYS, QWEIGHTS, q8

Calib = Dict[str, Dict[str, torch.Tensor]]


def int_mm(a: torch.Tensor, w: torch.Tensor, min_rows: int = 0) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32, exact (torch._int_mm).
    K and N are zero-padded to multiples of 8 (the extra output columns are
    cut), which the card's int8 product needs (a ghost conv's 4 output
    channels at scale n); it also needs more than 16 rows, so where
    `min_rows`, the fewest rows `a` can have (one image's rows, for
    conv_int8), is 16 or fewer, 16 zero rows are appended. The pad depends
    on that bound only, never on the batch, so one torch.export program
    keeps it at every batch. min_rows=0: M itself is the bound."""
    m, k = a.shape
    n = w.shape[0]
    if k % 8:
        a, w = F.pad(a, (0, -k % 8)), F.pad(w, (0, -k % 8))
    if n % 8:
        w = F.pad(w, (0, 0, 0, -n % 8))
    if (min_rows or m) <= 16:
        a = F.pad(a, (0, 0, 0, 16))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())[:m]
    return out[:, :n] if n % 8 else out


def conv_int8(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor, x_scale: torch.Tensor, stride: int,
              padding: int) -> torch.Tensor:
    """The int8 convolution of a quantized Conv: x (B, C, H, W) is quantized
    to x_scale, convolved with w_int8 (O, C, kh, kw) in exact int32 sums, and
    dequantized as acc * (x_scale * w_scale) in fp32 -> (B, O, Ho, Wo),
    channels_last. A 1x1 stride-1 conv is one int8 product of the NHWC view
    (B*H*W, C) with (O, C); a k x k conv gathers its k*k shifted, strided
    windows of the zero-padded NHWC input (a strided view) into (B*Ho*Wo,
    k*k*C) first, in one copy. The
    integer sums are exact (torch._int_mm accumulates in int32), as XLA's
    int8 convolution is in the JAX package."""
    o, c, kh, kw = w_int8.shape
    xq = q8(x.float(), x_scale).to(torch.int8).permute(0, 2, 3, 1)  # NHWC
    b, h, w, _ = xq.shape
    if kh == kw == 1 and stride == 1 and padding == 0:
        cols, ho, wo = xq.reshape(-1, c), h, w
    else:
        xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
        ho, wo = (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1
        win = xp.unfold(1, kh, stride).unfold(2, kw, stride)  # (B, Ho, Wo, C, kh, kw), a view
        cols = win.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * c)  # one copy, (dy, dx, c) per row
    acc = int_mm(cols, w_int8.permute(0, 2, 3, 1).reshape(o, kh * kw * c), min_rows=ho * wo)
    y = acc.view(b, ho, wo, o).permute(0, 3, 1, 2).float()
    return y * (x_scale * w_scale).view(1, -1, 1, 1)  # the scales are fp32 (load_quant_state)


def _quantizable(model: nn.Module) -> Dict[str, nn.Module]:
    """The Convs and SwinBlocks that the JAX package calibrates: all but
    RepConv's branches, raw convs there."""
    from ..nn.modules import Conv, RepConv, SwinBlock

    raw = {id(c) for m in model.modules() if isinstance(m, RepConv) for c in (m.conv1, m.conv2)}
    return {n: m for n, m in model.named_modules() if isinstance(m, (Conv, SwinBlock)) and id(m) not in raw}


def _check_int8_geometry(name: str, conv: nn.Conv2d) -> None:
    """conv_int8 runs one stride and one padding on both axes, no dilation."""
    if conv.groups == 1 and (conv.stride[0] != conv.stride[1] or conv.padding[0] != conv.padding[1]
                             or tuple(conv.dilation) != (1, 1)):
        raise ValueError(f"quantize_model: {name} has stride {tuple(conv.stride)}, padding "
                         f"{tuple(conv.padding)} and dilation {tuple(conv.dilation)}; its int8 path "
                         "(conv_int8) takes one stride and one padding for both axes and no dilation")


def calibrate(model: nn.Module, batches: Iterable) -> Calib:
    """Run the calibration batches, uint8 (B, H, W, 3) arrays or tensors, as
    img.to(model dtype) / 255 (no letterbox, as the JAX package's calibrate);
    return {module name: {"x_amax" or the six Swin amaxes: fp32 scalar}}, the
    running |max| over all batches."""
    mods = _quantizable(model)
    for m in mods.values():
        m.calib = {}
    try:
        with torch.inference_mode():
            for img in batches:
                x = torch.as_tensor(img, device=next(model.parameters()).device)
                model(x.permute(0, 3, 1, 2).to(model.dtype) / 255.0)
        return {n: dict(m.calib) for n, m in mods.items()}
    finally:
        for m in mods.values():
            m.calib = None


def _quantize_weight(w: torch.Tensor, reduce_dims) -> tuple:
    """Per-output-channel symmetric int8: (w_int8, w_scale), scale = max(|w|, 1e-12) / 127 over reduce_dims."""
    scale = w.abs().amax(reduce_dims).clamp(min=1e-12) / 127.0
    shape = (-1,) + (1,) * (w.dim() - 1)
    return torch.clamp(torch.round(w / scale.view(shape)), -127, 127).to(torch.int8), scale


def _act_scale(amax: torch.Tensor) -> torch.Tensor:
    return amax.float().clamp(min=1e-12) / 127.0


def _fp32_weight(name: str, w: torch.Tensor) -> torch.Tensor:
    if w.dtype != torch.float32:
        raise ValueError(f"quantize_model needs fp32 weights, as the JAX package quantizes its fp32 params; "
                         f"{name} is {w.dtype}: build the model with param_dtype=torch.float32")
    return w.detach()


@torch.no_grad()
def build_quant_state(model: nn.Module, calib: Calib) -> Dict[str, torch.Tensor]:
    """The quant buffers of every calibrated module, named "<module>.<buffer>":
    a Conv's w_int8 (O, I, kh, kw), w_scale (O,), x_scale; a SwinBlock's
    <k>_w_int8 (out, in), <k>_w_scale (out,), <k>_x_scale for k in qkv, out,
    fc1, fc2, and x_in_scale, y_out_scale. Raises for weights other than fp32."""
    from ..nn.modules import Conv

    state: Dict[str, torch.Tensor] = {}
    for name, amax in calib.items():
        m = model.get_submodule(name)
        if isinstance(m, Conv):
            w8, ws = _quantize_weight(_fp32_weight(f"{name}.conv.weight", m.conv.weight), (1, 2, 3))
            state.update({f"{name}.w_int8": w8, f"{name}.w_scale": ws, f"{name}.x_scale": _act_scale(amax["x_amax"])})
            continue
        p = m.kernel_params()
        for k in QKEYS:
            w8, ws = _quantize_weight(_fp32_weight(f"{name}.{QWEIGHTS[k]}", p[QWEIGHTS[k]]), 1)
            state.update({f"{name}.{k}_w_int8": w8, f"{name}.{k}_w_scale": ws,
                          f"{name}.{k}_x_scale": _act_scale(amax[f"{k}_amax"])})
        state[f"{name}.x_in_scale"] = _act_scale(amax["xin_amax"])
        state[f"{name}.y_out_scale"] = _act_scale(amax["yout_amax"])
    return state


def load_quant_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Set the quant buffers named in `state` on the model's Conv and
    SwinBlock modules, on the model's device; int8 stays int8, scales fp32."""
    mods = _quantizable(model)
    dev = next(model.parameters()).device
    for key, t in state.items():
        name, buf = key.rsplit(".", 1)
        m = mods.get(name)
        if m is None or buf not in m.QNAMES:
            raise KeyError(f"{key} names no quant buffer of a Conv or SwinBlock of this model")
        setattr(m, buf, t.to(device=dev, dtype=torch.int8 if buf.endswith("w_int8") else torch.float32))
    return model


def quantize_model(model: nn.Module, batches: Iterable) -> nn.Module:
    """Calibrate on `batches` and quantize every Conv and SwinBlock of the
    model that the JAX package quantizes, in place; returns the model.
    YOLO.predict then serves it in int8. Every graph the port builds is
    taken; grouped convs, Attention's products and the raw convs stay float
    (see the module docstring). Raises ValueError, before it calibrates,
    for a Conv whose weights are not fp32 or whose stride, padding or
    dilation conv_int8 does not take."""
    from ..nn.modules import Conv

    for name, m in _quantizable(model).items():
        if isinstance(m, Conv):  # refuse before the calibration sweep, not after it
            _fp32_weight(f"{name}.conv.weight", m.conv.weight)
            _check_int8_geometry(name, m.conv)
    return load_quant_state(model, build_quant_state(model, calibrate(model, batches)))


def is_quantized(model: nn.Module) -> bool:
    return any(getattr(m, n) is not None for m in _quantizable(model).values() for n in m.QNAMES)
