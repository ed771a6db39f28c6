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

Every `Conv` records its input (`x_amax`); CBAM's convs and the Detect
head's last 1x1 convs stay float, as in the JAX package. Every SwinBlock
records the inputs of its four products (`qkv_amax`, `out_amax`,
`fc1_amax`, `fc2_amax`), its input (`xin_amax`) and its float output
(`yout_amax`). Quantize a BN-folded model as the JAX package's bench and
exporter do: fuse() first, since folding changes the weights afterwards.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn as nn
import torch.nn.functional as F

from .swin_int8 import QKEYS, QWEIGHTS, q8

Calib = Dict[str, Dict[str, torch.Tensor]]


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32, exact (torch._int_mm).
    K is zero-padded to a multiple of 8 and M to more than 16 rows, which the
    card's int8 product needs."""
    m, k = a.shape
    if k % 8:
        a, w = F.pad(a, (0, -k % 8)), F.pad(w, (0, -k % 8))
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:m]


def conv_int8(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor, x_scale: torch.Tensor, stride: int,
              padding: int) -> torch.Tensor:
    """The int8 convolution of a quantized Conv: x (B, C, H, W) is quantized
    to x_scale, convolved with w_int8 (O, C, kh, kw) in exact int32 sums, and
    dequantized as acc * (x_scale * w_scale) in fp32 -> (B, O, Ho, Wo),
    channels_last. A 1x1 stride-1 conv is one int8 product of the NHWC view
    (B*H*W, C) with (O, C); a k x k conv gathers its k*k shifted, strided
    views of the zero-padded NHWC input into (B*Ho*Wo, k*k*C) first. The
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
        cols = torch.cat([xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
                          for dy in range(kh) for dx in range(kw)], -1).reshape(-1, kh * kw * c)
    acc = int_mm(cols, w_int8.permute(0, 2, 3, 1).reshape(o, kh * kw * c))
    y = acc.view(b, ho, wo, o).permute(0, 3, 1, 2).float()
    return y * (x_scale.float() * w_scale.float()).view(1, -1, 1, 1)


def _quantizable(model: nn.Module) -> Dict[str, nn.Module]:
    from ..nn.modules import Conv, SwinBlock

    return {n: m for n, m in model.named_modules() if isinstance(m, (Conv, SwinBlock))}


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
    model in place; returns the model. YOLO.predict then serves it in int8."""
    return load_quant_state(model, build_quant_state(model, calibrate(model, batches)))


def is_quantized(model: nn.Module) -> bool:
    return any(getattr(m, n) is not None for m in _quantizable(model).values() for n in m.QNAMES)
