"""The int8 SwinBlock of post-training quantization: a hand-written CUDA kernel and its plain version.

`swin_block_int8(x, p, q, num_heads, window_size, in8, out8, sm16)` applies
the block with its four products (qkv, out-projection, MLP fc1 and fc2) as
int8 x int8 -> int32 on x (B, H, W, C), H and W of any size: windows that run
past the edge see zero tokens, as the reference pads with zeros before the
block and crops after it. On a CUDA tensor it launches the kernel
(csrc/swin_block_int8.cu), which replaces the TPU kernel
`_swin_flat_int8_kernel` of `fused_swin_block_int8` and, with sm16=True, its
experimental variant `_swin_int8_io_kernel`; on a CPU tensor it runs
`swin_block_int8_plain`, which repeats the kernel's arithmetic in PyTorch.
Both go through the PyTorch operator `yolov8_cbam_swin::swin_block_int8`
(`swin_block_int8_op`), which a torch.export program keeps as one node.
`impl="plain"` forces the plain version on the card, for comparison.

`p` holds the block's float parameters in the layout of ops/swin.py; only the
LayerNorm vectors and the biases are read, in fp32. `q` holds the quantized
products, named after the JAX package's `quant` entries:
  <k>_w_int8  (out, in) int8    per-output-channel symmetric weights
  <k>_w_scale (out,)    fp32    their scales
  <k>_x_scale ()        fp32    the calibrated scale of the product's input
for k in qkv, out, fc1, fc2, and, for int8 input and output (in8, out8),
x_in_scale and y_out_scale.

`swin_gemm_absmax` gives the calibration pass the |max| of the four product
inputs, from the block's exact float arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from .swin import MAX_SMEM, Params, _aligned, _from_windows, _ln_stats, _to_windows

QKEYS = ("qkv", "out", "fc1", "fc2")
QWEIGHTS = {"qkv": "wqkv", "out": "wout", "fc1": "w1", "fc2": "w2"}  # the float matrix each product quantizes
QBIASES = {"qkv": "bqkv", "out": "bout", "fc1": "b1", "fc2": "b2"}
QNAMES = tuple(f"{k}_{s}" for k in QKEYS for s in ("w_int8", "w_scale", "x_scale")) + ("x_in_scale", "y_out_scale")
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_VECTORS = ("ln1_w", "ln1_b", "bqkv", "bout", "ln2_w", "ln2_b", "b1", "b2")


def q8(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 levels of t: clamp(round_half_even(t / scale), -127, 127), as fp32."""
    return torch.clamp(torch.round(t / scale), -127, 127)


def swin_gemm_absmax(x: torch.Tensor, p: Params, num_heads: int = 2,
                     window_size: int = 7) -> Dict[str, torch.Tensor]:
    """{qkv, out, fc1, fc2: |max| of that product's input} over the zero-padded
    windows of x, pad tokens included, as the JAX package's calibration takes
    them: the block's exact arithmetic (fp32 LN1 affine, erf GELU) with xn,
    qkv, the probabilities, head outputs, the LN2 output and the hidden
    rounded to x's dtype and the matrices used in x's dtype."""
    dt = x.dtype

    def r(t):
        return t.to(dt).float()

    c = x.shape[-1]
    hd = c // num_heads
    yhat, _ = _ln_stats(_to_windows(x, window_size).float())
    xn32 = yhat * p["ln1_w"].float() + p["ln1_b"].float()
    xn = r(xn32)
    n, l, _ = xn.shape
    qkv = r(xn @ r(p["wqkv"].float()).t() + p["bqkv"].float())
    q, k, v = (t.reshape(n, l, num_heads, hd).transpose(1, 2) for t in qkv.split(c, dim=-1))
    attn = r(torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1))
    o = r(attn @ v).transpose(1, 2).reshape(n, l, c)
    y1 = xn32 + (o @ r(p["wout"].float()).t() + p["bout"].float())
    yhat2, _ = _ln_stats(y1)
    y1n = r(yhat2 * p["ln2_w"].float() + p["ln2_b"].float())
    h = r(F.gelu(y1n @ r(p["w1"].float()).t() + p["b1"].float()))
    return {key: t.abs().amax() for key, t in (("qkv", xn), ("out", o), ("fc1", y1n), ("fc2", h))}


def _gelu_tanh(pb: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """0.5 pb (1 + tanh(0.7978845608 (pb + 0.044715 pb^3))) with every
    operation rounded to cdt and the constants taken in cdt, as the JAX
    package evaluates it on a cdt array."""

    def r(t):
        return t.to(cdt).float()

    c1, c2 = (torch.tensor(v, dtype=cdt).float() for v in (0.044715, 0.7978845608))
    t = r(r(r(c1 * pb) * pb) * pb)
    t = r(c2 * r(pb + t))
    return r(r(0.5 * pb) * r(1.0 + r(torch.tanh(t))))


def compute_dtype(x_dtype: torch.dtype, in8: bool, sm16: bool) -> torch.dtype:
    """bf16 for int8 input or the bf16 softmax, else x's dtype."""
    return torch.bfloat16 if in8 or sm16 else x_dtype


def swin_block_int8_plain(x: torch.Tensor, p: Params, q: Params, num_heads: int = 2, window_size: int = 7,
                          in8: bool = False, out8: bool = False, sm16: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch. Each product quantizes its input to
    its per-tensor scale, sums the int8 products exactly (float64 holds every
    int32 sum) and dequantizes with the input scale times the per-channel
    weight scales, plus the fp32 bias. With in8 the input is int8 levels of
    x_in_scale; with out8 the output is int8 levels of y_out_scale. The
    compute dtype cdt (bf16 with in8 or sm16, else x's dtype) holds the LN1
    affine, qkv, the probabilities and the tanh GELU; each head's a.v, the
    residual stream and the LN2 output stay fp32. sm16 takes the softmax's
    exp, sum and division in bf16."""
    if in8 != (x.dtype == torch.int8):
        raise ValueError(f"in8={in8} needs {'an int8' if in8 else 'a float'} x, got {x.dtype}")
    cdt = compute_dtype(x.dtype, in8, sm16)

    def r(t):
        return t.to(cdt).float()

    b, h, w, c = x.shape
    hd = c // num_heads
    xs = {k: q[f"{k}_x_scale"].float() for k in QKEYS}

    def gemm(a32, key):
        acc = (q8(a32, xs[key]).double() @ q[f"{key}_w_int8"].double().t()).float()
        return acc * (xs[key] * q[f"{key}_w_scale"].float()) + p[QBIASES[key]].float()

    xw = _to_windows(x, window_size).float()
    x32 = xw * q["x_in_scale"].float() if in8 else xw
    yhat, _ = _ln_stats(x32)
    xn32 = (yhat.to(cdt) * p["ln1_w"].to(cdt) + p["ln1_b"].to(cdt)).float()
    n, l, _ = xn32.shape
    qkv = r(gemm(xn32, "qkv"))
    qh, kh, vh = (t.reshape(n, l, num_heads, hd).transpose(1, 2) for t in qkv.split(c, dim=-1))
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / hd**0.5)
    if sm16:
        e = r(torch.exp(r(s - s.amax(-1, keepdim=True))))
        attn = r(e / r(e.sum(-1, keepdim=True)))
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True))
        attn = r(e / e.sum(-1, keepdim=True))
    o32 = (attn @ vh).transpose(1, 2).reshape(n, l, c)
    y1 = xn32 + gemm(o32, "out")
    yhat2, _ = _ln_stats(y1)
    y1n32 = yhat2 * p["ln2_w"].float() + p["ln2_b"].float()
    hid = _gelu_tanh(r(gemm(y1n32, "fc1")), cdt)
    y = y1 + gemm(hid, "fc2")
    out = q8(y, q["y_out_scale"].float()).to(torch.int8) if out8 else y.to(cdt)
    return _from_windows(out, b, h, w, window_size)


def _resident_smem_bytes(c: int, num_heads: int, cbf: bool) -> int:
    """Shared memory of the layout that keeps the whole window resident: the
    fp32 residual stream (49 x C), the 9C dequantize factors and 9C biases
    (fp32), two int8 product inputs (64 x C+16), one head's q, k, v (bf16
    3 x 64 x hd+8, or fp32 49 x 3hd+1), the int8 MLP hidden (64 x 4C+16)
    over the second input and the head, and the ring (3 stages of 128 rows
    of 128 + 16 bytes, or of 64 + 16 in fp32)."""
    hd = c // num_heads
    in8 = 64 * (c + 16)
    head = 2 * 3 * 64 * (hd + 8) if cbf else 4 * 49 * (3 * hd + 1)
    region = -(-max(in8 + head, 64 * (4 * c + 16)) // 16) * 16
    return 4 * 49 * c + 4 * 18 * c + in8 + region + 3 * 128 * ((128 if cbf else 64) + 16)


def int8_is_wide(c: int, num_heads: int, cbf: bool) -> bool:
    """Whether the kernel takes its wide layout: bf16 compute where the
    resident layout exceeds a block's shared memory (C from 384 with 2 heads)."""
    return cbf and _resident_smem_bytes(c, num_heads, True) > MAX_SMEM


def _wide_smem_bytes(c: int, stream_in_global: bool) -> int:
    """Shared memory of the wide layout: the two int8 product inputs, 64-wide
    bf16 q and k slices with the fp32 scores, and the ring (3 stages of 128
    rows of 64 + 16 bytes), after the fp32 residual stream where that is
    resident. With the stream in global memory, the MLP's fc2 int32 sums
    (49 x C) lie over the second input, the slices and that ring, followed by
    the int8 hidden chunk (64 x 128 + 16) and a 2-stage ring."""
    in8, stream = 64 * (c + 16), 4 * 49 * c
    attention = 2 * in8 + -(-(2 * 2 * 64 * 72 + 4 * 49 * 49) // 16) * 16 + 3 * 128 * (64 + 16)
    if not stream_in_global:
        return stream + attention
    return max(attention, in8 + stream + 64 * (128 + 16) + 2 * 128 * (64 + 16))


def int8_stream_in_global(c: int, num_heads: int, cbf: bool) -> bool:
    """Whether the wide layout keeps the fp32 residual stream in its global
    scratch for the whole block: where the stream would not fit beside the
    rest (C from 640 with 2 heads; yolo11x's C=768)."""
    return int8_is_wide(c, num_heads, cbf) and _wide_smem_bytes(c, False) > MAX_SMEM


def smem_bytes(c: int, num_heads: int, cbf: bool) -> int:
    """Shared memory of one block of the kernel in the bf16 (cbf) or fp32
    compute dtype, a copy of Layout and WideLayout in csrc/swin_block_int8.cu
    for checks without the library (on the card the library's own number is
    used)."""
    if not int8_is_wide(c, num_heads, cbf):
        return _resident_smem_bytes(c, num_heads, cbf)
    return _wide_smem_bytes(c, int8_stream_in_global(c, num_heads, cbf))


def check_int8_supported(c: int, num_heads: int, window_size: int, x_dtype: torch.dtype, in8: bool,
                         sm16: bool = False, smem: Optional[Callable[[bool], int]] = None) -> None:
    """Raise ValueError for a shape or input dtype the kernel does not take.
    `smem(cbf)` returns the block's shared memory as the built library
    reports it, and is called once the other checks pass; without it,
    smem_bytes's copy."""
    if x_dtype not in _KINDS or in8 != (x_dtype == torch.int8):
        raise ValueError(f"swin_block_int8 kernel takes int8 x with in8, float32 or bfloat16 without; "
                         f"got {x_dtype} with in8={in8}")
    if window_size != 7:
        raise ValueError(f"swin_block_int8 kernel is built for 7x7 windows, not {window_size}")
    if c % 64 or c % num_heads:
        raise ValueError(f"swin_block_int8 kernel needs C % 64 == 0 and C % heads == 0 (C={c}, heads={num_heads})")
    if (c // num_heads) % 16:
        raise ValueError(f"swin_block_int8 kernel needs a head dim that is a multiple of 16 (the tensor-core "
                         f"tiles), not {c // num_heads}")
    cbf = compute_dtype(x_dtype, in8, sm16) == torch.bfloat16
    need = smem_bytes(c, num_heads, cbf) if smem is None else smem(cbf)
    if need > MAX_SMEM:
        raise ValueError(f"swin_block_int8 kernel needs {need} B of shared memory at C={c}, heads={num_heads}; "
                         f"the limit is {MAX_SMEM}")


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library, once per process."""
    from .cuda_build import build

    lib = ctypes.CDLL(str(build("swin_block_int8", ("swin_block_int8.cu",), ("-fmad=false",))))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swin_block_int8.argtypes = [i32] * 4 + [ptr, ptr] + [i32] * 5 + [ctypes.c_float] + [ptr] * 19
    lib.swin_block_int8.restype = i32
    lib.swin_block_int8_smem_bytes.argtypes = [i32, i32, i32]
    lib.swin_block_int8_smem_bytes.restype = ctypes.c_size_t
    lib.swin_block_int8_scratch_bytes.argtypes = [i32] * 6
    lib.swin_block_int8_scratch_bytes.restype = ctypes.c_size_t
    return lib


def _kernel_args(x: torch.Tensor, p: Params, q: Params, c: int):
    """Vectors and scales to fp32, weights to int8, all contiguous on x's
    device, the weights starting on 16 bytes (the kernel streams them in
    16-byte pieces); checks their shapes. The six activation scales go as
    one array (qkv, out, fc1, fc2, x_in, y_out), read by the kernel on the
    card."""
    dev = x.device
    vec = {k: p[k].to(device=dev, dtype=torch.float32).contiguous() for k in _VECTORS}
    wts, wsc = {}, {}
    for k, shape in (("qkv", (3 * c, c)), ("out", (c, c)), ("fc1", (4 * c, c)), ("fc2", (c, 4 * c))):
        wts[k] = _aligned(q[f"{k}_w_int8"].to(dev).contiguous())
        wsc[k] = q[f"{k}_w_scale"].to(device=dev, dtype=torch.float32).contiguous()
        if wts[k].dtype != torch.int8 or tuple(wts[k].shape) != shape or tuple(wsc[k].shape) != shape[:1]:
            raise ValueError(f"swin_block_int8 {k}: int8 weights {shape} and scales {shape[:1]} expected, got "
                             f"{wts[k].dtype} {tuple(wts[k].shape)} and {tuple(wsc[k].shape)}")
    one = torch.ones((), device=dev)
    xs = torch.stack([q[f"{k}_x_scale"].to(dev).float().reshape(()) for k in QKEYS]
                     + [q[k].to(dev).float().reshape(()) if k in q else one for k in ("x_in_scale", "y_out_scale")])
    return vec, wts, wsc, xs


def swin_block_int8_cuda(x: torch.Tensor, p: Params, q: Params, num_heads: int = 2, window_size: int = 7,
                         in8: bool = False, out8: bool = False, sm16: bool = False) -> torch.Tensor:
    """Launch the int8 SwinBlock kernel on x (B, H, W, C), a CUDA tensor.
    Raises on anything the kernel does not take and on a failed launch."""
    if not x.is_cuda:
        raise ValueError("swin_block_int8_cuda needs a CUDA tensor")
    if x.dim() != 4:
        raise ValueError(f"swin_block_int8 takes (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    check_int8_supported(c, num_heads, window_size, x.dtype, in8, sm16,
                         lambda cbf: _lib().swin_block_int8_smem_bytes(c, num_heads, int(cbf)))
    missing = [k for k, need in (("x_in_scale", in8), ("y_out_scale", out8)) if need and k not in q]
    if missing:
        raise ValueError(f"swin_block_int8 with in8={in8}, out8={out8} needs q{missing}")
    cdt = compute_dtype(x.dtype, in8, sm16)
    x = _aligned(x.contiguous())
    vec, wts, wsc, xs = _kernel_args(x, p, q, c)
    y = torch.empty(x.shape, device=x.device, dtype=torch.int8 if out8 else cdt)
    lib = _lib()
    cbf = int(cdt == torch.bfloat16)
    nbytes = lib.swin_block_int8_scratch_bytes(b, h, w, c, num_heads, cbf)  # the wide layout's residual stream
    scratch = torch.empty(nbytes, device=x.device, dtype=torch.uint8) if nbytes else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.swin_block_int8(
            _KINDS[x.dtype], _KINDS[y.dtype], cbf, int(sm16), x.data_ptr(), y.data_ptr(),
            b, h, w, c, num_heads, 1.0 / (c // num_heads) ** 0.5, xs.data_ptr(),
            *(vec[k].data_ptr() for k in _VECTORS),
            *(t.data_ptr() for k in QKEYS for t in (wts[k], wsc[k])),
            None if scratch is None else scratch.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"swin_block_int8 launch failed with CUDA error {rc}")
    swin_block_int8_cuda.launches += 1
    swin_block_int8_cuda.sm16_launches += sm16
    return y


swin_block_int8_cuda.launches = 0  # kernel launches since the last reset
swin_block_int8_cuda.sm16_launches = 0  # of those, launches with the bf16 softmax (sm16)


@torch.library.custom_op("yolov8_cbam_swin::swin_block_int8", mutates_args=(), device_types="cpu")
def swin_block_int8_op(x: torch.Tensor, p: List[torch.Tensor], q: List[torch.Tensor], num_heads: int,
                       window_size: int, in8: bool, out8: bool, sm16: bool) -> torch.Tensor:
    """The int8 SwinBlock as a PyTorch operator, so that torch.export keeps it
    as one node of the graph and a loaded program launches the kernel. `p`
    holds the 8 float vectors in _VECTORS order, `q` the quant entries in
    QNAMES order. On a CPU tensor: the plain version; on a CUDA tensor: the
    kernel (registered below)."""
    return swin_block_int8_plain(x, dict(zip(_VECTORS, p)), dict(zip(QNAMES, q)), num_heads, window_size, in8,
                                 out8, sm16).contiguous()


@swin_block_int8_op.register_kernel("cuda")
def _swin_block_int8_op_cuda(x, p, q, num_heads, window_size, in8, out8, sm16):
    return swin_block_int8_cuda(x, dict(zip(_VECTORS, p)), dict(zip(QNAMES, q)), num_heads, window_size, in8, out8,
                                sm16)


@swin_block_int8_op.register_fake
def _swin_block_int8_op_fake(x, p, q, num_heads, window_size, in8, out8, sm16):
    """The output's shape and dtype (int8 with out8, else the compute dtype),
    without the library. A CUDA input is checked with smem_bytes's copy, so
    that a shape the kernel does not take fails when the program is
    exported, not when it runs."""
    if x.dim() != 4:
        raise ValueError(f"swin_block_int8 takes (B, H, W, C), got {tuple(x.shape)}")
    if x.device.type == "cuda":
        check_int8_supported(x.shape[-1], num_heads, window_size, x.dtype, in8, sm16)
    return x.new_empty(x.shape, dtype=torch.int8 if out8 else compute_dtype(x.dtype, in8, sm16))


def swin_block_int8(x: torch.Tensor, p: Params, q: Params, num_heads: int = 2, window_size: int = 7,
                    in8: bool = False, out8: bool = False, sm16: bool = False,
                    impl: Optional[str] = None) -> torch.Tensor:
    """int8 SwinBlock on x (B, H, W, C) through swin_block_int8_op: the kernel
    for a CUDA tensor, the plain version for a CPU tensor. impl="plain"
    forces the plain version, to compare with the kernel on the card; the
    main path never passes impl. An input or output scale that in8 or out8
    needs must be in q; one that is not needed may be absent."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', not {impl!r}")
    if impl == "plain":
        return swin_block_int8_plain(x, p, q, num_heads, window_size, in8, out8, sm16)
    missing = [k for k, need in (("x_in_scale", in8), ("y_out_scale", out8)) if need and k not in q]
    if missing:
        raise ValueError(f"swin_block_int8 with in8={in8}, out8={out8} needs q{missing}")
    qs = [q[k] if k in q else torch.ones((), device=x.device) for k in QNAMES]  # an unused scale: 1
    return swin_block_int8_op(x, [p[k] for k in _VECTORS], qs, num_heads, window_size, in8, out8, sm16)
