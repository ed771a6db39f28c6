"""The SwinBlock forward and backward: hand-written CUDA kernels and their plain versions.

`swin_block(x, p, num_heads, window_size, fast)` applies the whole block to
x (B, H, W, C), H and W of any size: windows that run past the edge see zero
tokens, as the reference pads with zeros before the block and crops after it.
On a CUDA tensor it launches the kernel (csrc/swin_block_fwd.cu), which
replaces the TPU kernel `_swin_flat_kernel` / `fused_swin_block`; on a CPU
tensor it runs `swin_block_plain`, which repeats the kernel's arithmetic in
PyTorch. Both go through the PyTorch operator `yolov8_cbam_swin::swin_block_fwd`
(`swin_block_op`), which a torch.export program keeps as one node, so the
program launches the kernel when it runs on the card. `impl="plain"` forces
the plain version on the card, for comparison.

`p` holds the block's parameters in PyTorch layout:
  ln1_w, ln1_b, ln2_w, ln2_b  (C,)      LayerNorm scale and shift, fp32
  wqkv (3C, C), bqkv (3C,)              packed in-projection, rows [q; k; v]
  wout (C, C),  bout (C,)               out-projection
  w1 (4C, C),   b1 (4C,)                MLP fc1
  w2 (C, 4C),   b2 (C,)                 MLP fc2
The four matrices are used in x's dtype, the vectors in fp32.

Training goes through `swin_block_train`, an autograd Function: its forward
runs the block in exact mode (fast=False) and keeps only x and the
parameters; its backward, `swin_block_bwd`, recomputes the forward and
returns dx and fp32 parameter grads. On a CUDA tensor that is the kernel
csrc/swin_block_bwd.cu, which replaces the TPU kernel
`_swin_flat_bwd_kernel` of `fused_swin_block_ad`; on a CPU tensor it is
`swin_block_bwd_plain`, which repeats the kernel's roundings.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
VECTORS = ("ln1_w", "ln1_b", "bqkv", "bout", "ln2_w", "ln2_b", "b1", "b2")
MATRICES = ("wqkv", "wout", "w1", "w2")
PKEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wout", "bout", "ln2_w", "ln2_b", "w1", "b1", "w2", "b2")
LN_EPS = 1e-5
MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _to_windows(t: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> zero-padded windows (B * nH * nW, ws * ws, C)."""
    b, h, w, c = t.shape
    t = F.pad(t, (0, 0, 0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws))
    hp, wp = t.shape[1], t.shape[2]
    return t.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _from_windows(t: torch.Tensor, b: int, h: int, w: int, ws: int) -> torch.Tensor:
    """Inverse of _to_windows, cropped to (B, H, W, C)."""
    nh, nw, c = -(-h // ws), -(-w // ws), t.shape[-1]
    t = t.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, nh * ws, nw * ws, c)
    return t[:, :h, :w, :]


def _ln_stats(x32: torch.Tensor):
    """LayerNorm over the last dim without its affine: (normalised x, 1 / std)."""
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x32 - mean) ** 2).mean(-1, keepdim=True) + LN_EPS)
    return (x32 - mean) * rstd, rstd


def swin_block_plain(x: torch.Tensor, p: Params, num_heads: int = 2, window_size: int = 7,
                     fast: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch. Products take operands rounded to
    x's dtype and run in fp32; qkv, the probabilities, each head's output,
    the LN2 output and the MLP hidden are rounded to x's dtype; the residual
    stream is fp32. With fast=True and bf16, the LN1 affine and the tanh
    GELU run in bf16; otherwise the affine is fp32 and the GELU exact."""
    dt = x.dtype
    bf16_fast = fast and dt == torch.bfloat16

    def r(t):  # round to the I/O dtype, continue in fp32
        return t.to(dt).float()

    b, h, w, c = x.shape
    hd = c // num_heads
    yhat, _ = _ln_stats(_to_windows(x, window_size).float())
    if bf16_fast:
        xn32 = (yhat.to(dt) * p["ln1_w"].to(dt) + p["ln1_b"].to(dt)).float()
    else:
        xn32 = yhat * p["ln1_w"].float() + p["ln1_b"].float()

    def linear(a, wname, bname):
        return r(a) @ r(p[wname]).t() + p[bname].float()

    n, l, _ = xn32.shape
    qkv = r(linear(xn32, "wqkv", "bqkv"))
    q, k, v = (t.reshape(n, l, num_heads, hd).transpose(1, 2) for t in qkv.split(c, dim=-1))
    attn = r(torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / hd**0.5), dim=-1))
    o = r(attn @ v).transpose(1, 2).reshape(n, l, c)
    y1 = xn32 + linear(o, "wout", "bout")
    y1n = r(F.layer_norm(y1, (c,), p["ln2_w"].float(), p["ln2_b"].float(), LN_EPS))
    pre = linear(y1n, "w1", "b1")
    if bf16_fast:
        pb = pre.to(dt)
        hid = 0.5 * pb * (1.0 + torch.tanh(0.7978845608 * (pb + 0.044715 * pb * pb * pb)))
    else:
        hid = F.gelu(pre)
    y = y1 + linear(hid, "w2", "b2")
    return _from_windows(y.to(dt), b, h, w, window_size)


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library, once per process."""
    from .cuda_build import build

    lib = ctypes.CDLL(str(build("swin_block_fwd", ("swin_block_fwd.cu",))))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swin_block_fwd.argtypes = [i32, ptr, ptr, i32, i32, i32, i32, i32, i32] + [ptr] * 14
    lib.swin_block_fwd.restype = i32
    lib.swin_block_fwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.swin_block_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.swin_block_fwd_scratch_bytes.argtypes = [i32] * 6
    lib.swin_block_fwd_scratch_bytes.restype = ctypes.c_size_t
    return lib


def _ring_bytes(bn: int, a_streams: bool) -> int:
    """Bytes of the cp.async ring of csrc/swin_mma.cuh (`ring_bytes`): 4
    stages of 32-deep bf16 tiles, rows padded by 8 (a 64-row A tile when A
    streams, a bn-row weight tile)."""
    return 2 * 4 * ((64 if a_streams else 0) + bn) * 40


def _narrow_fwd_smem_bytes(c: int, num_heads: int, dtype: torch.dtype) -> int:
    """Shared memory of the layouts that keep the whole window resident. bf16:
    the fp32 residual stream (49 x C), the 9C fp32 biases, the bf16 LN output
    (64 x C+8), one head's q, k, v (3 x 64 x hd+8; the 64 x 136 MLP hidden
    chunk later) and the ring (4 stages of 128 x 32 weight tiles). fp32: two
    49 x C buffers, the 49x49 probabilities, a 64x33 weight tile and one
    head's q|k|v or hidden chunk."""
    hd = c // num_heads
    if dtype == torch.bfloat16:
        return (4 * 49 * c + 4 * 9 * c + 2 * 64 * (c + 8) + 2 * max(3 * 64 * (hd + 8), 64 * 136)
                + _ring_bytes(128, False))
    return 4 * (2 * 49 * c + 49 * 49 + 64 * 33 + 49 * max(3 * hd + 1, 128))


def fwd_is_wide(c: int, num_heads: int, dtype: torch.dtype) -> bool:
    """Whether the forward kernel takes its wide layout at this width: the one
    for windows whose resident layout exceeds a block's shared memory (bf16
    and fp32 from C=384 with 2 heads)."""
    return _narrow_fwd_smem_bytes(c, num_heads, dtype) > MAX_SMEM


def fwd_smem_bytes(c: int, num_heads: int, dtype: torch.dtype) -> int:
    """Shared memory of one block of the forward kernel, a copy of smem_bytes
    in csrc/swin_block_fwd.cu for checks without the library (on the card
    the library's own number is used). The wide layout keeps the fp32
    residual stream, the ring (4 stages of a 64-row A tile and a 64-row
    weight tile, 32 deep) and, in bf16, 64-wide q and k slices with the fp32
    scores (later the 64 x 136 MLP hidden chunk); in fp32 the probabilities,
    a weight tile and a 49 x 128 hidden chunk."""
    if not fwd_is_wide(c, num_heads, dtype):
        return _narrow_fwd_smem_bytes(c, num_heads, dtype)
    if dtype == torch.bfloat16:
        attn = max(2 * 2 * 64 * 72 + 4 * 49 * 49, 2 * 64 * 136)
        return 4 * 49 * c + 2 * 4 * (64 + 64) * 40 + -(-attn // 16) * 16
    return 4 * (49 * c + 49 * 49 + 64 * 33 + 49 * 128)


def check_supported(c: int, num_heads: int, window_size: int, dtype: torch.dtype,
                    smem: Optional[Callable[[], int]] = None) -> None:
    """Raise ValueError for a shape or dtype the kernel does not take. `smem`
    returns the block's shared memory as the built library reports it, and
    is called once the other checks pass; without it, fwd_smem_bytes's copy."""
    if dtype not in _DTYPES:
        raise ValueError(f"swin_block kernel takes float32 or bfloat16, not {dtype}")
    if window_size != 7:
        raise ValueError(f"swin_block kernel is built for 7x7 windows, not {window_size}")
    if c % 32 or c % num_heads:
        raise ValueError(f"swin_block kernel needs C % 32 == 0 and C % heads == 0 (C={c}, heads={num_heads})")
    if dtype == torch.bfloat16 and (c // num_heads) % 16:
        raise ValueError(f"swin_block kernel needs a head dim that is a multiple of 16 in bfloat16 (the tensor-core "
                         f"tiles), not {c // num_heads}")
    smem = fwd_smem_bytes(c, num_heads, dtype) if smem is None else smem()
    if smem > MAX_SMEM:
        raise ValueError(f"swin_block kernel needs {smem} B of shared memory at C={c}, heads={num_heads}; "
                         f"the limit is {MAX_SMEM}")


def swin_block_cuda(x: torch.Tensor, p: Params, num_heads: int = 2, window_size: int = 7,
                    fast: bool = True) -> torch.Tensor:
    """Launch the fused SwinBlock kernel on x (B, H, W, C), a CUDA tensor.
    Raises on anything the kernel does not take and on a failed launch."""
    if not x.is_cuda:
        raise ValueError("swin_block_cuda needs a CUDA tensor")
    if x.dim() != 4:
        raise ValueError(f"swin_block takes (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    check_supported(c, num_heads, window_size, x.dtype,
                    lambda: _lib().swin_block_fwd_smem_bytes(_DTYPES[x.dtype], c, num_heads))
    lib = _lib()
    x = _aligned(x.contiguous())
    args = _cast_params(p, c, x.device, x.dtype)
    y = torch.empty_like(x)
    # the wide layout's per-window LN outputs (bf16) or attention buffers (fp32)
    nbytes = lib.swin_block_fwd_scratch_bytes(_DTYPES[x.dtype], b, h, w, c, num_heads)
    scratch = torch.empty(nbytes, device=x.device, dtype=torch.uint8) if nbytes else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.swin_block_fwd(
            _DTYPES[x.dtype], x.data_ptr(), y.data_ptr(), b, h, w, c, num_heads, int(fast),
            *(args[k].data_ptr() for k in PKEYS),
            None if scratch is None else scratch.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"swin_block_fwd launch failed with CUDA error {rc}")
    swin_block_cuda.launches += 1
    swin_block_cuda.exact_launches += not fast
    return y


swin_block_cuda.launches = 0  # kernel launches since the last reset
swin_block_cuda.exact_launches = 0  # of those, launches in exact mode (fast=False: the train path)


@torch.library.custom_op("yolov8_cbam_swin::swin_block_fwd", mutates_args=(), device_types="cpu")
def swin_block_op(x: torch.Tensor, params: List[torch.Tensor], num_heads: int, window_size: int,
                  fast: bool) -> torch.Tensor:
    """The SwinBlock forward as a PyTorch operator, so that torch.export keeps
    it as one node of the graph and a loaded program launches the kernel.
    `params` are the 12 parameters in PKEYS order. On a CPU tensor: the plain
    version; on a CUDA tensor: the kernel (registered below)."""
    return swin_block_plain(x, dict(zip(PKEYS, params)), num_heads, window_size, fast).contiguous()


@swin_block_op.register_kernel("cuda")
def _swin_block_op_cuda(x, params, num_heads, window_size, fast):
    return swin_block_cuda(x, dict(zip(PKEYS, params)), num_heads, window_size, fast)


@swin_block_op.register_fake
def _swin_block_op_fake(x, params, num_heads, window_size, fast):
    """The output's shape and dtype, without the library. A CUDA input is
    checked with fwd_smem_bytes's copy, so that a shape the kernel does not
    take fails when the program is exported, not when it runs."""
    if x.dim() != 4:
        raise ValueError(f"swin_block takes (B, H, W, C), got {tuple(x.shape)}")
    if x.device.type == "cuda":
        check_supported(x.shape[-1], num_heads, window_size, x.dtype)
    return x.new_empty(x.shape)


def swin_block(x: torch.Tensor, p: Params, num_heads: int = 2, window_size: int = 7, fast: bool = True,
               impl: Optional[str] = None) -> torch.Tensor:
    """SwinBlock forward on x (B, H, W, C) through swin_block_op: the kernel
    for a CUDA tensor, the plain version for a CPU tensor. impl="plain"
    forces the plain version, to compare with the kernel on the card; the
    main path never passes impl."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', not {impl!r}")
    if impl == "plain":
        return swin_block_plain(x, p, num_heads, window_size, fast)
    return swin_block_op(x, [p[k] for k in PKEYS], num_heads, window_size, fast)


# ---------------------------------------------------------------------------
# Backward (train path)
# ---------------------------------------------------------------------------


def _ln_bwd(dz, yhat, rstd, scale):
    """Grad of z = yhat * scale + bias w.r.t. the LN input, and the scale and
    bias grads summed over all tokens."""
    dyhat = dz * scale
    dx = rstd * (dyhat - dyhat.mean(-1, keepdim=True) - yhat * (dyhat * yhat).mean(-1, keepdim=True))
    return dx, (dz * yhat).sum((0, 1)), dz.sum((0, 1))


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx [x * Phi(x)] = Phi(x) + x * phi(x), the exact GELU."""
    return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) + x * (torch.exp(-0.5 * x * x) * 0.3989422804014327)


def swin_block_bwd_plain(x: torch.Tensor, g: torch.Tensor, p: Params, num_heads: int = 2,
                         window_size: int = 7):
    """The backward kernel's arithmetic in PyTorch: recompute the exact
    forward, then dx (x's dtype) and the 12 parameter grads (fp32, PyTorch
    layout), with xn, qkv, the probabilities, head outputs, y1n, h, gh, dpre,
    dout, do, ds and dqkv rounded to x's dtype and every sum in fp32. Windows
    past the edge hold zero tokens with a zero grad, as the reference pads."""
    dt = x.dtype

    def r(t):  # round to the I/O dtype, continue in fp32
        return t.to(dt).float()

    b, h, w, c = x.shape
    ws, hd = window_size, c // num_heads
    scale = 1.0 / hd**0.5
    xw = _to_windows(x, ws).float()
    gw = r(_to_windows(g.to(dt), ws).float())
    n, l, _ = xw.shape
    wm = {k: r(p[k].float()) for k in MATRICES}
    vec = {k: p[k].float() for k in VECTORS}

    def heads(t):
        return t.reshape(n, l, num_heads, hd).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(n, l, c)

    # forward recompute, exact mode
    yhat1, rstd1 = _ln_stats(xw)
    xn32 = yhat1 * vec["ln1_w"] + vec["ln1_b"]
    xn = r(xn32)
    qkv = r(xn @ wm["wqkv"].t() + vec["bqkv"])
    q, k, v = (heads(t) for t in qkv.split(c, -1))
    a32 = torch.softmax((q @ k.transpose(-1, -2)) * scale, -1)
    a = r(a32)
    o = r(merge(a @ v))
    y1 = xn32 + (o @ wm["wout"].t() + vec["bout"])
    yhat2, rstd2 = _ln_stats(y1)
    y1n = r(yhat2 * vec["ln2_w"] + vec["ln2_b"])
    pre = y1n @ wm["w1"].t() + vec["b1"]
    hid = r(F.gelu(pre))

    # grads
    dpre = (gw @ wm["w2"]) * _gelu_grad(pre)
    dpre_b = r(dpre)
    dy1_ln, dln2_w, dln2_b = _ln_bwd(dpre_b @ wm["w1"], yhat2, rstd2, vec["ln2_w"])
    dy1 = gw + dy1_ln
    dout = r(dy1)
    do = heads(r(dout @ wm["wout"]))
    dv = a.transpose(-1, -2) @ do
    da = do @ v.transpose(-1, -2)
    ds = r(a32 * (da - (da * a32).sum(-1, keepdim=True)))
    dqkv = torch.cat([merge((ds @ k) * scale), merge((ds.transpose(-1, -2) @ q) * scale), merge(dv)], -1)
    dqkv_b = r(dqkv)
    dxw, dln1_w, dln1_b = _ln_bwd(dy1 + dqkv_b @ wm["wqkv"], yhat1, rstd1, vec["ln1_w"])

    def tok(t):
        return t.reshape(-1, t.shape[-1])

    grads = {
        "ln1_w": dln1_w, "ln1_b": dln1_b,
        "wqkv": tok(dqkv_b).t() @ tok(xn), "bqkv": tok(dqkv).sum(0),
        "wout": tok(dout).t() @ tok(o), "bout": tok(dy1).sum(0),
        "ln2_w": dln2_w, "ln2_b": dln2_b,
        "w1": tok(dpre_b).t() @ tok(y1n), "b1": tok(dpre).sum(0),
        "w2": tok(gw).t() @ tok(hid), "b2": tok(gw).sum(0),
    }
    return _from_windows(dxw.to(dt), b, h, w, ws).contiguous(), grads


def bwd_smem_bytes(c: int, num_heads: int, dtype: torch.dtype) -> int:
    """Shared memory of one block of the backward window kernel, a copy of
    smem_bytes in csrc/swin_block_bwd.cu for checks without the library (on
    the card the library's own number is used): LN1 and LN2 1/std (100
    floats), then the larger of the product tiles (bf16: the ring, both
    operands streaming; fp32: two 64x33 tiles) and the attention's scratch
    (a slice of up to 128 of a head's dims of q, k, v and do at 49 x
    slice+1, and two 49x49 planes, fp32)."""
    hd = min(c // num_heads, 128)
    tiles = _ring_bytes(128, True) // 4 if dtype == torch.bfloat16 else 2 * 64 * 33
    return 4 * (100 + max(tiles, 4 * 49 * (hd + 1) + 2 * 49 * 49))


def check_bwd_supported(c: int, num_heads: int, window_size: int, dtype: torch.dtype,
                        smem: Optional[Callable[[], int]] = None) -> None:
    """Raise ValueError for a shape or dtype the backward kernel does not
    take. `smem` returns the window kernel's shared memory as the built
    library reports it, and is called once the other checks pass; without
    it, bwd_smem_bytes's copy."""
    if dtype not in _DTYPES:
        raise ValueError(f"swin_block_bwd kernel takes float32 or bfloat16, not {dtype}")
    if window_size != 7:
        raise ValueError(f"swin_block_bwd kernel is built for 7x7 windows, not {window_size}")
    if c % 32 or c % num_heads:
        raise ValueError(f"swin_block_bwd kernel needs C % 32 == 0 and C % heads == 0 (C={c}, heads={num_heads})")
    smem = bwd_smem_bytes(c, num_heads, dtype) if smem is None else smem()
    if smem > MAX_SMEM:
        raise ValueError(f"swin_block_bwd kernel needs {smem} B of shared memory at C={c}, heads={num_heads}; "
                         f"the limit is {MAX_SMEM}")


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """Build (at first use) and load the backward kernel's library, once per process."""
    from .cuda_build import build

    lib = ctypes.CDLL(str(build("swin_block_bwd", ("swin_block_bwd.cu",))))
    ptr, i32, size_p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)
    lib.swin_block_bwd_workspace.argtypes = [i32] * 5 + [size_p, size_p]
    lib.swin_block_bwd_workspace.restype = None
    lib.swin_block_bwd.argtypes = [i32, ptr, ptr, ptr] + [i32] * 5 + [ptr] * 12 + [ptr] * 4
    lib.swin_block_bwd.restype = i32
    lib.swin_block_bwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.swin_block_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _cast_params(p: Params, c: int, device, dtype) -> Params:
    """Vectors to fp32, matrices to the I/O dtype, all contiguous on `device`;
    checks the matrix shapes."""
    args = {k: p[k].to(device=device, dtype=torch.float32).contiguous() for k in VECTORS}
    args.update({k: p[k].to(device=device, dtype=dtype).contiguous() for k in MATRICES})
    for k, shape in (("wqkv", (3 * c, c)), ("wout", (c, c)), ("w1", (4 * c, c)), ("w2", (c, 4 * c))):
        if tuple(args[k].shape) != shape:
            raise ValueError(f"swin_block {k} has shape {tuple(args[k].shape)}, expected {shape}")
        args[k] = _aligned(args[k])
    return args


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it in a fresh allocation if it does not start on 16
    bytes: the kernels move activations and weights in 16-byte pieces."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def swin_block_bwd_cuda(x: torch.Tensor, g: torch.Tensor, p: Params, num_heads: int = 2, window_size: int = 7):
    """Launch the backward kernel on x and the incoming grad g (B, H, W, C),
    CUDA tensors -> (dx, {name: fp32 grad}). Raises on anything the kernel
    does not take and on a failed launch."""
    if not x.is_cuda:
        raise ValueError("swin_block_bwd_cuda needs a CUDA tensor")
    if x.dim() != 4 or g.shape != x.shape:
        raise ValueError(f"swin_block_bwd takes x and g of one shape (B, H, W, C), got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    b, h, w, c = x.shape
    check_bwd_supported(c, num_heads, window_size, x.dtype,
                        lambda: _bwd_lib().swin_block_bwd_smem_bytes(_DTYPES[x.dtype], c, num_heads))
    lib = _bwd_lib()
    x = x.contiguous()
    g = _aligned(g.to(x.dtype).contiguous())
    args = _cast_params(p, c, x.device, x.dtype)
    t_el, f_el = ctypes.c_size_t(), ctypes.c_size_t()
    lib.swin_block_bwd_workspace(b, h, w, c, num_heads, ctypes.byref(t_el), ctypes.byref(f_el))
    tws = torch.empty(t_el.value, device=x.device, dtype=x.dtype)
    fws = torch.empty(f_el.value, device=x.device, dtype=torch.float32)
    gout = torch.empty(12 * c * c + 13 * c, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.swin_block_bwd(
            _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), dx.data_ptr(), b, h, w, c, num_heads,
            *(args[k].data_ptr() for k in PKEYS), tws.data_ptr(), fws.data_ptr(), gout.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"swin_block_bwd launch failed with CUDA error {rc}")
    swin_block_bwd_cuda.launches += 1
    shapes = {"wqkv": (3 * c, c), "wout": (c, c), "w1": (4 * c, c), "w2": (c, 4 * c), "ln1_w": (c,),
              "ln1_b": (c,), "bqkv": (3 * c,), "bout": (c,), "ln2_w": (c,), "ln2_b": (c,), "b1": (4 * c,),
              "b2": (c,)}  # in the kernel's output order
    grads, off = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        grads[k] = gout[off:off + n].view(shape)
        off += n
    return dx, grads


swin_block_bwd_cuda.launches = 0  # kernel launches since the last reset


def swin_block_bwd(x: torch.Tensor, g: torch.Tensor, p: Params, num_heads: int = 2, window_size: int = 7,
                   impl: Optional[str] = None):
    """SwinBlock backward: the kernel for a CUDA tensor, the plain version for
    a CPU tensor or with impl="plain"."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', not {impl!r}")
    if impl == "plain" or x.device.type == "cpu":
        return swin_block_bwd_plain(x, g, p, num_heads, window_size)
    return swin_block_bwd_cuda(x, g, p, num_heads, window_size)


class _SwinBlockFn(torch.autograd.Function):
    """Forward in exact mode (fast=False); backward by swin_block_bwd. Saves
    only x and the parameters: the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, x, num_heads, window_size, impl, *params):
        p = dict(zip(PKEYS, params))
        ctx.save_for_backward(x, *params)
        ctx.cfg = (num_heads, window_size, impl)
        return swin_block(x, p, num_heads, window_size, fast=False, impl=impl)

    @staticmethod
    def backward(ctx, gy):
        x, *params = ctx.saved_tensors
        num_heads, window_size, impl = ctx.cfg
        dx, grads = swin_block_bwd(x, gy, dict(zip(PKEYS, params)), num_heads, window_size, impl)
        return (dx, None, None, None, *(grads[k].to(prm.dtype) for k, prm in zip(PKEYS, params)))


def swin_block_train(x: torch.Tensor, p: Params, num_heads: int = 2, window_size: int = 7,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Differentiable SwinBlock on x (B, H, W, C). The parameters are taken
    as given (fp32 masters in training): the matrices are cast to x's dtype
    inside, and the grads come back in each parameter's dtype."""
    return _SwinBlockFn.apply(x, num_heads, window_size, impl, *(p[k] for k in PKEYS))
