"""Model introspection and profiling: the counterpart of the JAX package's utils/model_utils.py.

  get_flops(model, imgsz)         forward GFLOPs of one imgsz image: twice the
                                  multiply-adds of every convolution and
                                  product (torch.utils.flop_counter), the
                                  SwinBlock operators counted by formulas
                                  registered here
  model_info(model, imgsz)        {"layers", "parameters", "GFLOPs"}
  Profile                         a host-clock context timer that waits for
                                  the card at its ends
  autobatch(model, imgsz)         the largest power-of-two batch up to 256
                                  whose train micro-step fits in 60 % of the
                                  card's memory; check_train_batch_size is
                                  the trainer's entry (batch=-1)
  profile_layers(model, imgsz)    per layer: ms, parameters, output shape

Two deviations from the JAX package, whose numbers come from XLA:
  * Its get_flops is XLA's cost analysis, which counts elementwise work too
    and has no PyTorch counterpart. The port counts products only: 2 x MACs
    of each convolution (groups and strides as computed), each matmul and
    each SwinBlock, whose formula counts every token of its zero-padded 7x7
    windows (qkv 6C^2, out-projection 2C^2, fc1 8C^2, fc2 8C^2 and the
    window attention 4 * 49 * C per token), as the JAX graph computes them.
    That equals the 2 x MACs of the conv_general_dilated and dot_general
    equations of the JAX package's forward.
  * Its autobatch asks XLA's memory analysis of an eval forward; the port
    measures torch.cuda.max_memory_allocated over one train micro-step
    (forward, loss with TAL, backward) at each candidate batch, which is
    what a train step needs. The optimizer's state and the EMA (a few times
    the parameters) are not in that reading.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from ..ops import swin as _swin  # noqa: F401  registers the operators the formulas name
from ..ops import swin_int8 as _swin_int8  # noqa: F401

WS = 7  # the SwinBlock's window


def swin_window_flops(x_shape, window_size: int = WS) -> int:
    """2 x the multiply-adds of one SwinBlock on x (B, H, W, C): per token of
    the zero-padded windows 24 C^2 (qkv, out-projection, fc1, fc2) and 4 * 49
    * C of window attention (q k^T and P v over the window's tokens)."""
    b, h, w, c = x_shape
    n = window_size * window_size
    windows = b * -(-h // window_size) * -(-w // window_size)
    return windows * n * (24 * c * c + 4 * n * c)


@register_flop_formula(torch.ops.yolov8_cbam_swin.swin_block_fwd)
def _swin_block_fwd_flop(x_shape, p_shapes, num_heads, window_size, fast, *args, out_shape=None, **kwargs) -> int:
    return swin_window_flops(x_shape, window_size)


@register_flop_formula(torch.ops.yolov8_cbam_swin.swin_block_int8)
def _swin_block_int8_flop(x_shape, p_shapes, q_shapes, num_heads, window_size, *args, out_shape=None,
                          **kwargs) -> int:
    return swin_window_flops(x_shape, window_size)


def get_flops(model, imgsz: int = 640) -> float:
    """Forward GFLOPs of `model` (a DetectionModel) on one imgsz x imgsz
    image in eval mode, on the model's device and dtype: 2 x the
    multiply-adds of every convolution and product, as counted by
    torch.utils.flop_counter with the SwinBlock formulas registered here.
    A float model: a quantized one's int8 convs (torch._int_mm) are not
    counted."""
    x = torch.zeros(1, 3, imgsz, imgsz, device=model.device, dtype=model.dtype)
    was_training = model.training
    model.eval()
    counter = FlopCounterMode(display=False)
    try:
        with torch.inference_mode(), counter:
            model(x)
    finally:
        model.train(was_training)
    return counter.get_total_flops() / 1e9


def model_info(model, imgsz: int = 640, verbose: bool = True) -> Dict:
    """Layers (YAML rows), parameters and GFLOPs at imgsz (get_flops, rounded
    to 2 places as the JAX package rounds them)."""
    n_p = sum(p.numel() for p in model.parameters())
    n_l = len(model.model)
    gflops = get_flops(model, imgsz)
    info = {"layers": n_l, "parameters": n_p, "GFLOPs": round(gflops, 2)}
    if verbose:
        print(f"model summary: {n_l} layers, {n_p:,} parameters, {gflops:.1f} GFLOPs @ {imgsz}px")
    return info


class Profile:
    """Context timer on the host clock (JAX utils/model_utils.py Profile).
    With a CUDA `device` it synchronises the card on entry and exit, so that
    what the block enqueued is timed, not its launch."""

    def __init__(self, device=None):
        self.t = 0.0
        self.dt = 0.0
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.dt = time.perf_counter() - self.start
        self.t += self.dt

    def __str__(self):
        return f"{self.t:.4f}s"


def train_step_peak_bytes(model, imgsz: int, batch: int) -> int:
    """Peak bytes the card holds over one train micro-step of a copy of
    `model` at `batch` images of imgsz: forward in train mode on zero frames,
    the detection loss against one box per image (the TAL assigner, K2;
    a segmentation model's seg loss, the box's mask its overlap map; a pose
    model's pose loss, every keypoint visible at the box's centre; an OBB
    model's OBB loss, the box at angle 0: with one GT an image, its dense
    (B, G, A) assigner tensors are small; a classify model's cross-entropy
    against class 0), backward.
    torch.cuda.max_memory_allocated after a reset."""
    from .loss import detection_loss
    from .obb_loss import obb_loss
    from .pose_loss import pose_loss
    from .seg_loss import segmentation_loss

    dev = model.device
    m = copy.deepcopy(model).train()
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        x = torch.zeros(batch, 3, imgsz, imgsz, device=dev, dtype=m.dtype)
        cls = torch.zeros(batch, 1, device=dev)
        boxes = torch.tensor([0.5, 0.5, 0.25, 0.25], device=dev).repeat(batch, 1, 1)
        out, ones = m(x), torch.ones(batch, 1, device=dev)
        if m.task == "segment":
            seg_map = torch.zeros(batch, imgsz // 4, imgsz // 4, dtype=torch.int32, device=dev)
            seg_map[:, imgsz * 3 // 32:imgsz * 5 // 32, imgsz * 3 // 32:imgsz * 5 // 32] = 1
            total, _ = segmentation_loss(*out, cls, boxes, ones, seg_map, nc=m.nc, strides=m.strides)
        elif m.task == "pose":
            kpts = torch.tensor([0.5, 0.5, 1.0], device=dev).repeat(batch, 1, m.kpt_shape[0], 1)
            total, _ = pose_loss(*out, cls, boxes, ones, kpts, nc=m.nc, kpt_shape=m.kpt_shape, strides=m.strides)
        elif m.task == "classify":  # the logits' cross-entropy against class 0
            total = torch.nn.functional.cross_entropy(out.float(), torch.zeros(batch, dtype=torch.long, device=dev))
        elif m.task == "obb":
            rboxes = torch.tensor([0.5, 0.5, 0.25, 0.25, 0.0], device=dev).repeat(batch, 1, 1)
            total, _ = obb_loss(*out, cls, rboxes, ones, nc=m.nc, strides=m.strides)
        else:
            total, _ = detection_loss(out, cls, boxes, ones, nc=m.nc, strides=m.strides)
        total.backward()
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev)
    finally:
        del m
        torch.cuda.empty_cache()


def autobatch(model, imgsz: int = 640, fraction: float = 0.60, max_batch: int = 256,
              measure: Optional[Callable[[int], int]] = None, limit: Optional[int] = None) -> int:
    """The largest power-of-two batch, 1 to max_batch, whose train micro-step
    peaks at or under `fraction` of the card's memory (the JAX package's
    rule): candidates 2, 4, 8, ... each measured by `measure(batch)` (default
    train_step_peak_bytes) against `limit` (default the card's total
    memory), stopping at the first that exceeds the budget or runs out of
    memory. A model on the CPU raises: there is no card memory to fit."""
    if measure is None or limit is None:
        if model.device.type != "cuda":
            raise ValueError("autobatch measures the card's memory; the model is on the CPU: pass a batch")
        limit = limit if limit is not None else torch.cuda.get_device_properties(model.device).total_memory
        measure = measure or (lambda b: train_step_peak_bytes(model, imgsz, b))
    budget = limit * fraction
    best, b = 1, 2
    while b <= max_batch:
        try:
            if measure(b) > budget:
                break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            break
        best = b
        b *= 2
    return best


def check_train_batch_size(model, imgsz: int = 640, amp: bool = True, batch: float = -1,
                           max_num_obj: int = 1) -> int:
    """The trainer's entry for batch=-1 (JAX utils/model_utils.py
    check_train_batch_size): autobatch on the model as the trainer holds it
    (its compute dtype follows amp already)."""
    return autobatch(model, imgsz=imgsz)


def profile_layers(model, imgsz: int = 640, iters: int = 3, verbose: bool = True) -> List[Dict]:
    """Each layer of `model` in turn on one zero imgsz image, eval mode:
    {"i", "module", "ms", "params", "out"} with ms the mean over `iters`
    runs (CUDA events on the card, the host clock on the CPU), the layer's
    parameters and its output's shape (the first tensor of a tuple)."""
    cuda = model.device.type == "cuda"
    y: Dict[int, object] = {}
    out = torch.zeros(1, 3, imgsz, imgsz, device=model.device, dtype=model.dtype)
    out = out.contiguous(memory_format=torch.channels_last)
    rows = []
    was_training = model.training
    model.eval()
    txt = ori = model.texts(1)  # a World graph's text features ride along (DetectionModel.run_layer)
    try:
        with torch.inference_mode():
            for m in model.model:
                if m.f != -1:
                    out = y[m.f] if isinstance(m.f, int) else [out if j == -1 else y[j] for j in m.f]
                inp = out
                res, nxt = model.run_layer(m, inp, txt, ori)  # warm-up: kernels built, memory allocated
                if cuda:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(iters):
                        res, _ = model.run_layer(m, inp, txt, ori)
                    end.record()
                    torch.cuda.synchronize()
                    ms = start.elapsed_time(end) / iters
                else:
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        res, _ = model.run_layer(m, inp, txt, ori)
                    ms = (time.perf_counter() - t0) / iters * 1e3
                txt = nxt
                first = res[0] if isinstance(res, (tuple, list)) else res
                row = {"i": m.i, "module": m.type, "ms": ms, "params": sum(p.numel() for p in m.parameters()),
                       "out": tuple(first.shape)}
                rows.append(row)
                if verbose:
                    print(f"{m.i:>3} {m.type:<16} {ms:8.3f} ms {row['params']:>10,} {row['out']}")
                out = res
                if m.i in model.save:
                    y[m.i] = out
    finally:
        model.train(was_training)
    return rows
