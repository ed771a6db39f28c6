"""Drive the PyTorch port on one NVIDIA card and check every kernel it runs.

    python3 chip_smoke.py

Phases, one JSON line each; the script exits non-zero if any phase fails:
  build   compile the four CUDA kernels from csrc/ (nvcc, sm_90a), one nvcc
          each, all started together
  kernel  each kernel vs its plain PyTorch version, fp32 (TF32 off) and bf16,
          with times per launch: K1 swin_block_fwd in its fast (predict) and
          exact (train) modes at the flagship's Swin shapes; K3 swin_block_bwd,
          dx and the 12 parameter grads, at (16, 40, 40, 256) and at the
          padded (4, 20, 20, 256); K2 tal_assign at B=16, A=8400 with G=128,
          nc=1 and with G=32, nc=80; K4 swin_block_int8 at (8, 40, 40, 256)
          and (32, 40, 40, 256), bf16, with int8 I/O (in8, out8), with bf16
          I/O and with the bf16 softmax (sm16, K4v)
  slice   YOLO("yolov8s-cbam-swin.yaml").predict on 8 synthetic 480x640
          frames at 640 px, bf16, seeded random weights: the predict path,
          with its kernel launches counted; then the same model with the Swin
          blocks forced to the plain version (bf16), and an fp32 model the same way
  train   the detect train step of the same model at 640 px, bf16 over fp32
          master weights, batch 16, nbs 64 (accumulate 4), SGD, max_gt 32,
          device augmentation on: 8 micro-steps on seeded synthetic batches,
          the train path, with its kernel launches counted per step; then one
          more micro-step from one state and batch, with the kernels and with
          the plain versions of K1, K3 and K2, in bf16 and in fp32 (TF32 off)
  int8    the int8 PTQ path: the same graph with fp32 weights, bf16
          compute, BN-folded, quantize_model on two seeded uint8 batches of
          8 frames at 640 px (the JAX package's bench.py bench_infer), then
          YOLO.predict on the 8 frames of the slice phase, with the kernel
          launches of calibration and of predict counted; the int8 model
          with K4 vs with its plain version; each int8 SwinBlock vs the
          float block on the same input (the JAX package's oracle bounds),
          and the int8 vs the float model at each Swin layer; int8 forward
          and predict img/s at batch 32
  speed   predict img/s at batch 32, 640 px, bf16, BN-folded (forward alone
          and end to end) and train img/s at batch 16, with and without the
          device augmentation
  profile device time by kernel over batch-32 forwards, bf16 and int8, and
          over one accumulation cycle of the train step (torch.profiler)
Then the card's name and power limit, the {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Without CUDA it prints no result and exits 2.
"""

from __future__ import annotations

import copy
import itertools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

PKG = "improving_yolov8_cbam_swinblock_tpu_torch"
TPU = "improving_yolov8_cbam_swinblock_tpu"
SOURCES = {"swin_block_fwd": f"{PKG}/csrc/swin_block_fwd.cu", "swin_block_bwd": f"{PKG}/csrc/swin_block_bwd.cu",
           "tal_assign": f"{PKG}/csrc/tal_assign.cu", "swin_block_int8": f"{PKG}/csrc/swin_block_int8.cu",
           "swin_block_int8_sm16": f"{PKG}/csrc/swin_block_int8.cu"}
REPLACES = {"swin_block_fwd": f"{TPU}/ops/pallas/swin_kernel.py:52",
            "swin_block_bwd": f"{TPU}/ops/pallas/swin_kernel.py:210",
            "tal_assign": f"{TPU}/ops/pallas/tal_kernel.py:51",
            "swin_block_int8": f"{TPU}/ops/pallas/swin_kernel.py:469",
            "swin_block_int8_sm16": "tools/bench_swin_variants.py:53"}
# the H100 SXM, NVIDIA's data sheet: dense peak FLOP/s by operand type (bf16 on
# the tensor cores, fp32 with TF32 off on the CUDA cores) and HBM bytes/s
CARD = "H100 80GB HBM3"
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
PEAK_BYTES = 3.35e12
SEED = 0
# the train path: bench.py's bench_train settings at batch 16 (SGD pinned), nbs 64
TRAIN = {"batch": 16, "nbs": 64, "epochs": 100, "imgsz": 640, "optimizer": "SGD", "amp": True, "seed": SEED}
TRAIN_NB, MAX_GT, TRAIN_STEPS = 100, 32, 8
# one train micro-step with the kernels vs with their plain versions, from one
# state and batch. A SwinBlock's 12 grads are compared as one vector: the L2
# norm of the difference over the L2 norm of the reference, so that a grad
# that is zero in exact arithmetic and only rounding noise (layer 16's fc2
# bias, whose output feeds a 1x1 conv and a batch-statistics BN) weighs by
# its size. fp32 (TF32 off): loss items within FP32_ITEM_RTOL relative, each
# block's grads within FP32_GRAD_RTOL (layer 7's grads come back through ~20
# layers whose batch-statistics BNs amplify fp32 roundings). bf16: loss items
# within BF16_ITEM_RTOL; each block's grads are held to the fp32 plain step's,
# and with the kernels they may be at most BF16_GRAD_SLACK times as far from
# them as the plain bf16 step's (bf16 roundings through the backward of the
# layers above move them by more than the kernels' own differences do)
FP32_ITEM_RTOL, FP32_GRAD_RTOL = 1e-4, 5e-3
BF16_ITEM_RTOL, BF16_GRAD_SLACK = 2e-2, 1.5
# K3 vs its plain version, relative to the largest magnitude of what is compared
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# operations of one (GT, anchor) pair in the assigner (csrc/tal_assign.cu pair()):
# candidate gate 8, widths and heights 6, intersection 9, union 5, IoU 1,
# enclosing box 6 + 4, centre distance 10, aspect term 3 + 3, CIoU 4, clip
# and gate 2, overlap^6 3, sqrt(score) * 3; min, max, compare, div and sqrt count one each
TAL_PAIR_FLOP = 67
# K4 vs its plain version: with int8 output at most INT8_LEVELS levels of the
# output scale and at most INT8_SHARE of the outputs off; with float output
# within INT8_RTOL of the largest magnitude. The integer sums are exact, but
# fp32 sums in another order (LN statistics, attention dots) may move a value
# across a quantization boundary, and the block's later products carry it.
INT8_LEVELS, INT8_SHARE, INT8_RTOL = 3, 1e-2, 3e-2
# the int8 model with K4 vs with its plain version (layers 7 and 16, raw
# Detect maps, decoded channels): such boundary moves also pass through the
# int8 convs after each block: max |K4 - plain| <= INT8_MODEL_RTOL * max |plain|
INT8_MODEL_RTOL = 5e-2
# each SwinBlock of the int8 model, int8 vs float on the input it receives
# there: the JAX package's oracle bounds for the int8 block
# (tests/test_pallas_swin.py:130-131): mean |int8 - float| under 0.05 of mean
# |float|, max under 0.25 of max |float|. The same measure between the whole
# int8 and float models at each Swin layer adds the int8 convs upstream; it
# is reported beside it
ORACLE_MEAN, ORACLE_MAX = 0.05, 0.25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_card(name: str) -> None:
    if CARD not in name:
        raise RuntimeError(f"peak rates are known for the {CARD} only, not for {name}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def elt(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def bound(flops: float, nbytes: float, dtype):
    """(ms, "operations" or "bytes"): the larger of the two least times."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def swin_bound(shape, dtype):
    """(ms, "operations" or "bytes"): the least time the card could take for
    the SwinBlock forward on x of `shape`. Operations: per real token
    2*C*C (q) + 2*C*2C (k, v) + 4*49*C (its attention row over the 49 keys
    of its window) + 2*C*C (out) + 16*C*C (MLP); a pad token's output is
    cropped and its k, v are one constant row, counted once. Bytes: x read
    and y written once, weights read once."""
    b, h, w, c = shape
    tokens = b * h * w
    flops = tokens * (24 * c * c + 4 * 49 * c) + (4 * c * c if h % 7 or w % 7 else 0)
    nbytes = 2 * tokens * c * elt(dtype) + 12 * c * c * elt(dtype) + 13 * c * 4
    return bound(flops, nbytes, dtype)


def swin_bwd_bound(shape, dtype):
    """(ms, "operations" or "bytes") for the SwinBlock backward on x and g of
    `shape`. Operations, per real token: the forward recomputed as far as the
    grads need it, 16*C*C (qkv, out, fc1; fc2's output is not needed) +
    4*49*C (scores, a.v); the dX products 24*C*C (dh = g W2, dy1n = dpre W1,
    do = dout Wout, dxn = dqkv Wqkv) + 8*49*C (dv, da, dq, dk); the dW
    products 24*C*C (the same four, over all tokens). Pad tokens are one
    constant row: their k, v (4*C*C), and their k, v grads' share of dWqkv
    and dxn (8*C*C), count once. Bytes: x and g read, dx written, weights
    read once in x's dtype; the 12*C*C + 13*C fp32 grads written once."""
    b, h, w, c = shape
    tokens = b * h * w
    flops = tokens * (64 * c * c + 12 * 49 * c) + (12 * c * c if h % 7 or w % 7 else 0)
    nbytes = (3 * tokens * c + 12 * c * c) * elt(dtype) + (12 * c * c + 13 * c) * 4
    return bound(flops, nbytes, dtype)


def swin_int8_bound(shape, x_dtype, y_dtype):
    """(ms, "operations" or "bytes") for the int8 SwinBlock on x of `shape`.
    Operations: per real token 24*C*C int8 operations (qkv 6, out 2, fc1 8,
    fc2 8) at the int8 peak plus 4*49*C bf16 FLOP of attention at the bf16
    peak; a pad token's k, v (4*C*C int8) are one constant row, counted
    once. Bytes: x read and y written once in their dtypes, the 12*C*C int8
    weights, their 12*C fp32 scales and the 13*C fp32 vectors read once."""
    b, h, w, c = shape
    tokens = b * h * w
    t_ops = ((tokens * 24 * c * c + (4 * c * c if h % 7 or w % 7 else 0)) / PEAK_FLOPS[torch.int8]
             + tokens * 4 * 49 * c / PEAK_FLOPS[torch.bfloat16])
    t_bytes = (tokens * c * (elt(x_dtype) + elt(y_dtype)) + 12 * c * c + 4 * 25 * c) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tal_bound(b, a, g, nc, ncls):
    """(ms, "operations" or "bytes") for the assigner: TAL_PAIR_FLOP per
    (image, GT, anchor) on the fp32 CUDA cores; inputs (scores, predicted
    boxes, anchors, GT labels, boxes and mask) read and outputs (labels,
    boxes, scores, fg, GT index) written once."""
    nbytes = 4 * (b * a * nc + 4 * b * a + 2 * a + 6 * b * g) + b * a * (4 + 16 + 4 * ncls + 1 + 4)
    return bound(TAL_PAIR_FLOP * b * g * a, nbytes, torch.float32)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-12)


def swin_params(c: int, rng, device, dtype):
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import MATRICES

    def r(*shape):
        return torch.tensor(rng.normal(0, 0.05, shape).astype(np.float32), device=device)

    p = {"ln1_w": 1 + 0.1 * r(c), "ln1_b": r(c), "wqkv": r(3 * c, c), "bqkv": r(3 * c), "wout": r(c, c),
         "bout": r(c), "ln2_w": 1 + 0.1 * r(c), "ln2_b": r(c), "w1": r(4 * c, c), "b1": r(4 * c),
         "w2": r(c, 4 * c), "b2": r(c)}
    p.update({k: p[k].to(dtype) for k in MATRICES})
    return p


def tal_inputs(b, g, nc, imgsz, device, seed):
    """Assigner inputs at the shapes of the train path: sigmoid scores,
    predicted xyxy boxes and GTs in pixels over the anchors of an imgsz
    image, 70 % of GT rows valid, plus a duplicated GT."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.anchors import make_anchors

    anc, st = make_anchors([(imgsz // s, imgsz // s) for s in (8, 16, 32)], (8, 16, 32))
    a = anc.shape[0]
    rng = np.random.default_rng(seed)
    scores = rng.random((b, a, nc)).astype(np.float32)
    cxy, wh = rng.uniform(10, imgsz - 10, (b, a, 2)), rng.uniform(4, imgsz / 2, (b, a, 2))
    pboxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    glab = rng.integers(0, nc, (b, g, 1)).astype(np.int32)
    gcxy, gwh = rng.uniform(12, imgsz - 12, (b, g, 2)), rng.uniform(8, imgsz / 2, (b, g, 2))
    gbox = np.concatenate([gcxy - gwh / 2, gcxy + gwh / 2], -1).astype(np.float32)
    gmask = (rng.random((b, g, 1)) < 0.7).astype(np.float32)
    gbox[1, 3], glab[1, 3], gmask[1, 3] = gbox[1, 2], glab[1, 2], gmask[1, 2]
    gbox = gbox * gmask

    def t(v):
        return torch.tensor(v, device=device)

    return t(scores), t(pboxes), (anc * st).to(device), t(glab), t(gbox), t(gmask)


def phase_build():
    """Build and load the four kernels' libraries, one nvcc each, in parallel."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin, swin_int8, tal

    t0 = time.perf_counter()
    loaders = {"swin_block_fwd": swin._lib, "swin_block_bwd": swin._bwd_lib, "tal_assign": tal._lib,
               "swin_block_int8": swin_int8._lib}
    with ThreadPoolExecutor(len(loaders)) as ex:
        libs = dict(zip(loaders, ex.map(lambda f: f(), loaders.values())))
    ptxas = {name: [ln.strip() for ln in (Path(lib._name).parent / "build.log").read_text().splitlines()
                    if "registers" in ln] for name, lib in libs.items()}
    return {"seconds": round(time.perf_counter() - t0, 3), "ptxas": ptxas}


def no_tf32(fn, *args):
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn(*args)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def phase_kernel(dev):
    """Each kernel vs its plain version, TF32 off."""
    fwd_ok, fwd = no_tf32(fwd_cases, dev)
    bwd_ok, bwd = no_tf32(bwd_cases, dev)
    tal_ok, tal = tal_cases(dev)
    int8_ok, int8 = int8_cases(dev)
    return fwd_ok and bwd_ok and tal_ok and int8_ok, {"swin_block_fwd": fwd, "swin_block_bwd": bwd,
                                                      "tal_assign": tal, "swin_block_int8": int8}


def fwd_cases(dev):
    """K1 at the flagship's Swin shapes, scale s and scale n, fast (predict)
    and exact (train): fp32 within 1e-3 absolute, bf16 within 3e-2 of the
    output's largest magnitude."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block

    rows, ok = [], True
    for shape, heads in (((8, 42, 42, 256), 2), ((8, 40, 40, 256), 2), ((8, 14, 14, 128), 2)):
        for dtype in (torch.float32, torch.bfloat16):
            for fast in (True, False):
                rng = np.random.default_rng(SEED)
                x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev).to(dtype)
                p = swin_params(shape[-1], rng, dev, dtype)
                y = swin_block(x, p, heads, fast=fast)
                torch.cuda.synchronize()
                ref = swin_block(x, p, heads, fast=fast, impl="plain")
                abs_err = (y.float() - ref.float()).abs().max().item()
                rerr = rel_err(y, ref)
                good = bool(torch.isfinite(y.float()).all()) and (
                    abs_err <= 1e-3 if dtype == torch.float32 else rerr <= 3e-2)
                ok &= good
                rows.append({
                    "shape": list(shape), "heads": heads, "dtype": str(dtype).split(".")[-1], "fast": fast,
                    "max_abs_err": abs_err, "max_rel_err": rerr, "ok": good,
                    "kernel_us": 1e3 * cuda_ms(lambda: swin_block(x, p, heads, fast=fast)),
                    "plain_us": 1e3 * cuda_ms(lambda: swin_block(x, p, heads, fast=fast, impl="plain"), iters=5),
                    "bound_us": 1e3 * swin_bound(shape, dtype)[0],
                })
    return ok, rows


def bwd_errors(got, ref):
    """{name: max |got - ref| / max |ref|} over dx and the 12 grads."""
    (dx, grads), (rdx, rgrads) = got, ref
    return {"dx": rel_err(dx, rdx), **{k: rel_err(grads[k], rgrads[k]) for k in rgrads}}


def bwd_cases(dev):
    """K3 vs swin_block_bwd_plain: dx and the 12 grads, each within
    BWD_RTOL of its largest magnitude. The parameters are fp32 masters, as
    the train path hands them; (4, 20, 20, 256) pads to 21 x 21."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block_bwd

    rows, ok = [], True
    for shape, heads in (((16, 40, 40, 256), 2), ((4, 20, 20, 256), 2)):
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(SEED + 1)
            x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev).to(dtype)
            g = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev).to(dtype)
            p = swin_params(shape[-1], rng, dev, torch.float32)
            got = swin_block_bwd(x, g, p, heads)
            torch.cuda.synchronize()
            errs = bwd_errors(got, swin_block_bwd(x, g, p, heads, impl="plain"))
            finite = all(bool(torch.isfinite(t).all()) for t in (got[0].float(), *got[1].values()))
            good = finite and max(errs.values()) <= BWD_RTOL[dtype]
            ok &= good
            rows.append({
                "shape": list(shape), "heads": heads, "dtype": str(dtype).split(".")[-1], "ok": good,
                "max_rel_err": max(errs.values()), "rel_err": errs,
                "kernel_us": 1e3 * cuda_ms(lambda: swin_block_bwd(x, g, p, heads), iters=5),
                "plain_us": 1e3 * cuda_ms(lambda: swin_block_bwd(x, g, p, heads, impl="plain"), iters=3),
                "bound_us": 1e3 * swin_bwd_bound(shape, dtype)[0],
            })
    return ok, rows


def tal_compare(got, ref) -> dict:
    """fg, GT index and labels exactly equal; boxes within 1e-4 absolute;
    scores within 1e-4 relative (atol 1e-6)."""
    boxes_err = (got.target_bboxes - ref.target_bboxes).abs().max().item()
    scores_err = ((got.target_scores - ref.target_scores).abs()
                  - 1e-4 * ref.target_scores.abs()).max().item()
    exact = all(torch.equal(getattr(got, k), getattr(ref, k)) for k in ("fg_mask", "target_gt_idx", "target_labels"))
    return {"exact_fg_idx_labels": exact, "boxes_max_abs_err": boxes_err,
            "scores_max_abs_err": (got.target_scores - ref.target_scores).abs().max().item(),
            "ok": exact and boxes_err <= 1e-4 and scores_err <= 1e-6 and bool(got.fg_mask.any())}


def tal_cases(dev):
    """K2 vs the plain assigner at the train path's shapes (640 px: A=8400)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    rows, ok = [], True
    for b, g, nc in ((16, 4 * MAX_GT, 1), (16, MAX_GT, 80)):
        args = tal_inputs(b, g, nc, 640, dev, SEED + g)
        got = task_aligned_assign(*args, topk=10, num_classes=nc)
        torch.cuda.synchronize()
        row = tal_compare(got, task_aligned_assign(*args, topk=10, num_classes=nc, impl="plain"))
        ok &= row["ok"]
        rows.append({
            "b": b, "g": g, "a": args[0].shape[1], "nc": nc, **row, "fg_anchors": int(got.fg_mask.sum()),
            "kernel_us": 1e3 * cuda_ms(lambda: task_aligned_assign(*args, topk=10, num_classes=nc)),
            "plain_us": 1e3 * cuda_ms(lambda: task_aligned_assign(*args, topk=10, num_classes=nc, impl="plain"),
                                      iters=5),
            "bound_us": 1e3 * tal_bound(b, args[0].shape[1], g, nc, nc)[0],
        })
    return ok, rows


def swin_quant(x, p, heads):
    """A block's quant entries as quantize_model builds them: per-output-channel
    int8 weights from the fp32 matrices, and activation scales from x's
    calibration |max| (the four product inputs, x, the float block's output)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin_int8 import QKEYS, QWEIGHTS, swin_gemm_absmax

    q = {}
    for k in QKEYS:
        w = p[QWEIGHTS[k]].float()
        ws = w.abs().amax(1).clamp(min=1e-12) / 127
        q.update({f"{k}_w_int8": torch.clamp(torch.round(w / ws[:, None]), -127, 127).to(torch.int8),
                  f"{k}_w_scale": ws})
    am = swin_gemm_absmax(x, p, heads)
    q.update({f"{k}_x_scale": am[k] / 127 for k in QKEYS})
    q["x_in_scale"] = x.float().abs().amax() / 127
    q["y_out_scale"] = swin_block(x, p, heads, impl="plain").float().abs().amax() / 127
    return q


def int8_compare(y, ref) -> dict:
    """K4 vs its plain version: int8 output within INT8_LEVELS levels and at
    most INT8_SHARE of the outputs off; float output within INT8_RTOL of the
    largest magnitude."""
    d = (y.float() - ref.float()).abs()
    out = {"max_abs_err": d.max().item(), "mean_abs_err": d.mean().item(), "share_off": (d > 0).float().mean().item()}
    if y.dtype == torch.int8:
        ok = out["max_abs_err"] <= INT8_LEVELS and out["share_off"] <= INT8_SHARE
    else:
        out["max_rel_err"] = rel_err(y, ref)
        ok = out["max_rel_err"] <= INT8_RTOL
    return {**out, "ok": bool(ok and torch.isfinite(y.float()).all())}


def int8_cases(dev):
    """K4 at the int8 path's Swin shapes, batch 8 (predict) and 32 (speed),
    bf16 compute: int8 I/O as the int8 path runs it, bf16 I/O, and the bf16
    softmax (sm16, K4v) with int8 I/O; fp32 weights quantized as
    quantize_model does, activation scales from the input."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin_int8 import q8, swin_block_int8

    rows, ok = [], True
    for b in (8, 32):
        shape = (b, 40, 40, 256)
        rng = np.random.default_rng(SEED + 3)
        x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev).to(torch.bfloat16)
        p = swin_params(256, rng, dev, torch.float32)
        q = swin_quant(x, p, 2)
        xq = q8(x.float(), q["x_in_scale"]).to(torch.int8)
        for mode, xin, kw in (("int8_io", xq, dict(in8=True, out8=True)), ("bf16_io", x, {}),
                              ("sm16_int8_io", xq, dict(in8=True, out8=True, sm16=True))):
            y = swin_block_int8(xin, p, q, 2, **kw)
            torch.cuda.synchronize()
            row = int8_compare(y, swin_block_int8(xin, p, q, 2, impl="plain", **kw))
            ok &= row["ok"]
            rows.append({
                "shape": list(shape), "mode": mode, "out_dtype": str(y.dtype).split(".")[-1], **row,
                "kernel_us": 1e3 * cuda_ms(lambda: swin_block_int8(xin, p, q, 2, **kw)),
                "plain_us": 1e3 * cuda_ms(lambda: swin_block_int8(xin, p, q, 2, impl="plain", **kw), iters=3),
                "bound_us": 1e3 * swin_int8_bound(shape, xin.dtype, y.dtype)[0],
            })
    return ok, rows


def swin_modules(model):
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import SwinBlock

    return [m for m in model.model if isinstance(m, SwinBlock)]


def letterboxed(frames, imgsz, dev, dtype):
    from improving_yolov8_cbam_swinblock_tpu_torch.data.augment import letterbox

    batch = torch.stack([letterbox(f, imgsz, device=dev)[0].flip(-1) for f in frames])
    return batch.permute(0, 3, 1, 2).to(dtype) / 255.0


def compare_forward(model, x, rtol):
    """The model with the kernel vs with the plain Swin version, each within
    max |kernel - plain| <= rtol * max |plain|: the output of each SwinBlock
    layer, each raw Detect map, and each channel of the decoded (B, 5, A)."""
    swins = swin_modules(model)
    outs = {}
    hooks = [m.register_forward_hook(lambda m, i, o: outs.setdefault(m.i, []).append(o)) for m in swins]
    try:
        with torch.inference_mode():
            out_k, maps_k = model(x)
            for m in swins:
                m.impl = "plain"
            out_p, maps_p = model(x)
    finally:
        for m in swins:
            m.impl = None
        for h in hooks:
            h.remove()
    errs = {
        "swin_layers": {i: rel_err(*o) for i, o in outs.items()},
        "detect_maps": [rel_err(a, b) for a, b in zip(maps_k, maps_p)],
        "decoded_channels": [rel_err(out_k[:, i], out_p[:, i]) for i in range(out_k.shape[1])],
    }
    worst = max([*errs["swin_layers"].values(), *errs["detect_maps"], *errs["decoded_channels"]])
    good = bool(torch.isfinite(out_k).all()) and len(outs) == len(swins) > 0 and worst <= rtol
    return good, errs, tuple(out_k.shape)


def counts() -> dict:
    """The kernels' launch counts (K1 total and in exact mode, K3, K2, K4 and of those with sm16)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block_bwd_cuda, swin_block_cuda
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin_int8 import swin_block_int8_cuda
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda

    return {"swin_block_fwd": swin_block_cuda.launches, "swin_block_fwd_exact": swin_block_cuda.exact_launches,
            "swin_block_bwd": swin_block_bwd_cuda.launches, "tal_assign": tal_assign_cuda.launches,
            "swin_block_int8": swin_block_int8_cuda.launches,
            "swin_block_int8_sm16": swin_block_int8_cuda.sm16_launches}


def reset_counts() -> None:
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block_bwd_cuda, swin_block_cuda
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin_int8 import swin_block_int8_cuda
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda

    swin_block_cuda.launches = swin_block_cuda.exact_launches = 0
    swin_block_bwd_cuda.launches = tal_assign_cuda.launches = 0
    swin_block_int8_cuda.launches = swin_block_int8_cuda.sm16_launches = 0


def slice_frames():
    """The 8 synthetic 480x640 BGR frames that the predict paths serve."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(8)]


def boxes_ok(results, h, w) -> bool:
    return all(
        np.isfinite(r.boxes.data).all() and (r.boxes.xyxy[:, [0, 2]] <= w).all()
        and (r.boxes.xyxy[:, [1, 3]] <= h).all() and (r.boxes.xyxy >= 0).all()
        and ((r.boxes.conf > 0.001) & (r.boxes.conf <= 1)).all() and len(r) <= 300
        for r in results
    )


def phase_slice(dev):
    """The predict path: YOLO.predict, with the kernel's launches counted."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    frames = slice_frames()
    yolo = YOLO("yolov8s-cbam-swin.yaml", device="cuda", dtype=torch.bfloat16, seed=SEED)
    reset_counts()
    t0 = time.perf_counter()
    results = yolo.predict(frames, imgsz=640, conf=0.001, batch=8)
    seconds = time.perf_counter() - t0
    launches = counts()
    dets = [len(r) for r in results]
    boxes_good = boxes_ok(results, 480, 640)
    ok = launches["swin_block_fwd"] > 0 and len(results) == 8 and boxes_good

    x = letterboxed(frames, 640, dev, torch.bfloat16)
    bf16_ok, bf16_err, out_shape = compare_forward(yolo.model, x, 3e-2)
    fp32 = YOLO("yolov8s-cbam-swin.yaml", device="cuda", dtype=torch.float32, seed=SEED).fuse()
    fp32_ok, fp32_err, _ = no_tf32(compare_forward, fp32.model, letterboxed(frames, 640, dev, torch.float32), 2e-3)
    ok = ok and bf16_ok and fp32_ok and out_shape == (8, 5, 8400)
    return ok, {
        "launches": launches, "detections_per_frame": dets, "boxes_ok": bool(boxes_good),
        "predict_s_first_call": seconds, "speed_ms_per_img": results[0].speed,
        "decoded_shape": list(out_shape),
        "bf16_kernel_vs_plain_rel_err": bf16_err,
        "fp32_kernel_vs_plain_rel_err": fp32_err,
    }, yolo, launches


def train_batches(n, dev, aug=True):
    """Seeded synthetic batches in the loader's format, on the card: img
    (16, 640, 640, 3) uint8, cls (16, 32) (one class), bboxes (16, 32, 4)
    normalised xywh, mask (16, 32) with about half the rows valid, and aug,
    the default hyperparameters of the device augmentation."""
    from improving_yolov8_cbam_swinblock_tpu_torch.cfg import AUG_KEYS, get_cfg

    defaults = get_cfg()
    hyp = torch.tensor([float(getattr(defaults, k)) for k in AUG_KEYS], device=dev)
    rng = np.random.default_rng(SEED + 2)
    b, s = TRAIN["batch"], TRAIN["imgsz"]
    out = []
    for _ in range(n):
        xy, wh = rng.uniform(0.15, 0.85, (b, MAX_GT, 2)), rng.uniform(0.05, 0.4, (b, MAX_GT, 2))
        batch = {"img": torch.tensor(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8), device=dev),
                 "cls": torch.zeros(b, MAX_GT, dtype=torch.int32, device=dev),
                 "bboxes": torch.tensor(np.concatenate([xy, wh], -1).astype(np.float32), device=dev),
                 "mask": torch.tensor((rng.random((b, MAX_GT)) < 0.5).astype(np.float32), device=dev)}
        if aug:
            batch["aug"] = hyp
        out.append(batch)
    return out


def micro_step(tr, step, batch, impl=None):
    """One micro-step that does not reach the optimizer, with the Swin blocks
    and the assigner on `impl` (None: the kernels; "plain"), then the
    trainer put back as it was (parameters, BN statistics, step,
    augmentation draws). Returns the loss items and the Swin parameters'
    grads."""
    assert (tr.step + 1) % tr.accumulate, "the micro-step would update the parameters"
    swins = swin_modules(tr.model)
    snap = {k: v.clone() for k, v in tr.model.state_dict().items()}
    gen = tr.aug_gen.get_state()
    for m in swins:
        m.impl = impl
    tr.tal_impl = impl
    try:
        items = step(batch)
        grads = {n: p.grad.detach().float().clone() for n, p in tr.model.named_parameters()
                 if n.startswith(tuple(f"model.{m.i}." for m in swins))}
    finally:
        for m in swins:
            m.impl = None
        tr.tal_impl = None
        tr.model.load_state_dict(snap)
        tr.aug_gen.set_state(gen)
        tr.step -= 1
        for p in tr.model.parameters():
            p.grad = None
    return items, grads


def item_errs(a, b):
    return ((a - b).abs() / b.abs().clamp(min=1e-12)).tolist()


def block_errs(got, ref) -> dict:
    """{SwinBlock layer: |got - ref| / |ref|}, L2 norms over the block's 12 grads."""
    out = {}
    for layer in sorted({n.split(".")[1] for n in ref}, key=int):
        names = [n for n in ref if n.split(".")[1] == layer]
        diff = torch.cat([(got[n] - ref[n]).flatten() for n in names])
        out[layer] = (diff.norm() / torch.cat([ref[n].flatten() for n in names]).norm().clamp(min=1e-30)).item()
    return out


def compare_step(tr, step, batch, wrap):
    """(kernel run, plain run, whether the plain run launched no kernel)."""
    k = wrap(micro_step, tr, step, batch)
    before = counts()
    p = wrap(micro_step, tr, step, batch, "plain")
    return k, p, counts() == before


def phase_train(dev):
    """The train path: 8 micro-steps with the kernels' launches counted per
    step; then one micro-step with the kernels vs with the plain versions,
    in bf16 and in fp32, from one state and batch."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer

    tr = DetectionTrainer(overrides=TRAIN).setup()
    step, acc = tr._make_train_step(nb=TRAIN_NB)
    batches = train_batches(TRAIN_STEPS + 1, dev)
    reset_counts()
    t0 = time.perf_counter()
    per_step, fired, losses = [], [], []
    for i in range(TRAIN_STEPS):
        before, updates = counts(), tr.ema_updates
        items = step(batches[i])
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in counts().items()})
        losses.append(items.tolist())
        if tr.ema_updates > updates:
            fired.append(i + 1)
    seconds = time.perf_counter() - t0
    launches = counts()
    want = {"swin_block_fwd": 2, "swin_block_fwd_exact": 2, "swin_block_bwd": 2, "tal_assign": 1,
            "swin_block_int8": 0, "swin_block_int8_sm16": 0}
    ok = (acc == 4 and fired == [4, 8] and all(d == want for d in per_step)
          and bool(np.isfinite(losses).all()) and tr.optimizer_name == "SGD")

    # the comparison: the bf16 trainer, and an fp32 one (amp off) in its state
    tr32 = DetectionTrainer(overrides={**TRAIN, "amp": False}).setup()
    tr32.model.load_state_dict(tr.model.state_dict())
    step32, _ = tr32._make_train_step(nb=TRAIN_NB)
    tr32.step = tr.step
    tr32.aug_gen.set_state(tr.aug_gen.get_state())
    (i16k, g16k), (i16p, g16p), quiet16 = compare_step(tr, step, batches[-1], lambda f, *a: f(*a))
    (i32k, g32k), (i32p, g32p), quiet32 = compare_step(tr32, step32, batches[-1], no_tf32)
    del tr32, step32
    fp32_grad, bf16_grad = block_errs(g32k, g32p), block_errs(g16k, g16p)
    bf16_vs_fp32 = {"kernel": block_errs(g16k, g32p), "plain": block_errs(g16p, g32p)}
    cmp = {"fp32": {"loss_items_kernel": i32k.tolist(), "loss_items_plain": i32p.tolist(),
                    "loss_items_rel_err": item_errs(i32k, i32p), "swin_grad_rel_l2": fp32_grad,
                    "swin_grad_max_rel_err": {n: rel_err(g32k[n], g32p[n]) for n in g32p}},
           "bf16": {"loss_items_kernel": i16k.tolist(), "loss_items_plain": i16p.tolist(),
                    "loss_items_rel_err": item_errs(i16k, i16p), "swin_grad_rel_l2": bf16_grad,
                    "swin_grad_rel_l2_vs_fp32_plain": bf16_vs_fp32}}
    cmp_ok = (quiet16 and quiet32 and len(g32p) == 24 and len(fp32_grad) == 2
              and max(item_errs(i32k, i32p)) <= FP32_ITEM_RTOL and max(fp32_grad.values()) <= FP32_GRAD_RTOL
              and max(item_errs(i16k, i16p)) <= BF16_ITEM_RTOL
              and all(bf16_vs_fp32["kernel"][i] <= BF16_GRAD_SLACK * bf16_vs_fp32["plain"][i] for i in bf16_grad))
    return ok and cmp_ok, {
        "steps": TRAIN_STEPS, "accumulate": acc, "optimizer_fired_at": fired, "ema_updates": tr.ema_updates,
        "launches": launches, "launches_per_step": per_step, "loss_items": losses, "seconds": seconds,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kernel_vs_plain": {**cmp, "ok": cmp_ok, "fp32_item_rtol": FP32_ITEM_RTOL, "fp32_grad_rtol": FP32_GRAD_RTOL,
                            "bf16_item_rtol": BF16_ITEM_RTOL, "bf16_grad_slack": BF16_GRAD_SLACK},
    }, (tr, step), launches


def swin_outputs(model, x):
    """{Swin layer: (its input, its output)} of one forward of model on x."""
    outs = {}
    hooks = [m.register_forward_hook(lambda m, i, o: outs.__setitem__(m.i, (i[0], o))) for m in swin_modules(model)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return outs


def oracle_errs(got, ref) -> dict:
    got, ref = got.float(), ref.float()
    return {"mean_rel": ((got - ref).abs().mean() / ref.abs().mean()).item(), "max_rel": rel_err(got, ref)}


def phase_int8(dev):
    """The int8 PTQ path: quantize_model on two seeded uint8 batches of 8
    frames at 640 px (bench.py bench_infer), then YOLO.predict on the slice
    phase's frames, the launches of each counted; the int8 model with K4 vs
    with the plain version; each int8 SwinBlock vs the float block on the
    input it receives in the int8 model (the JAX oracle's bounds), and the
    int8 vs the float model at each Swin layer; int8 forward and predict
    img/s at batch 32."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block

    yolo = YOLO("yolov8s-cbam-swin.yaml", device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32,
                seed=SEED).fuse()
    float_model = copy.deepcopy(yolo.model)
    rng = np.random.default_rng(SEED)
    calib = [rng.integers(0, 255, (8, 640, 640, 3), dtype=np.uint8) for _ in range(2)]
    frames = slice_frames()
    reset_counts()
    t0 = time.perf_counter()
    quantize_model(yolo.model, calib)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    calib_launches = counts()
    results = yolo.predict(frames, imgsz=640, conf=0.001, batch=8)
    t2 = time.perf_counter()
    launches = counts()
    predict_launches = {k: v - calib_launches[k] for k, v in launches.items()}
    boxes_good = boxes_ok(results, 480, 640)
    ok = (calib_launches["swin_block_fwd"] == 2 * len(calib) and calib_launches["swin_block_int8"] == 0
          and predict_launches["swin_block_int8"] == 2 and predict_launches["swin_block_fwd"] == 0
          and launches["swin_block_int8_sm16"] == 0 and len(results) == 8 and boxes_good)

    x = letterboxed(frames, 640, dev, torch.bfloat16)
    k_ok, k_err, out_shape = compare_forward(yolo.model, x, INT8_MODEL_RTOL)
    o8, of = swin_outputs(yolo.model, x), swin_outputs(float_model, x)
    oracle, model_level = {}, {}
    with torch.inference_mode():
        for m in swin_modules(yolo.model):
            xin, y8 = o8[m.i]
            yf = swin_block(xin.permute(0, 2, 3, 1), m.kernel_params(), m.num_heads, m.window_size)
            oracle[m.i] = oracle_errs(y8, yf.permute(0, 3, 1, 2))
            model_level[m.i] = oracle_errs(y8, of[m.i][1])
    oracle_ok = len(oracle) == 2 and all(v["mean_rel"] < ORACLE_MEAN and v["max_rel"] < ORACLE_MAX
                                         for v in oracle.values())

    bs = 32
    xb = torch.rand(bs, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        int8_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
        float_ms = cuda_ms(lambda: float_model(xb), iters=10)
    frames32 = [np.random.default_rng(SEED + 1).integers(0, 256, (480, 640, 3), dtype=np.uint8)] * bs
    yolo.predict(frames32, imgsz=640, batch=bs)  # warm-up
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for _ in range(2):
        yolo.predict(frames32, imgsz=640, batch=bs)
    predict_img_s = 2 * bs / (time.perf_counter() - t3)
    return ok and k_ok and oracle_ok and out_shape == (8, 5, 8400), {
        "calibration_launches": calib_launches, "predict_launches": predict_launches,
        "calibrate_s": t1 - t0, "predict_s_first_call": t2 - t1,
        "detections_per_frame": [len(r) for r in results], "boxes_ok": bool(boxes_good),
        "kernel_vs_plain_rel_err": k_err, "kernel_vs_plain_ok": k_ok, "kernel_vs_plain_rtol": INT8_MODEL_RTOL,
        "int8_vs_float_swin_block": oracle, "oracle_ok": oracle_ok,
        "int8_vs_float_model_at_swin_layers": model_level,
        "batch": bs, "int8_forward_ms": int8_ms, "int8_forward_img_per_s": bs * 1e3 / int8_ms,
        "float_fp32_weights_forward_ms": float_ms, "float_fp32_weights_forward_img_per_s": bs * 1e3 / float_ms,
        "int8_predict_img_per_s_conf0.25": predict_img_s,
    }, yolo, launches, int8_ms


def phase_speed(yolo, train, dev):
    """Predict img/s at batch 32, 640 px, bf16, BN-folded; train img/s at
    batch 16 (CUDA events over 8 micro-steps, two optimizer steps), with and
    without the device augmentation."""
    bs = 32
    x = torch.rand(bs, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: yolo.model(x), iters=10)
    rng = np.random.default_rng(SEED + 1)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(bs)]
    out = {"batch": bs, "forward_ms": fwd_ms, "forward_img_per_s": bs * 1e3 / fwd_ms}
    for conf in (0.25, 0.001):
        yolo.predict(frames, imgsz=640, conf=conf, batch=bs)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 2
        for _ in range(reps):
            yolo.predict(frames, imgsz=640, conf=conf, batch=bs)
        dt = (time.perf_counter() - t0) / reps
        out[f"predict_img_per_s_conf{conf}"] = bs / dt
    tr, step = train
    for aug in (True, False):
        batches = train_batches(4, dev, aug=aug)
        cycle = itertools.cycle(batches)
        ms = cuda_ms(lambda: step(next(cycle)), iters=8, warmup=4)
        key = "train_aug" if aug else "train_no_aug"
        out[f"{key}_ms_per_step"] = ms
        out[f"{key}_img_per_s"] = TRAIN["batch"] * 1e3 / ms
    return True, out, fwd_ms


def kernel_times(prof, steps):
    """Device time by kernel (us per step), the total, and each kernel's share."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    total = sum(e.device_time_total for e in events) / steps
    top = sorted(events, key=lambda e: -e.device_time_total)[:12]

    def share(*names):
        return sum(e.device_time_total for e in events if any(n in e.key for n in names)) / steps / total

    return total, top, share


def forward_profile(model, x, forward_ms, swin_kernel):
    """Device time by kernel over 3 forwards of model on x (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(x)
            torch.cuda.synchronize()
    total, top, share = kernel_times(prof, 3)
    if total == 0:
        return None
    return {"kernel_us_per_forward": total, "device_busy_share": total / (1e3 * forward_ms),
            "swin_share": share(swin_kernel),
            "top": [{"name": e.key[:90], "us_per_forward": e.device_time_total / 3, "calls": e.count // 3}
                    for e in top]}


def phase_profile(yolo, train, dev, forward_ms, int8_yolo, int8_ms):
    """Device time by kernel over 3 forwards at batch 32 (bf16, and int8),
    and over 4 train micro-steps (one accumulation cycle) with augmentation
    (torch.profiler); the busy share is kernel time over the event-timed
    length."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(32, 3, 640, 640, device=dev).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    fwd = forward_profile(yolo.model, x, forward_ms, "swin_block_fwd")
    if fwd is None:
        return True, {"note": "profiler recorded no device time: not measured"}
    out = {"forward": fwd, "int8_forward": forward_profile(int8_yolo.model, x, int8_ms, "swin_block_int8")}

    tr, step = train
    batches = train_batches(4, dev)
    while tr.step % tr.accumulate:  # start at the head of an accumulation cycle
        step(batches[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for b in batches:
            step(b)
        end.record()
        torch.cuda.synchronize()
    total, top, share = kernel_times(prof, 4)
    if total == 0:
        return True, {**out, "train": {"note": "profiler recorded no device time: not measured"}}
    step_ms = start.elapsed_time(end) / 4
    out["train"] = {
        "kernel_us_per_step": total, "step_ms_under_profiler": step_ms,
        "device_busy_share": total / (1e3 * step_ms),
        "swin_fwd_share": share("swin_block_fwd"), "swin_bwd_share": share("swin_bwd_"),
        "tal_share": share("tal_prep", "tal_topk", "tal_resolve", "tal_final"),
        "top": [{"name": e.key[:90], "us_per_step": e.device_time_total / 4, "calls": e.count / 4} for e in top],
    }
    return True, out


def kernels_line(yolo, tr, int8_yolo, dev, launches):
    """Each kernel at the shapes its path hands it, vs its plain version,
    timed, beside its bound. No single PyTorch call computes any of the
    functions (the whole SwinBlock, its backward, its int8 form, the
    task-aligned assignment), so library_ms is null for each."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block, swin_block_bwd
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin_int8 import q8, swin_block_int8
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    rng = np.random.default_rng(SEED)
    # K1: predict at 640 px with batch 8 hands it (8, 40, 40, 256) bf16, fast
    swin = swin_modules(yolo.model)[0]
    p = swin.kernel_params()
    x = torch.tensor(rng.normal(0, 1, (8, 40, 40, 256)).astype(np.float32), device=dev).to(torch.bfloat16)
    bound_ms, bound_by = swin_bound(tuple(x.shape), x.dtype)
    fwd = {"name": "swin_block_fwd", "launches": sum(v["swin_block_fwd"] for v in launches.values()),
           "launches_by_path": {k: v["swin_block_fwd"] for k, v in launches.items()},
           "max_abs_err": (swin_block(x, p, 2).float() - swin_block(x, p, 2, impl="plain").float()).abs().max().item(),
           "ms": cuda_ms(lambda: swin_block(x, p, 2)),
           "plain_ms": cuda_ms(lambda: swin_block(x, p, 2, impl="plain"), iters=5),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    # K1 exact and K3: train at 640 px with batch 16 hands them (16, 40, 40, 256) bf16, fp32 masters
    tswin = swin_modules(tr.model)[0]
    tp = {k: v.detach() for k, v in tswin.kernel_params().items()}
    xt = torch.tensor(rng.normal(0, 1, (16, 40, 40, 256)).astype(np.float32), device=dev).to(torch.bfloat16)
    gt = torch.tensor(rng.normal(0, 1, (16, 40, 40, 256)).astype(np.float32), device=dev).to(torch.bfloat16)
    fwd["train_exact"] = {
        "shape": list(xt.shape), "ms": cuda_ms(lambda: swin_block(xt, tp, 2, fast=False)),
        "plain_ms": cuda_ms(lambda: swin_block(xt, tp, 2, fast=False, impl="plain"), iters=5),
        "bound_ms": swin_bound(tuple(xt.shape), xt.dtype)[0]}
    got, ref = swin_block_bwd(xt, gt, tp, 2), swin_block_bwd(xt, gt, tp, 2, impl="plain")
    bound_ms, bound_by = swin_bwd_bound(tuple(xt.shape), xt.dtype)
    bwd = {"name": "swin_block_bwd", "launches": launches["train"]["swin_block_bwd"],
           "max_abs_err": (got[0].float() - ref[0].float()).abs().max().item(),
           "max_rel_err": max(bwd_errors(got, ref).values()),
           "ms": cuda_ms(lambda: swin_block_bwd(xt, gt, tp, 2), iters=10),
           "plain_ms": cuda_ms(lambda: swin_block_bwd(xt, gt, tp, 2, impl="plain"), iters=3),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    # K2: the train path hands it B=16, A=8400, G=4*max_gt=128 after mosaic, nc=1
    args = tal_inputs(16, 4 * MAX_GT, 1, 640, dev, SEED)
    got, ref = task_aligned_assign(*args, num_classes=1), task_aligned_assign(*args, num_classes=1, impl="plain")
    bound_ms, bound_by = tal_bound(16, args[0].shape[1], 4 * MAX_GT, 1, 1)
    tal = {"name": "tal_assign", "launches": launches["train"]["tal_assign"],
           "max_abs_err": max((got.target_scores - ref.target_scores).abs().max().item(),
                              (got.target_bboxes - ref.target_bboxes).abs().max().item()),
           "exact_fg_idx_labels": tal_compare(got, ref)["exact_fg_idx_labels"],
           "ms": cuda_ms(lambda: task_aligned_assign(*args, num_classes=1)),
           "plain_ms": cuda_ms(lambda: task_aligned_assign(*args, num_classes=1, impl="plain"), iters=5),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    # K4: the int8 path at batch 8 hands it (8, 40, 40, 256) int8 in and out; K4v (sm16) runs on no path
    swin8 = swin_modules(int8_yolo.model)[0]
    p8, q = swin8.kernel_params(), {k: getattr(swin8, k) for k in swin8.QNAMES}
    x8 = q8(torch.tensor(rng.normal(0, 1, (8, 40, 40, 256)).astype(np.float32), device=dev), q["x_in_scale"])
    x8 = x8.to(torch.int8)
    bound_ms, bound_by = swin_int8_bound(tuple(x8.shape), torch.int8, torch.int8)
    int8_rows = []
    for name, sm16 in (("swin_block_int8", False), ("swin_block_int8_sm16", True)):
        cmp = int8_compare(swin_block_int8(x8, p8, q, 2, in8=True, out8=True, sm16=sm16),
                           swin_block_int8(x8, p8, q, 2, in8=True, out8=True, sm16=sm16, impl="plain"))
        int8_rows.append({
            "name": name, "launches": launches["int8"][name],
            "launches_by_path": {k: v[name] for k, v in launches.items()},
            "max_abs_err": cmp["max_abs_err"], "share_off": cmp["share_off"],
            "ms": cuda_ms(lambda: swin_block_int8(x8, p8, q, 2, in8=True, out8=True, sm16=sm16)),
            "plain_ms": cuda_ms(lambda: swin_block_int8(x8, p8, q, 2, in8=True, out8=True, sm16=sm16, impl="plain"),
                                iters=5),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    rows = [fwd, bwd, tal, *int8_rows]
    for r in rows:
        r.update(route="cuda", source=SOURCES[r["name"]], replaces=REPLACES[r["name"]])
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    check_card(name)
    failed = []

    def run(label, fn, *args):
        t0 = time.perf_counter()
        ok, info, *rest = fn(*args)
        emit({"phase": label, "ok": bool(ok), "seconds": round(time.perf_counter() - t0, 3), "card": smi, **info})
        if not ok:
            failed.append(label)
        return rest

    build = phase_build()
    emit({"phase": "build", "ok": True, "card": smi, **build})
    run("kernel", phase_kernel, dev)
    yolo, predict_launches = run("slice", phase_slice, dev)
    train, train_launches = run("train", phase_train, dev)
    int8_yolo, int8_launches, int8_ms = run("int8", phase_int8, dev)
    (forward_ms,) = run("speed", phase_speed, yolo, train, dev)
    run("profile", phase_profile, yolo, train, dev, forward_ms, int8_yolo, int8_ms)
    kernels = kernels_line(yolo, train[0], int8_yolo, dev,
                           {"predict": predict_launches, "train": train_launches, "int8": int8_launches})
    print(smi, flush=True)
    emit({"kernels": kernels})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
