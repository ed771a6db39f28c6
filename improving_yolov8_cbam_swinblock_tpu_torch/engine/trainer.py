"""Detect train step of the port: device augmentation, forward, TAL + loss,
backward, gradient accumulation, clip, optimizer, warmup schedules and EMA.

Counterpart of the JAX package's engine/trainer.py `_make_train_step`, on
one card. The JAX step is one jitted function over an explicit TrainState;
here the trainer holds the state (the model with fp32 master weights, a
torch.optim optimizer with three parameter groups, the EMA and the step
counter) and the step updates it in place:

  * grads of the batch-scaled loss are summed in .grad over `accumulate`
    micro-steps (nbs / batch), clipped by their global norm to 10 (with
    JAX's 1e-12), then the optimizer steps with the warmup-scheduled lr and
    momentum of the micro-step counter, and the EMA of parameters and BN
    statistics moves with decay 0.9999 (1 - exp(-t / 2000));
  * the 7 optimizers are the torch.optim classes, which the JAX update
    rules follow step for step (tests/test_optimizer.py); groups: decay
    (conv and linear weights, weight decay scaled by batch * accumulate /
    nbs), nodecay (norm scales), bias (warmup from warmup_bias_lr);
  * BN statistics move on every micro-step, with flax's biased variance.

Not in this slice: the on-disk dataset and loader, YOLO.train, validation,
checkpoints and resume, multi_scale, and the other tasks' losses.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..cfg import AUG_KEYS, get_cfg
from ..nn.tasks import DetectionModel
from ..ops.augment_device import device_augment
from ..utils.device import select_device
from ..utils.loss import detection_loss

OPTIMIZERS = ("Adam", "Adamax", "AdamW", "NAdam", "RAdam", "RMSProp", "SGD")
CLIP_NORM = 10.0


def param_group_of(name: str, owner: nn.Module) -> str:
    """decay | nodecay | bias for the parameter `name` (its last dotted part)
    held directly by `owner`: biases, norm scales, everything else."""
    if name.endswith("bias"):  # bias, in_proj_bias
        return "bias"
    if isinstance(owner, (nn.BatchNorm2d, nn.LayerNorm)):
        return "nodecay"
    return "decay"


def resolve_optimizer(args, nc: int, nb: int):
    """'auto' picks SGD (lr 0.01, momentum 0.9) above 10k iterations, else
    AdamW with the fitted lr 0.002 * 5 / (4 + nc), and then zeroes
    warmup_bias_lr; any other name is canonicalised. Mutates args as the
    reference does. Returns (name, lr0, momentum)."""
    name = str(getattr(args, "optimizer", "auto") or "auto")
    lr0, momentum = args.lr0, args.momentum
    if name.lower() == "auto":
        iterations = math.ceil(nb * args.batch / max(args.batch, args.nbs)) * args.epochs
        lr_fit = round(0.002 * 5 / (4 + nc), 6)
        name, lr0, momentum = ("SGD", 0.01, 0.9) if iterations > 10000 else ("AdamW", lr_fit, 0.9)
        args.warmup_bias_lr = 0.0
    canon = {x.lower(): x for x in OPTIMIZERS}.get(name.lower())
    if canon is None:
        raise NotImplementedError(f"Optimizer '{name}' not in {sorted(OPTIMIZERS)}")
    return canon, float(lr0), float(momentum)


def build_optimizer(name: str, groups: Dict[str, list], lr: float, momentum: float, decay: float):
    """torch.optim optimizer over the decay / nodecay / bias groups, as the
    reference builds it; only the decay group has weight decay."""
    pg = [{"params": groups[k], "weight_decay": decay if k == "decay" else 0.0, "group": k}
          for k in ("decay", "nodecay", "bias") if groups[k]]
    if name == "SGD":
        return torch.optim.SGD(pg, lr=lr, momentum=momentum, nesterov=True)
    if name == "RMSProp":
        return torch.optim.RMSprop(pg, lr=lr, momentum=momentum)
    return getattr(torch.optim, name)(pg, lr=lr, betas=(momentum, 0.999))


def set_schedule(opt: torch.optim.Optimizer, lr_w: float, lr_b: float, mom: float) -> None:
    """The warmup-scheduled lr of each group (the bias group's own) and the
    momentum of SGD and RMSProp; the Adam family keeps its fixed beta1, as
    the reference's update rules do."""
    for grp in opt.param_groups:
        grp["lr"] = lr_b if grp["group"] == "bias" else lr_w
        if "momentum" in grp:
            grp["momentum"] = mom


class DetectionTrainer:
    """Trains a DetectionModel on batches in the loader's format:
    img (B, s, s, 3) uint8 RGB, cls (B, G), bboxes (B, G, 4) normalised xywh,
    mask (B, G) and, optionally, aug (7,) = mosaic, scale, translate,
    fliplr, hsv_h, hsv_s, hsv_v for the device augmentation.

    The trainer runs on the card unless `device="cpu"` is passed."""

    def __init__(self, overrides: Optional[Dict] = None, model: Optional[DetectionModel] = None, device=None):
        self.args = get_cfg(overrides)
        self.device = select_device(device if device is not None else self.args.device)
        self.model = model
        self.step = 0
        self.ema: Dict[str, torch.Tensor] = {}
        self.ema_updates = 0
        self.optimizer = None
        self.tal_impl: Optional[str] = None  # "plain" forces the assigner's plain version, for a check on the card

    def setup(self) -> "DetectionTrainer":
        """Model (seeded random init unless one was given; fp32 master weights,
        bf16 compute with amp), training mode, EMA. No datasets."""
        a = self.args
        if self.model is None:
            self.model = DetectionModel(a.model or "yolov8s-cbam-swin.yaml",
                                        dtype=torch.bfloat16 if a.amp else torch.float32,
                                        device=self.device, seed=a.seed,
                                        param_dtype=torch.float32)
        stride = max(self.model.strides)
        a.imgsz = math.ceil(int(a.imgsz) / stride) * stride
        self.model.train()
        self.step = 0
        self.ema = {k: v.detach().float().clone() for k, v in self._ema_sources()}
        self.ema_updates = 0
        self.aug_gen = torch.Generator(device=self.device).manual_seed(int(a.seed))
        return self

    def _ema_sources(self):
        """(name, tensor) of every parameter and every BN running statistic."""
        yield from self.model.named_parameters()
        for name, buf in self.model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                yield name, buf

    def _frozen(self, name: str) -> bool:
        fz = self.args.freeze
        if fz is None:
            return False
        layers = range(fz) if isinstance(fz, int) else [int(i) for i in (fz if isinstance(fz, (list, tuple)) else [fz])]
        return any(name.startswith(f"model.{i}.") for i in layers)

    def _make_train_step(self, nb: int):
        """Build the optimizer and return (step, accumulate): step(batch) runs
        one micro-step and returns the (3,) loss items box, cls, dfl."""
        a = self.args
        model = self.model
        epochs = int(a.epochs)
        opt_name, lr0, mom_f = resolve_optimizer(a, model.nc, nb)
        self.optimizer_name = opt_name
        nw = max(round(a.warmup_epochs * nb), 100) if a.warmup_epochs > 0 else -1
        self.accumulate = accumulate = max(1, round(a.nbs / a.batch))
        decay = a.weight_decay * a.batch * accumulate / a.nbs
        lrf, mom_w, bias_lr0 = a.lrf, a.warmup_momentum, a.warmup_bias_lr

        groups = {"decay": [], "nodecay": [], "bias": []}
        for mname, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                if not self._frozen(f"{mname}.{pname}"):
                    groups[param_group_of(pname, mod)].append(p)
        self.optimizer = opt = build_optimizer(opt_name, groups, lr0, mom_f, decay)
        params = list(model.parameters())  # the clip's norm spans every grad, frozen layers' too

        def lf(epoch_f):
            if a.cos_lr:
                return ((1 - math.cos(epoch_f * math.pi / epochs)) / 2) * (lrf - 1) + 1
            return (1 - epoch_f / epochs) * (1.0 - lrf) + lrf

        def schedules(ni):
            """(weight lr, bias lr, momentum) at micro-step ni."""
            base = lr0 * lf(min(max(math.floor(ni / nb), 0), epochs - 1))
            if nw <= 0 or ni > nw:
                return base, base, mom_f
            frac = min(max(ni / nw, 0.0), 1.0)
            return frac * base, bias_lr0 + frac * (base - bias_lr0), mom_w + frac * (mom_f - mom_w)

        device_aug = bool(a.device_augment)
        nc, strides = model.nc, model.strides
        dev = self.device

        def train_step(batch) -> torch.Tensor:
            img = torch.as_tensor(batch["img"], device=dev)
            cls = torch.as_tensor(batch["cls"], device=dev)
            bboxes = torch.as_tensor(batch["bboxes"], device=dev).float()
            mask = torch.as_tensor(batch["mask"], device=dev).float()
            if device_aug and "aug" in batch:
                h = torch.as_tensor(batch["aug"], device=dev, dtype=torch.float32)
                hyp = {k: h[i] for i, k in enumerate(AUG_KEYS)}
                img, bboxes, cls, mask = device_augment(self.aug_gen, img, bboxes, cls, mask, hyp)
            x = img.permute(0, 3, 1, 2).to(model.dtype) / 255.0
            feats = model(x)
            total, items = detection_loss(feats, cls, bboxes, mask, nc=nc, strides=strides, box_gain=a.box,
                                          cls_gain=a.cls, dfl_gain=a.dfl, tal_impl=self.tal_impl)
            total.backward()  # grads add up in .grad across micro-steps
            if (self.step + 1) % accumulate == 0:
                self._apply_update(opt, params, *schedules(self.step))
            self.step += 1
            return torch.stack(list(items))

        return train_step, accumulate

    @torch.no_grad()
    def _apply_update(self, opt, params, lr_w: float, lr_b: float, mom: float) -> None:
        grads = [p.grad for p in params if p.grad is not None]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = torch.clamp(CLIP_NORM / (gnorm + 1e-12), max=1.0)
        torch._foreach_mul_(grads, clip)
        set_schedule(opt, lr_w, lr_b, mom)
        opt.step()
        for p in params:  # the accumulation starts again; frozen layers' grads are dropped too
            p.grad = None
        self.ema_updates += 1
        d = float(np.float32(0.9999) * (np.float32(1) - np.exp(np.float32(-self.ema_updates / 2000.0))))
        for name, src in self._ema_sources():
            self.ema[name].mul_(d).add_(src.detach().float(), alpha=1 - d)
