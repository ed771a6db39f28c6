"""Detect trainer of the port: the train step (device augmentation, forward,
TAL + loss, backward, gradient accumulation, clip, optimizer, warmup
schedules and EMA) and the loop around it (datasets, epochs, validation,
checkpoints, resume).

Counterpart of the JAX package's engine/trainer.py, on one card. The JAX
step is one jitted function over an explicit TrainState; here the trainer
holds the state (the model with fp32 master weights, a
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

With `data` set, `setup()` also builds the datasets and loaders
(data/build.py), overlays pretrained weights of the same shape
(`_warm_start`) and builds the step, and `train()` runs the epochs as the JAX
package does: mosaic closes at epoch >= epochs - close_mosaic, each epoch
is validated on the EMA weights (one cached eval model of the same graph,
into which the EMA is copied), `weights/last.pt` and `weights/best.pt`
(and `epoch{n}.pt` every `save_period` epochs) are written to the run
directory with `results.csv`, and `patience` and `time` stop the run.
A checkpoint is a YOLO-loadable payload (graph, dtypes, names, the EMA as
`state_dict`) that also carries the whole train state under `train`:
parameters and BN statistics, the optimizer's state, the EMA and its
update count, the step, the epoch, best_fitness, the scalar args and the
device augmentation's generator state; `resume` restores it bit for bit.

`batch=-1` picks the batch at setup (utils/model_utils.py
check_train_batch_size: the largest power of two whose train micro-step fits
in 60 % of the card's memory), and `profile=True` prints the per-layer
table of utils/model_utils.py profile_layers once at setup, as the JAX
trainer does.

`device_augment=False` trains on the loader's host augmentation stack
(data/augment.py train_transform) and the step applies no device
augmentation. `multi_scale=True` scales each batch's content by k ~ U(0.5,
1.5) about the centre inside the fixed canvas, as the JAX step does (k from
the trainer's generator). The trainer fires the JAX trainer's callback
events at its points, hands its bus to its validator, and registers the
logger integrations (utils/integrations.py: metrics.jsonl always) when
train() starts; `plots=True` draws labels.jpg at setup, the first three
train batches of the first epoch and results.png at the end, as the JAX
trainer does.

A segmentation model (task "segment", a graph that ends in Segment)
trains as the JAX trainer trains it: the loader's instance-aware host stack
(data/augment.py segment_transform: no device augmentation, no
multi_scale, no rect val), the seg loss (utils/seg_loss.py: the detect
terms, with K2, and the masks' BCE) with four loss items box, seg, cls,
dfl (the progress line and results.csv carry train/seg_loss), and
SegmentationValidator's box and mask metrics. A pose model (task "pose", a
graph that ends in Pose) trains likewise on the host stack
(data/augment.py pose_transform, the keypoints carried through every
transform, `flip_idx` from the data descriptor), with the pose loss
(utils/pose_loss.py: the detect terms, with K2 at topk 10, the OKS location
and the visibility BCE, gains `pose` and `kobj`), five loss items box,
pose, kobj, cls, dfl (the reference's order; the JAX trainer logs box,
cls and dfl only), and PoseValidator's box and keypoint metrics; a data
descriptor's `kpt_shape` replaces the graph's, as the reference's pose
trainer does. An oriented-box model (task "obb", a graph that ends in OBB)
trains on the host stack too (data/augment.py obb_transform: each 4-corner
polygon label's minimum-area rectangle), with the OBB loss
(utils/obb_loss.py: the rotated task-aligned assigner in plain PyTorch, as
the JAX package's is plain JAX, so no kernel runs on this path; probiou
box loss, BCE, DFL), three loss items box, cls, dfl, and OBBValidator's
rotated-box metrics. A classify model (task "classify", a graph that ends
in Classify) trains on an image folder (`data` a directory holding
`train/<class>/` and `val/<class>/`; names from train's class folders):
data/classify.py's loader (random crop, flip, RandAugment at
`auto_augment`, erasing at `erasing`), the cross-entropy of the fp32
log-softmax of the logits, the mean over the batch (not scaled by it, as
in the JAX package and the reference), one loss item `loss` (the
reference's column train/loss; the JAX trainer logs box 0, cls the loss,
dfl 0), the Classify head's Dropout at `dropout` drawing from a
torch.Generator seeded from `seed` (saved for resume), no stride rounding
of imgsz, and ClassificationValidator's top-1 and top-5 accuracy. An
RT-DETR model (`is_rtdetr`, a graph that ends in RTDETRDecoder) trains
on the detect batches with the GT passed into its head for the denoising
group (its draws from a torch.Generator seeded from `seed`, saved for
resume) and the Hungarian-matched DETR loss (utils/detr_loss.py: no
kernel runs on this path), three loss items giou, cls, l1 (the
reference's names), and DetectionValidator's NMS-free branch. A
YOLO-World model (`is_world`) takes the text features of the data's names
(`set_classes`) before its first step, as the JAX trainer does, and trains
on the detect loss at nc = the number of names (K2 once per micro-step);
its eval model and checkpoints carry those features.

Not in the port yet: multi-host sharding.
"""

from __future__ import annotations

import csv
import math
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..cfg import AUG_KEYS, get_cfg
from ..data.build import HYP_KEYS, build_dataloader, build_yolo_dataset
from ..data.classify import ClassificationDataset, ClassificationLoader, classification_data
from ..data.dataset import check_det_dataset
from ..nn.tasks import DetectionModel, yaml_model_load
from ..ops.augment_device import device_augment, scale_content
from ..utils.callbacks import default_callbacks, run_callbacks
from ..utils.detr_loss import rtdetr_loss
from ..utils.device import select_device
from ..utils.files import get_save_dir
from ..utils.jax_import import ema_state, overlay_state, read_checkpoint
from ..utils.loss import detection_loss
from ..utils.obb_loss import obb_loss
from ..utils.pose_loss import pose_loss
from ..utils.seg_loss import segmentation_loss
from .validator import TASK_VALIDATORS, DetectionValidator

OPTIMIZERS = ("Adam", "Adamax", "AdamW", "NAdam", "RAdam", "RMSProp", "SGD")
CLIP_NORM = 10.0
FLAGSHIP = "yolov8s-cbam-swin.yaml"
LOSS_NAMES = {"detect": ("box", "cls", "dfl"), "segment": ("box", "seg", "cls", "dfl"),
              "pose": ("box", "pose", "kobj", "cls", "dfl"), "obb": ("box", "cls", "dfl"),
              "classify": ("loss",), "rtdetr": ("giou", "cls", "l1")}
# a step's items, per task (results.csv: train/<item>_loss; classify's train/loss); an RT-DETR model's under "rtdetr"


def loss_names(model) -> tuple:
    return LOSS_NAMES["rtdetr" if model.is_rtdetr else model.task]


def loss_column(item: str) -> str:
    return "train/loss" if item == "loss" else f"train/{item}_loss"


def checkpoint_state(path) -> Dict[str, torch.Tensor]:
    """The unfused weights a checkpoint file hands to an overlay: the EMA of
    a JAX-format `.ckpt`/`.msgpack`, or the state of a `.pt`. A BN-folded
    file raises (jax_import.ema_state says why)."""
    p = str(path)
    if p.endswith((".ckpt", ".msgpack")):
        return ema_state(read_checkpoint(p))
    payload = torch.load(p, map_location="cpu", weights_only=True)
    if payload.get("fused"):
        raise ValueError(f"{p} is BN-folded: its weights cannot be overlaid onto an unfused model")
    return payload["state_dict"]


def latest_run(search_dir) -> Optional[Path]:
    """The most recent weights/last.pt under search_dir."""
    ckpts = list(Path(search_dir).rglob("last.pt"))
    return max(ckpts, key=lambda p: p.stat().st_mtime) if ckpts else None


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
    fliplr, hsv_h, hsv_s, hsv_v for the device augmentation; a segmentation
    model's batches also carry seg_map (B, h, w) or (B, P, h, w) int32, a
    pose model's kpts (B, G, nk, 3) float32; an OBB model's bboxes are
    (B, G, 5): normalised xywh and the angle in radians.

    The trainer runs on the card unless `device="cpu"` is passed."""

    def __init__(self, overrides: Optional[Dict] = None, model: Optional[DetectionModel] = None, device=None):
        self.args = get_cfg(overrides)
        self.device = select_device(device if device is not None else self.args.device)
        self.callbacks = default_callbacks()
        self.model = model
        self.step = 0
        self.ema: Dict[str, torch.Tensor] = {}
        self.ema_updates = 0
        self.optimizer = None
        self.tal_impl: Optional[str] = None  # "plain" forces the assigner's plain version, for a check on the card
        self.pretrained_state: Optional[Dict[str, torch.Tensor]] = None  # weights handed over by YOLO.train
        self.epoch = 0
        self.best_fitness = -1.0
        self.metrics_rows = []
        self.epoch_stats = []  # per epoch: seconds of the train loop, of waiting for the loader, of val
        self.data = None
        self.validator: Optional[DetectionValidator] = None
        self._eval_model: Optional[DetectionModel] = None
        if self.args.data:  # a directory is an image folder of classes, as the JAX trainer reads it
            data = self.args.data
            is_folder = isinstance(data, (str, Path)) and Path(data).is_dir()
            self.data = classification_data(data) if is_folder else check_det_dataset(data)
            self.save_dir = get_save_dir(self.args)
            self.wdir = self.save_dir / "weights"
            self.wdir.mkdir(parents=True, exist_ok=True)

    def setup(self) -> "DetectionTrainer":
        """Model (seeded random init unless one was given; fp32 master weights,
        bf16 compute with amp; nc and names from the data), training mode,
        EMA. With data: the pretrained overlay (before the EMA is taken),
        the datasets and loaders, and the train step."""
        run_callbacks(self.callbacks, "on_pretrain_routine_start", self)
        a = self.args
        if self.model is None:
            cfg = a.model or FLAGSHIP
            if self.data is not None:
                cfg = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
                cfg["nc"] = 1 if a.single_cls else int(self.data["nc"])
                f, n, head, args = cfg["head"][-1]
                if head == "Pose" and self.data.get("kpt_shape"):  # the data's keypoints, as the reference's
                    cfg["head"] = [*cfg["head"][:-1], [f, n, head, [args[0], list(self.data["kpt_shape"])]]]
            self.model = DetectionModel(cfg, dtype=torch.bfloat16 if a.amp else torch.float32,
                                        device=self.device, seed=a.seed, param_dtype=torch.float32)
        if self.data is not None:
            self.model.names = dict(self.data["names"])
            if self.model.is_world:  # the text features of the data's names, as the JAX trainer encodes them
                self.model.set_classes([str(v) for v in self.data["names"].values()])
        self.drop_gen = self.dn_gen = None
        if self.model.is_rtdetr:  # the denoising group's draws, on a seeded generator saved for resume
            self.dn_gen = torch.Generator(device=self.device).manual_seed(int(a.seed))
            self.model.model[-1].dn_generator = self.dn_gen
        if self.model.task == "classify":  # no strides to round imgsz to; the head's Dropout on a seeded generator
            self.drop_gen = torch.Generator(device=self.device).manual_seed(int(a.seed))
            self.model.model[-1].drop.p = float(a.dropout or 0.0)
            self.model.model[-1].drop.generator = self.drop_gen
        else:
            stride = max(self.model.strides)
            a.imgsz = math.ceil(int(a.imgsz) / stride) * stride
        self.model.train()
        if int(a.batch) == -1:  # autobatch, as the JAX trainer's setup runs it
            from ..utils.model_utils import check_train_batch_size

            a.batch = check_train_batch_size(self.model, imgsz=int(a.imgsz), amp=bool(a.amp))
            print(f"autobatch: batch={a.batch} for imgsz={a.imgsz}")
        if a.profile:  # the per-layer table, once at setup, as the JAX trainer logs it
            from ..utils.model_utils import profile_layers

            profile_layers(self.model, imgsz=int(a.imgsz))
        self.step = 0
        if self.data is not None:
            self._warm_start()
        self.ema = {k: v.detach().float().clone() for k, v in self._ema_sources()}
        self.ema_updates = 0
        self.aug_gen = torch.Generator(device=self.device).manual_seed(int(a.seed))
        if self.data is not None:
            self._build_datasets()
            if a.plots and self.model.task != "classify":
                from ..utils.plotting import plot_labels

                labs = self.train_loader.ds.labels
                plot_labels(np.concatenate([lab["cls"].reshape(-1) for lab in labs]),
                            np.concatenate([lab["xywhn"].reshape(-1, 4) for lab in labs]),
                            names=self.model.names, save_dir=str(self.save_dir))
            self.train_step, self.accumulate = self._make_train_step(len(self.train_loader))
        run_callbacks(self.callbacks, "on_pretrain_routine_end", self)
        return self

    def _build_datasets(self) -> None:
        a = self.args
        if self.model.task == "classify":  # the image folder's train/ and val/, as the JAX trainer builds them
            train_ds = ClassificationDataset(self.data["train"], imgsz=a.imgsz, erasing=float(a.erasing or 0.0),
                                             auto_augment=a.auto_augment or None)
            self.train_loader = ClassificationLoader(train_ds, int(a.batch), train=True, seed=a.seed,
                                                     workers=a.workers)
            self.val_loader = None
            if a.val and self.data.get("val"):
                val_ds = ClassificationDataset(self.data["val"], imgsz=a.imgsz)
                self.val_loader = ClassificationLoader(val_ds, int(a.batch), train=False, workers=a.workers)
            return
        hyp = {k: getattr(a, k) for k in HYP_KEYS}
        task = self.model.task
        kpt_shape = self.model.kpt_shape  # None but for a pose model, as the JAX trainer hands it on
        train_ds = build_yolo_dataset(a, self.data["train"], self.data, mode="train", kpt_shape=kpt_shape)
        self.train_loader = build_dataloader(train_ds, int(a.batch), workers=a.workers, train=True, hyp=hyp,
                                             seed=a.seed, device_augment=bool(a.device_augment), task=task)
        self.val_loader = None
        if a.val and self.data.get("val"):
            val_ds = build_yolo_dataset(a, self.data["val"], self.data, mode="val", kpt_shape=kpt_shape)
            rect = a.rect and task == "detect"
            rect_shape = val_ds.rect_shape(stride=int(max(self.model.strides))) if rect else None
            self.val_loader = build_dataloader(val_ds, int(a.batch), workers=a.workers, train=False, seed=a.seed,
                                               rect_shape=rect_shape, task=task)

    def _warm_start(self) -> None:
        """Overlay pretrained weights onto the fresh init: each parameter and
        BN statistic takes the source's tensor of the same name where its
        shape matches (another nc keeps the fresh Detect class convs).
        Sources, in order: `pretrained=<path>` (a `.pt`, or the EMA weights
        of a JAX-format `.ckpt`/`.msgpack`, as the JAX package's warm start
        reads them), then the weights that YOLO.train handed over."""
        pre = self.args.pretrained
        src = None
        if isinstance(pre, str) and pre not in ("true", "false", "True", "False"):
            src = checkpoint_state(pre)
        elif self.pretrained_state is not None and pre not in (False, "false", "False"):
            src = self.pretrained_state
        if src is None:
            return
        self.transfer_stats = overlay_state(self._ema_sources(), src)
        matched, skipped = self.transfer_stats["matched"], self.transfer_stats["skipped"]
        print(f"Transferred {matched}/{matched + skipped} weight leaves from pretrained checkpoint")

    def _ema_sources(self):
        """(name, tensor) of every parameter and every BN running statistic."""
        return self._named_state(self.model)

    def _frozen(self, name: str) -> bool:
        fz = self.args.freeze
        if fz is None:
            return False
        layers = range(fz) if isinstance(fz, int) else [int(i) for i in (fz if isinstance(fz, (list, tuple)) else [fz])]
        return any(name.startswith(f"model.{i}.") for i in layers)

    def _make_train_step(self, nb: int):
        """Build the optimizer and return (step, accumulate): step(batch) runs
        one micro-step and returns the loss items (LOSS_NAMES: box, cls, dfl;
        a segmentation model's box, seg, cls, dfl; a pose model's box, pose,
        kobj, cls, dfl; an OBB model's box, cls, dfl; a classify model's
        loss, on batches {"img", "label"}; an RT-DETR model's giou, cls, l1)."""
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

        task = model.task  # segment, pose and obb: the loader's host stack only, as in the JAX trainer
        device_aug, multi_scale = (bool(a.device_augment) and task == "detect", bool(a.multi_scale) and task == "detect")
        nc, strides = model.nc, model.strides
        dev = self.device

        def classify_loss(batch):
            """The cross-entropy of the fp32 log-softmax of the logits, the mean over the batch."""
            img = torch.as_tensor(batch["img"], device=dev)
            logits = model(img.permute(0, 3, 1, 2).to(model.dtype) / 255.0)
            total = F.cross_entropy(logits.float(), torch.as_tensor(batch["label"], device=dev).long())
            return total, (total.detach(),)

        def detect_loss(batch):
            img = torch.as_tensor(batch["img"], device=dev)
            cls = torch.as_tensor(batch["cls"], device=dev)
            bboxes = torch.as_tensor(batch["bboxes"], device=dev).float()
            mask = torch.as_tensor(batch["mask"], device=dev).float()
            if device_aug and "aug" in batch:
                h = torch.as_tensor(batch["aug"], device=dev, dtype=torch.float32)
                hyp = {k: h[i] for i, k in enumerate(AUG_KEYS)}
                img, bboxes, cls, mask = device_augment(self.aug_gen, img, bboxes, cls, mask, hyp)
            x = img.permute(0, 3, 1, 2).to(model.dtype) / 255.0
            if multi_scale:
                k = 0.5 + torch.rand((), generator=self.aug_gen, device=dev)
                xs, bboxes, mask = scale_content(x.float(), bboxes, mask, k)
                x = xs.to(model.dtype).clamp(0.0, 1.0)
            if model.is_rtdetr:  # the GT into the head for the denoising group; the Hungarian-matched loss
                preds = model(x, targets={"cls": cls.long(), "bboxes": bboxes, "mask": mask})
                num_dn = preds["dec_bboxes"].shape[2] - preds["enc_bboxes"].shape[1]
                total, items = rtdetr_loss(preds, cls, bboxes, mask, nc, num_dn=num_dn)
                return total, tuple(t.detach() for t in items)
            feats = model(x)
            gains = dict(nc=nc, strides=strides, box_gain=a.box, cls_gain=a.cls, dfl_gain=a.dfl, tal_impl=self.tal_impl)
            if task == "obb":  # the rotated assigner is plain PyTorch, as the JAX package's is plain JAX: no tal_impl
                total, items = obb_loss(*feats, cls, bboxes, mask, nc=nc, strides=strides, box_gain=a.box,
                                        cls_gain=a.cls, dfl_gain=a.dfl)
            elif task == "pose":
                total, items = pose_loss(*feats, cls, bboxes, mask, torch.as_tensor(batch["kpts"], device=dev),
                                         kpt_shape=model.kpt_shape, pose_gain=a.pose, kobj_gain=a.kobj, **gains)
            elif task == "segment":
                total, items = segmentation_loss(*feats, cls, bboxes, mask, torch.as_tensor(batch["seg_map"], device=dev),
                                                 **gains)
            else:
                total, items = detection_loss(feats, cls, bboxes, mask, **gains)
            return total, items

        def train_step(batch) -> torch.Tensor:
            total, items = (classify_loss if task == "classify" else detect_loss)(batch)
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

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        """Run the epochs from the data; returns the last validation's metrics."""
        if self.data is None:
            raise ValueError("train() needs data=<data YAML>; without it the trainer only builds the step")
        if not hasattr(self, "train_loader"):
            self.setup()
        a = self.args
        epochs = int(a.epochs)
        start_epoch = 0
        if a.resume:
            path = Path(a.resume) if isinstance(a.resume, str) else self.wdir / "last.pt"
            if not path.exists():
                path = latest_run(a.project or "runs") or path
            if path.exists():
                self.load_checkpoint(path)
                start_epoch = self.epoch + 1
        from ..utils.integrations import add_integration_callbacks

        self.integrations = add_integration_callbacks(self)
        run_callbacks(self.callbacks, "on_train_start", self)
        nb = len(self.train_loader)
        print(f"{self.model.yaml.get('yaml_file', 'model')}: {self.model.nc} classes, imgsz={a.imgsz}, "
              f"optimizer={self.optimizer_name}, batch={a.batch} on {self.device}")
        final: Dict[str, float] = {}
        patience_left = a.patience
        mosaic_closed = False
        t_start = time.time()
        budget_s = float(a.time) * 3600 if a.time else None
        for epoch in range(start_epoch, epochs):
            self.epoch = epoch
            run_callbacks(self.callbacks, "on_train_epoch_start", self)
            self.train_loader.set_epoch(epoch)
            # >= so that a resume past the close point still closes mosaic
            if a.close_mosaic and not mosaic_closed and epoch >= epochs - a.close_mosaic:
                self.train_loader.close_mosaic()
                print("Closing dataloader mosaic")
                mosaic_closed = True
            t0 = time.perf_counter()
            losses, wait = [], 0.0
            it = iter(self.train_loader)
            while True:
                tw = time.perf_counter()
                batch = next(it, None)
                wait += time.perf_counter() - tw
                if batch is None:
                    break
                losses.append(self.train_step(batch))
                if a.plots and epoch == 0 and len(losses) <= 3 and self.model.task != "classify":
                    from ..utils.plotting import plot_images

                    plot_images(batch["img"], batch["cls"], batch["bboxes"], batch["mask"],
                                fname=str(self.save_dir / f"train_batch{len(losses) - 1}.jpg"), names=self.model.names)
                run_callbacks(self.callbacks, "on_train_batch_end", self)
            mean_loss = torch.stack(losses).float().mean(0).cpu().numpy()  # waits for the epoch's last step
            dt = time.perf_counter() - t0
            print(("%11s" + "%11.4g" * len(mean_loss) + "%11s   %.1f img/s") % (
                f"{epoch + 1}/{epochs}", *mean_loss, a.imgsz, nb * int(a.batch) / max(dt, 1e-9)))
            row = {"epoch": epoch, **{loss_column(k): float(v) for k, v in zip(loss_names(self.model), mean_loss)},
                   "time_s": round(dt, 2)}
            stats = {"epoch": epoch, "batches": nb, "train_s": dt, "loader_wait_s": wait}
            if self.val_loader is not None:
                tv = time.perf_counter()
                val_metrics = self.validate()
                stats.update(val_s=time.perf_counter() - tv, val_seen=self.validator.seen,
                             val_batches=len(self.val_loader), **{f"val_{k}_s": v for k, v in self.validator.times.items()})
                row.update({f"metrics/{k}": v for k, v in val_metrics.items()})
                fitness = val_metrics.get("fitness", 0.0)
                print("  ".join(f"{k} {v:.4g}" for k, v in val_metrics.items()))
                if fitness > self.best_fitness:
                    self.best_fitness = fitness
                    self.save_checkpoint(self.wdir / "best.pt")
                    patience_left = a.patience
                else:
                    patience_left -= 1
                final = val_metrics
            self.save_checkpoint(self.wdir / "last.pt")
            if a.save_period and a.save_period > 0 and (epoch + 1) % int(a.save_period) == 0:
                self.save_checkpoint(self.wdir / f"epoch{epoch}.pt")
            run_callbacks(self.callbacks, "on_model_save", self)
            self.metrics_rows.append(row)
            self.epoch_stats.append(stats)
            self._write_csv()
            run_callbacks(self.callbacks, "on_fit_epoch_end", self)
            stop = patience_left <= 0
            if budget_s is not None:
                # stop once the budget is spent, or when the mean epoch says the next would overshoot it
                elapsed = time.time() - t_start
                if elapsed + elapsed / (epoch - start_epoch + 1) > budget_s:
                    print(f"Time budget {a.time}h: stopping after epoch {epoch + 1}")
                    stop = True
            if stop:
                print(f"Stopping at epoch {epoch + 1}")
                break
        if a.plots:
            from ..utils.plotting import plot_results

            plot_results(str(self.save_dir / "results.csv"))
        run_callbacks(self.callbacks, "on_train_end", self)
        return final

    def eval_model(self) -> DetectionModel:
        """The cached eval model (same graph, dtypes and names) holding the EMA weights."""
        if self._eval_model is None:
            m = self.model
            self._eval_model = DetectionModel(m.yaml, dtype=m.dtype, device=self.device, seed=int(self.args.seed),
                                              param_dtype=m.param_dtype)
        ev = self._eval_model
        ev.names = dict(self.model.names)
        if ev.is_world:
            ev.set_classes(list(ev.names.values()), embeddings=self.model.txt_feats)
        with torch.no_grad():
            for name, t in self._named_state(ev):
                t.copy_(self.ema[name])
        return ev.eval()

    @staticmethod
    def _named_state(model):
        yield from model.named_parameters()
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                yield name, buf

    def validate(self) -> Dict[str, float]:
        """Metrics of the EMA weights on the val loader, between on_val_start and on_val_end."""
        run_callbacks(self.callbacks, "on_val_start", self)
        ev = self.eval_model()
        if self.validator is None:
            self.validator = TASK_VALIDATORS[ev.task](ev, self.val_loader, self.args, callbacks=self.callbacks,
                                                      owner=self)
            self.validator.standalone = False
        out = self.validator()
        run_callbacks(self.callbacks, "on_val_end", self)
        return out

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: Path) -> None:
        """A YOLO-loadable payload (its state_dict is the EMA) carrying the
        whole train state under `train`, for resume."""
        m = self.model
        ema_state = {k: (self.ema[k].to(v.dtype) if k in self.ema else v.detach()).cpu()
                     for k, v in m.state_dict().items()}
        torch.save({
            "yaml": m.yaml, "fused": False, "dtype": str(m.dtype).removeprefix("torch."),
            "param_dtype": str(m.param_dtype).removeprefix("torch."), "names": dict(m.names),
            **({"txt_feats": m.txt_feats.cpu()} if m.is_world else {}), "state_dict": ema_state,
            "train": {
                "model": m.state_dict(), "optimizer": self.optimizer.state_dict(), "ema": self.ema,
                "ema_updates": self.ema_updates, "step": self.step, "epoch": self.epoch,
                "best_fitness": self.best_fitness, "nc": m.nc, "names": dict(m.names),
                "args": {k: v for k, v in vars(self.args).items() if isinstance(v, (int, float, str, bool))},
                "aug_gen": self.aug_gen.get_state(),
                **({"drop_gen": self.drop_gen.get_state()} if self.drop_gen is not None else {}),
                **({"dn_gen": self.dn_gen.get_state()} if self.dn_gen is not None else {}),
            },
        }, Path(path))

    def load_checkpoint(self, path: Path) -> None:
        """Restore the train state that save_checkpoint wrote."""
        tr = torch.load(path, map_location="cpu", weights_only=True)["train"]
        self.model.load_state_dict(tr["model"], strict=True)
        self.optimizer.load_state_dict(tr["optimizer"])
        with torch.no_grad():
            for k, v in self.ema.items():
                v.copy_(tr["ema"][k])
        self.ema_updates = int(tr["ema_updates"])
        self.step = int(tr["step"])
        self.epoch = int(tr["epoch"])
        self.best_fitness = float(tr["best_fitness"])
        self.aug_gen.set_state(tr["aug_gen"])
        if self.drop_gen is not None:
            self.drop_gen.set_state(tr["drop_gen"])
        if self.dn_gen is not None:
            self.dn_gen.set_state(tr["dn_gen"])

    def _write_csv(self) -> None:
        keys = sorted({k for r in self.metrics_rows for k in r})
        with open(self.save_dir / "results.csv", "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=keys)
            w.writeheader()
            w.writerows(self.metrics_rows)
