"""Drive the PyTorch port on one NVIDIA card and check every kernel it runs.

    python3 chip_smoke.py
    python3 chip_smoke.py --k2 PARENT_DIR   # K2 alone, against another checkout
    python3 chip_smoke.py --predict PARENT_DIR   # predict img/s, against another checkout
    python3 chip_smoke.py --fit PARENT_DIR   # YOLO.train img/s with the loader, against another checkout

Phases, one JSON line each; the script exits non-zero if any phase fails:
  build   compile the four CUDA kernels from csrc/ (nvcc, sm_90a), one nvcc
          each, all started together; their ptxas summaries and SASS
          tensor-core and dp4a instruction counts
  kernel  each kernel vs its plain PyTorch version, fp32 (TF32 off) and bf16,
          with times per launch: K1 swin_block_fwd in its fast (predict) and
          exact (train) modes at the flagship's Swin shapes; K3 swin_block_bwd,
          dx and the 12 parameter grads, at (16, 40, 40, 256) and at the
          padded (4, 20, 20, 256); both also at (2, 21, 21, 64) with heads of
          32 and (4, 20, 20, 128) with 4 heads, which exercise the padded
          tensor-core tiles; K2 tal_assign at B=16, A=8400 with G=128,
          nc=1 and with G=32, nc=80, and at topk 1 (G=128, nc=1: YOLOv10's
          one-to-one loss) with its launch config, one launch a call, timed by events
          (host work included) and on the device alone (a CUDA graph); K4 swin_block_int8 at (8, 40, 40, 256)
          and (32, 40, 40, 256), bf16, with int8 I/O (in8, out8), with bf16
          I/O and with the bf16 softmax (sm16, K4v); each K1, K3 and K4 case
          also holds the shared memory the built library asks for against
          the wrappers' copy of it for the CPU. Width cases: every Swin width
          the two graphs build above the flagship's, K1 fast, exact and fp32
          at (8, 40, 40, C) for C 384 to 768, K3 bf16 at (16, 40, 40, C) for
          C 512 to 768 (fp32 at (4, 20, 20, C) for 640 and 768), K4 int8 I/O
          at (8, 40, 40, C) for C 512 and 768 and at (2, 14, 14, 768), with
          its global scratch bytes; K1 from C=384 and K4 at C=512 take their
          wide layouts, K4 at C=768 the wide layout with the fp32 residual
          stream in the global scratch
  slice   YOLO("yolov8s-cbam-swin.yaml").predict on 8 synthetic 480x640
          frames at 640 px, bf16, seeded random weights: the predict path,
          with its kernel launches counted; then the same model with the Swin
          blocks forced to the plain version (bf16), and an fp32 model the same way
  serve   serving from files, on the flagship at 640 px, bf16 over fp32
          master weights: the model written as JAX-format .ckpt files
          (unfused and BN-folded) and a trainer-style payload, each read back
          (state and detections bit for bit); predict from the slice phase's
          frames written as PNGs (a directory, a glob, a list of paths),
          equal to the in-memory predict, with save, save_txt and save_crop
          counted; a 16-frame MJPG video (cv2) with stream=True and
          vid_stride=2; test-time augmentation (K1 6 launches a batch, its
          P4 grids 40, 34 and 28; K1 alone at the new grids vs its plain
          version, fp32 and bf16; its three forwards with K1 vs the plain
          Swin version); an ensemble of two checkpoints (K1 4 launches a
          batch); predict img/s at batch 32 from 32 PNGs and from frames in
          memory, and the TTA forward's ms at batch 32 and its device time
          by kernel
  track   the predict-side verbs on the slice phase's model: YOLO.track over
          the serve phase's video at batch 16 with bytetrack.yaml and
          botsort.yaml (every frame with detections; boxes and ids equal to
          predict's detections replayed through a fresh port tracker; a
          second call with persist=True continuing the ids; stream=True equal
          to the list path at its batch of 1; K1 2 launches a batch), the
          tracker's update ms per frame against predict's (host clock), the
          slice phase's frames tracked as a list in memory; YOLO.embed of 32
          frames from layer 25, (32, 512), equal bit for bit to a forward
          hook's mean pool and within 3e-2 of the plain Swin version's, its
          ms at batch 32 beside the forward's; predict(visualize=True) on 2
          frames, one PNG per rank-4 layer per frame, and its seconds
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
          and predict img/s at batch 32; the int8 model served from the 8
          frames written as PNG files (K4 counted, the same detections)
  export  the export path on the flagship at 640 px, seeded weights:
          YOLO.export to torch.export programs (.pt2): bf16 with a dynamic
          batch, fp32 at a static batch of 8, int8 (quantize_model on the
          int8 phase's calibration frames) at batch 8, and bf16 with nms=True
          at batch 8; a second process loads each through the port's Backend
          and runs the slice phase's frames letterboxed to 640 (bf16 at
          batches 1, 8 and 32, the frames repeated), with K1 or K4 counted
          per call; each held to the live model (bit for bit, or within the
          slice phase's forward tolerances, the gap printed), the nms
          program's (8, 300, 6) to e2e_postprocess of the live output, the
          static program refusing a batch of 4; the loaded bf16 program's
          forward at batch 32 against the live forward (CUDA events, in
          turns); each export's seconds; YOLO.benchmark's torch and pt2 rows
  fit     the data path and the train loop: a seeded synthetic YOLO dataset
          written as PNGs (64 train and 32 val images, most 480x640, some
          384x512 and 300x700, 1-5 boxes each, nc=1), then
          YOLO("yolov8s-cbam-swin.yaml").train(data=...) for 2 epochs at batch
          16, 640 px, nbs 64, SGD, max_gt 32, close_mosaic 1, 8 loader
          threads, from the seeded weights with the class priors zeroed
          (start_without_class_priors), validating each epoch: K1 / K3 / K2 launches per
          micro-step and K1 launches per val batch, the mosaic value per
          epoch, finite losses, last.pt, best.pt, results.csv; a fresh
          trainer loading epoch 1's checkpoint (bit for bit) and resuming
          epoch 2 only; YOLO(best.pt).val against the trainer's record; val
          with K1 against val with its plain version (the forward on the val
          batches in bf16 and fp32, the metrics in fp32); loader ms per batch,
          micro-step ms, epoch seconds, train img/s with the loader, val img/s
  fit_host the host side of YOLO.train and YOLO.val on the fit phase's dataset:
          YOLO("yolov8s-cbam-swin.yaml").train for 2 epochs at batch 16, 640
          px, with device_augment=False (the loader's host augmentation
          stack: mosaic 2x2 and, with mosaic9=0.5, 3x3; random_perspective
          with degrees 10, shear 2, perspective 5e-4; mixup 0.5; flipud 0.5;
          pixel_augment, HSV, fliplr), close_mosaic 1, multi_scale, the RAM
          image cache, plots, save_json and a callback on every event: K1 /
          K3 / K2 launches per micro-step and K1 per val batch, the loader's
          mosaic per epoch, every batch's boxes finite and inside [0, 1] under
          their mask, the events in the JAX package's order, results.csv,
          metrics.jsonl and predictions.json (as many records as val kept
          detections), the plots written or skipped (cv2, matplotlib); the host
          loader alone (mosaic on and off, with and without the cache) beside
          the fit phase's device-path loader, each host transform's ms on one
          thread, the first batch's ms over 1, 2, 4 and 8 loader threads,
          train img/s with the loader per epoch; YOLO(best.pt) BN-folded and quantized on two batches of the
          train images, its YOLO.val (K4 2 launches per val batch) beside the
          float val of the same weights: both mAP50 and mAP50-95
  families the other detect families: YOLO(name).predict of the slice
          phase's frames at 640 px, bf16, BN-folded, seeded weights, for every
          packaged graph that ends in Detect (yolov3, -spp, -tiny; yolov5n,
          -p6; yolov6n; yolov8n, -p2, -p6, -ghost, -ghost-p2, -ghost-p6;
          yolov9t, s, m, c, e; yolo12n): boxes inside the frames, no kernel
          launched (these graphs hold no SwinBlock), and each raw Detect map
          and decoded channel within 3e-2 of the fp32 unfused forward of the
          same weights (TF32 off); yolov9c and yolo12s at full width: the
          forward's ms at batch 32 (bf16, folded) with its device time by
          kernel, 8 micro-steps as the train phase runs them (K2 once each)
          and one micro-step with K2 vs the plain assigner in bf16 and fp32
          (grads per graph row), micro-step ms; one micro-step each of
          yolov8s-p2 and yolov8s-p6 (four anchor levels) with K2 and with
          the plain assigner, and K2 alone at their grids (B=16, A=34,000
          and 8,500, G=128, nc=1) against its plain version, timed, beside
          its bound; YOLO("yolo12s.yaml").train for one epoch on the fit
          phase's dataset (K2 per micro-step) and YOLO(best.pt).val, with
          train and val img/s
  v10     YOLOv10: YOLO(name).predict of the slice phase's frames at 640
          px, bf16, BN-folded, seeded weights, for yolov10n, s, m, b, l and
          x: no kernel launched, the (8, 300, 6) NMS-free detections' boxes
          inside the frames, each raw map of both branches, the one-to-one
          decode's channels and the sorted scores within 3e-2 of the fp32
          unfused forward; yolov10s at full width: the forward's ms at batch
          32 with its device time by kernel, a .pt2 program asked for with
          nms=True (dropped: the sidecar says end2end) served by Backend
          bit for bit with the live model, 8 micro-steps as the train phase
          runs them with K2 launched twice each (topk 10 and 1) and one
          micro-step against the plain assigner in bf16 and fp32, micro-step
          ms; YOLO("yolov10s.yaml").train for one epoch on the fit phase's
          dataset (K2 twice per micro-step) and YOLO(best.pt).val
  segment instance segmentation: YOLO(name).predict of the slice phase's
          frames at 640 px, bf16, BN-folded, seeded weights with the class
          priors zeroed (conf 0.25), for yolov8n-seg, -seg-p6, yolo11n-seg,
          yolo12n-seg, yolov9c-seg and yolov9e-seg: no kernel launched,
          masks (n, 480, 640) bool, each raw map, the mask coefficients and
          the prototypes within 3e-2 of the fp32 unfused forward (the
          decoded channels reported); yolov8s-seg at full width: the forward's
          ms at batch 32 with its device time by kernel, predict img/s at
          batch 32 with and without retina_masks (every mask inside its box
          by one pixel, or one prototype cell), the predictor's device masks
          against the same post-processing in fp32 on the CPU and one
          frame's masks' ms, 4 micro-steps at batch 16 on overlap maps (K2
          once each), the step's ms and the card's peak memory, one
          micro-step against the plain assigner (loss items, bf16 grads);
          YOLO("yolov8s-seg.yaml").train for one epoch on a seeded PNG
          dataset with polygon labels (the loader's instance-aware host
          stack; K2 once per micro-step) and YOLO(best.pt).val against the
          trainer's box and mask metrics; Masks.xy of one served frame's
          masks (up to 300) with its host ms; one epoch (no val) with
          copy_paste 0.5 in each mode, flip and mixup, K2 once per micro-step
  pose    pose estimation: YOLO(name).predict of the slice phase's frames at
          640 px, bf16, BN-folded, seeded weights with the class priors
          zeroed (conf 0.25), for yolov8n-pose, -pose-p6, yolo11n-pose and
          yolo12n-pose: no kernel launched, keypoints (n, 17, 3) inside the
          frames, each raw map and the raw keypoints within 3e-2 of the fp32
          unfused forward (the decoded channels reported); yolov8s-pose at
          full width: the forward's ms at batch 32 with its device time by
          kernel, predict with keypoints at batch 32 from frames in memory
          (img/s), the predictor's keypoints on the card against the same
          function on the CPU (bit for bit), YOLO.track of the 8 frames with
          bytetrack.yaml (keypoints kept in the detections' order), 4
          micro-steps at batch 16 (K2 once each) and one against the plain
          assigner (five loss items, bf16 grads), the step's ms;
          YOLO("yolov8s-pose.yaml").train for one epoch on a seeded PNG
          dataset with keypoint labels (fliplr 0.5, COCO's flip_idx; K2 once
          per micro-step) and YOLO(best.pt).val with the (B) and (P) keys
          against the trainer's record; the int8 forward at batch 32 beside
          the bf16 one, an int8 predict, and the card's int8 outputs against
          the CPU's at batch 2 in fp32 (int8_full, as int8_graphs runs it)
  obb     oriented boxes: YOLO(name).predict of the slice phase's frames at
          640 px, nc 15, bf16, BN-folded, seeded weights with the class
          priors zeroed (conf 0.25), for yolov8n-obb, yolo11n-obb and
          yolo12n-obb: no kernel launched, oriented boxes (n, 7) with w >=
          h and the angle in [0, pi), each raw map and the angles within
          3e-2 of the fp32 unfused forward (the decoded channels reported);
          yolov8s-obb at full width (DOTAv1's 15 classes, 1024 px): the
          forward's ms at batch 16 with its device time by kernel, predict
          at batch 16 from frames in memory (img/s, rotated NMS), the card's
          rotated NMS rows and oriented boxes against the same functions on
          the CPU on the same prediction, YOLO.track of the 8 frames
          (oriented boxes kept in the detections' order), 4 micro-steps at
          batch 16 with max_gt 300 (no kernel: the rotated assigner is
          plain PyTorch, as the JAX package's is plain JAX) with the step's
          ms and peak memory, the OBB loss on the card against the CPU in
          fp32 (items and grads), autobatch's measure;
          YOLO("yolov8s-obb.yaml").train for one epoch at 1024 px on a
          seeded PNG dataset of rotated rectangles (degrees 10) and
          YOLO(best.pt).val with OBBValidator's (B) keys against the
          trainer's record; int8_full of yolov8s-obb at 640 px
  classify  image classification: the six *-cls* graphs (yolov8s-cls,
          yolov8-cls-resnet50 and -resnet101, yolo11s-cls, yolo11-cls-resnet18,
          yolo12s-cls; nc 1000, seeded weights): YOLO(name).predict of the
          slice phase's frames at 224 px in bf16, BN-folded (no kernel
          launched, probs summing to 1) and its forward against the fp32
          unfused forward (TF32 off), the logits within CLS_RTOL of their
          largest magnitude; yolov8s-cls at full width: the forward's ms at batch
          64 with its device time by kernel, predict at batch 64 from frames
          in memory (img/s), 4 micro-steps at batch 32 (bf16 over fp32
          masters, dropout 0.1: the step's ms and peak memory) and one of
          yolov8-cls-resnet50; a seeded image folder (10 classes, 48 train and
          8 val PNGs each, about 256 px) written with the stdlib;
          YOLO("yolov8s-cls.yaml").train for two epochs at batch 16 on it
          (RandAugment, erasing 0.4, dropout 0.1; top1 and top5 each epoch)
          and YOLO(best.pt).val against the trainer's record; best.pt
          quantized on 16 val images, its top-1 on the 80 val images against
          the bf16 model's and its forward's ms beside the bf16 one's at
          batch 64; yolov8s-cls exported with a static batch of 8 and with a
          dynamic batch, each served by YOLO(path) against the live model's
          probs; no kernel launched on any of these paths
  rtdetr  RT-DETR: rtdetr-l (nc 80, 640 px, seeded weights, the score heads'
          bias priors zeroed): its bf16 BN-folded forward against the fp32
          one at batch 2 (TF32 off; queries matched by their anchor: the
          share shared, boxes and scores, the same top-1 class per kept
          query); the forward's ms at batch 32 with its device time by kernel
          (grid_sampler's and the sort's shares) and, by events, the six
          decoder layers and the top-k alone; RTDETR(...).predict of the slice
          phase's frames at batch 32 (img/s) and YOLO.val on 16 seeded PNGs; 8
          micro-steps at batch 16 (bf16 over fp32 masters, max_gt 32, the
          denoising group, the Hungarian-matched loss: the step's ms, the
          assignment's host ms, the peak memory); one micro-step's loss items
          in fp32 on the card against the CPU's (batch 2, the same weights,
          batch and draws); the other four RT-DETR YAMLs' bf16 folded forward
          against fp32 the same way; no kernel launched on any of these paths
  world   YOLO-World: yolov8s-worldv2 (BN contrastive heads) and
          yolov8s-world (ImagePoolingAttn) at 640 px, seeded weights brought
          to unit gain (unit_gain), the 80 COCO names as prompts through the
          hash projection (ready), the contrastive heads' class prior (-10)
          zeroed where detections are needed: YOLO.predict of the slice
          phase's frames in bf16 (boxes named by the prompts, no kernel);
          the fp32 unfused forward (TF32 off) against the same model's on
          the CPU within WORLD_CPU_RTOL, and the bf16 folded forward's gap
          to it within WORLD_BF16_SLACK of the CPU's own bf16 gap; both
          forwards' ms at batch 32 with their device time by kernel;
          YOLOWorld's predict at batch 32 (img/s, every anchor over conf:
          NMS at full load); set_classes to 3 prompts (the output 4 + 3
          wide, the classes among them); 8 micro-steps at batch 16 (K2 once each,
          at nc 80) and one against the plain assigner in bf16 and fp32 (loss
          items, grads per graph row), the micro-step's ms; the int8 forward
          at batch 32 beside the bf16 one, its outputs' gap to bf16, an
          int8 predict and the card's int8 outputs against the CPU's
          (int8_full); YOLO("yolov8s-worldv2.yaml").train for one epoch on
          the fit phase's dataset (K2 once per micro-step at its one name)
          with val, and YOLO(best.pt) reloaded with that name's features and
          validated; its int8 program is in the programs process
  int8_graphs  int8 of the graphs added since the fork's: yolov9c, yolov10s
          and yolov8s-seg at full width, quantized (bf16 compute over fp32
          weights, BN-folded) on the int8 phase's two seeded batches of 8:
          the int8 forward's ms at batch 32 beside the bf16 model's (CUDA
          events), the int8 outputs' gap to bf16, an int8 predict of the
          slice phase's frames (no kernel), and the same graph quantized in
          fp32 compute held on the card (TF32 off) to its copy on the CPU at
          batch 2 (INT8_CPU_MAX, INT8_CPU_MEAN, INT8_CPU_SLACK of the CPU's
          own gap under a one-ulp change of the input; the share of values
          moved);
          rtdetr-l (query paths drawn, score priors zeroed) quantized the
          same way: its input projections int8, its queries against the bf16
          model's matched by anchor (RTDETR_INT8_SHARED, RTDETR_INT8_TOP1),
          both forwards' ms, an int8 predict; every other packaged detect,
          v10 and seg graph at its smallest scale quantized on one batch of 8
          and run once at batch 8: finite outputs
  programs  a second process started after the kernel phase and joined
          after the profile phase (--programs): dynamic .pt2 programs of
          yolov9t, yolo12n, yolov3-tiny, yolov8s-seg, yolov8s-pose and
          yolov8s-obb (bf16), the int8 programs of yolov10s and
          yolov8s-seg, rtdetr-l's bf16 programs (static at batch 3 and
          dynamic; its NMS-free queries) and yolov8s-worldv2's dynamic int8
          program at the COCO prompts, exported on the card at 640 px with
          the class priors zeroed, each loaded with YOLO(path) and its
          predict held bit for bit (boxes, and masks for seg, keypoints for
          pose, oriented boxes for obb) to the live model's at batches 1 and
          3 (the static program at its batch), with each export's and load's
          seconds
  yolo11  the fork's YOLO11 graph, YOLO("yolo11m-cbam-swin.yaml") at 640 px,
          seeded weights (Swin blocks at (B, 40, 40, 512)): predict on the
          slice phase's frames in bf16 (K1 counted, 2 per batch) and its
          forward against the plain Swin version in bf16 and in fp32; 4 train
          micro-steps at batch 16 (K1, K3, K2 counted, 2, 2 and 1 each) and
          one micro-step with the kernels against one with the plain
          versions, as the train phase holds them; YOLO.train for one epoch
          on the fit phase's dataset with validation (launches per micro-step
          and per val batch) and YOLO(best.pt).val; forward img/s at batch 32
          with its device time by kernel, and train img/s at batch 16
  flagship_l  YOLO("yolov8l-cbam-swin.yaml"), the flagship at scale l (Swin
          at C=512): one predict batch of the 8 frames and its forward
          against the plain Swin version, and one train micro-step, each with
          its launches counted
  yolo11_int8  int8 PTQ of the fork's YOLO11 graph: yolo11m (Swin C=512)
          quantized on the int8 phase's two seeded batches of 8, then
          YOLO.predict on the slice phase's frames (K4 2 launches a batch, no
          K1), grouped convs on their float path; each SwinBlock's K4 vs its
          plain version on the input it receives, and the int8 model with K4
          vs with the plain version; int8 forward ms at batch 32 beside the
          float forward's, device time by kernel of both, int8 predict img/s;
          the int8 yolo11m exported with dynamic=True, loaded and held bit
          for bit to the live int8 model at batches 1 and 8 (K4 2 launches a
          call); one int8 predict batch of yolo11x (Swin C=768, K4 2
          launches) with its SwinBlocks held the same way
  profile_models  ProfileModels' rows (params, GFLOPs, sigma-clipped ms at
          batch 1, 640 px) for yolov8s-cbam-swin and yolo11m-cbam-swin; the
          flagship's trainer with batch=-1 (autobatch) and one micro-step at
          the batch it picked (launches, peak memory)
  speed   predict img/s at batch 32, 640 px, bf16, BN-folded (forward alone
          and end to end) and train img/s at batch 16, with and without the
          device augmentation
  profile device time by kernel over batch-32 forwards, bf16 and int8, and
          over one accumulation cycle of the train step (torch.profiler)
Then the card's name and power limit, the {"kernels": [...]} line (K1, K3
and K4 with their achieved TFLOP/s or TOP/s, time over bound, shared memory
(K1 also at the two grids that only test-time augmentation hands it, `tta`)
and registers, K1 and K4 (whose wrappers now call PyTorch operators) with
their device time (CUDA-graph replay) and host time per call, K3 with its
workspace, K4 with its library's IMMA, HMMA and IDP4A counts, K2 with its
device time, its candidate pairs, the dense
bound beside its bound, its registers, stack frame and spills, its rows at
the families phase's four-level grids, at topk 1 and at the World path's 80
classes), and last {"ok": true, "device": {...}}. Without CUDA
it prints no result and exits 2.

--k2 PARENT_DIR times K2 alone at the train path's shape (B=16, A=8400,
G=128, nc=1, chip_smoke's seeded inputs), with the port of PARENT_DIR (a
checkout unpacked with git archive) and of this checkout in turns: parent,
this, this, parent, each in its own process, one JSON line each (k2_run).

--predict PARENT_DIR times YOLO.predict at batch 32 (the speed phase's
seeded weights and frames) in five pairs of turns, parent first in every
other pair, one process each: the img/s of 8 calls on in-memory frames
after a warm-up, and, for this checkout, of 8 calls on the same frames
read from PNG files (predict_run).

--programs DIR runs the programs phase's process alone, writing
DIR/programs.json (programs_run).
--fit PARENT_DIR times YOLO.train on the device augmentation path (the fit
phase's seeded PNG dataset and settings, 4 epochs, mosaic closed for the
last 2, after a warm-up epoch) with the port of PARENT_DIR and of this
checkout, this one with TensorBoard on and off, in five rounds of the
three, each run in its own process: each epoch's train img/s with the
loader, the loader's wait and the rest of the loop per micro-step (the
trainer's epoch_stats, host clock), one JSON line each (fit_run), then the
medians over the epochs of every run of each variant and each run's own.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import itertools
import json
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
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
# operations of one candidate (GT, anchor) pair in the assigner (csrc/tal_assign.cu pair()):
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
# the fit phase: YOLO.train's settings (save_period 1 keeps epoch 1's checkpoint for the resume check)
FIT = {"epochs": 2, "batch": 16, "imgsz": 640, "nbs": 64, "optimizer": "SGD", "max_gt": MAX_GT,
       "close_mosaic": 1, "workers": 8, "seed": SEED, "save_period": 1, "verbose": False}
FIT_TRAIN, FIT_VAL = 64, 32
# the fit_host phase: YOLO.train on the loader's host augmentation stack with every transform it adds to the device
# path's, multi_scale, the RAM image cache, plots, save_json and a callback on every event
FIT_HOST = {"epochs": 2, "batch": 16, "imgsz": 640, "nbs": 64, "optimizer": "SGD", "max_gt": MAX_GT,
            "close_mosaic": 1, "workers": 8, "seed": SEED, "verbose": False, "device_augment": False,
            "mosaic9": 0.5, "mixup": 0.5, "degrees": 10.0, "shear": 2.0, "perspective": 5e-4, "flipud": 0.5,
            "multi_scale": True, "cache": "ram", "plots": True, "save_json": True}
# YOLO(best.pt).val against the metrics the trainer recorded for that epoch:
# the same graph, dtypes, weights and images, so equal but for the order of
# cuDNN's sums, should it pick another algorithm: FIT_RECORD_ATOL on each metric
FIT_RECORD_ATOL = 1e-6
# val with K1 vs with its plain version, on best.pt's weights and the val
# images, in bf16 (the trainer's val) and in fp32 (TF32 off). The K1 gate on
# the val path is what NMS receives: the forward's outputs on the val
# batches, held as the slice phase holds them (each SwinBlock layer, Detect
# map and decoded channel within FIT_FORWARD_RTOL of the largest magnitude).
# The detections after NMS are not held: with these barely trained weights
# many anchors' scores lie within rounding of each other, and NMS resolves
# such ties either way, so even fp32 forwards that agree to 1e-6 keep other
# boxes (H100, PERF.md section 6). The metrics are held in fp32 only, each
# within FIT_FP32_METRIC_RTOL of its own size: the fp32 forwards agreed to
# 1.1e-6 and the metrics to 1.7 % (mAP50-95), the gap of those near ties, so
# the limit is three times the largest reading. In bf16 the same ties move
# with the rounding of every layer, and the metrics are reported, not held
FIT_FORWARD_RTOL = {"bf16": 3e-2, "fp32": 2e-3}
FIT_FP32_METRIC_RTOL = 5e-2
# each SwinBlock of the int8 model, int8 vs float on the input it receives
# there: the JAX package's oracle bounds for the int8 block
# (tests/test_pallas_swin.py:130-131): mean |int8 - float| under 0.05 of mean
# |float|, max under 0.25 of max |float|. The same measure between the whole
# int8 and float models at each Swin layer adds the int8 convs upstream; it
# is reported beside it
ORACLE_MEAN, ORACLE_MAX = 0.05, 0.25
# the fork's second graph, and the flagship at the first scale whose Swin
# blocks (C=512) need the kernels' wide layouts; the Swin widths the two
# graphs build above the flagship's 256 (flagship m 384, l 512, x 640; YOLO11
# m and l 512, x 768), all with 2 heads
YOLO11, FLAGSHIP_L = "yolo11m-cbam-swin.yaml", "yolov8l-cbam-swin.yaml"
WIDE_FWD, WIDE_BWD, WIDE_INT8 = (384, 512, 640, 768), (512, 640, 768), (512, 768)
# K4 at yolo11x's width also at a small batch (2 images of 14x14: 32 windows), where few blocks share the card
INT8_SMALL_CASES = (((2, 14, 14, 768), 2),)
YOLO11_STEPS = 4
# the serve phase: test-time augmentation runs the model at 640, 544 and 448
# px, where the P4 Swin site is 40x40, 34x34 (padded to 35x35) and 28x28;
# K1 is timed alone at the two new grids with predict's batch of 32
TTA_SWIN_GRIDS = (40, 34, 28)
TTA_K1_SHAPES = ((32, 34, 34, 256), (32, 28, 28, 256))
# the launches of one predict batch, one train micro-step and one val batch
PREDICT_LAUNCHES = {"swin_block_fwd": 2, "swin_block_fwd_exact": 0, "swin_block_bwd": 0, "tal_assign": 0,
                    "swin_block_int8": 0, "swin_block_int8_sm16": 0}
STEP_LAUNCHES = {**PREDICT_LAUNCHES, "swin_block_fwd_exact": 2, "swin_block_bwd": 2, "tal_assign": 1}
# the track phase: YOLO.track's detections above TRACK_CONF (with the class-logit biases zeroed for the phase
# (zero_class_priors), the seeded weights score their boxes about 0.5, so every frame has up to max_det, all
# above the trackers' thresholds), both packaged trackers; embed at a batch
# of EMBED_BATCH frames, from the layer before Detect (25: (B, 512) at scale s)
TRACK_CONF, TRACKERS = 0.1, ("bytetrack.yaml", "botsort.yaml")
EMBED_BATCH, EMBED_LAYER = 32, 25
# the export phase: the bf16 dynamic program's batches; a loaded program against the live model, where
# not bit for bit: the slice phase's forward tolerances (of the largest magnitude)
EXPORT_BATCHES = (1, 8, 32)
EXPORT_RTOL = {"bf16": 3e-2, "fp32": 2e-3}
# the yolo11_int8 phase: the fork's YOLO11 graph quantized at m (Swin C=512) and x (C=768), both with heads of
# a multiple of 128, so K4 runs in place of K1: the launches of one int8 predict batch; the batches at which the
# int8 program with a dynamic batch is held to the live int8 model
YOLO11X = "yolo11x-cbam-swin.yaml"
INT8_PREDICT_LAUNCHES = {**PREDICT_LAUNCHES, "swin_block_fwd": 0, "swin_block_int8": 2}
YOLO11_INT8_PROGRAM_BATCHES = (1, 8)
# the profile_models phase: ProfileModels' rows (batch 1, 640 px) and the flagship's autobatch
PROFILE_MODELS = ("yolov8s-cbam-swin.yaml", YOLO11)
# the families phase: every packaged detect graph that ends in Detect, at scale n where the file has scales; the
# two that run at full width (RepNCSPELAN4 and ADown; A2C2f's area attention); the P2 and P6 graphs, whose train
# step hands K2 four anchor levels, and K2 alone at their grids (B=16, G=128, nc=1 at 640 px: A 34,000 and 8,500).
# A graph without a SwinBlock launches no kernel to predict and K2 once per train micro-step.
FAMILIES = ("yolov3.yaml", "yolov3-spp.yaml", "yolov3-tiny.yaml", "yolov5n.yaml", "yolov5n-p6.yaml", "yolov6n.yaml",
            "yolov8n.yaml", "yolov8n-p2.yaml", "yolov8n-p6.yaml", "yolov8n-ghost.yaml", "yolov8n-ghost-p2.yaml",
            "yolov8n-ghost-p6.yaml", "yolov9t.yaml", "yolov9s.yaml", "yolov9m.yaml", "yolov9c.yaml", "yolov9e.yaml",
            "yolo12n.yaml")
FAMILIES_FULL = ("yolov9c.yaml", "yolo12s.yaml")
FAMILIES_LEVELS = (("yolov8s-p2.yaml", (4, 8, 16, 32)), ("yolov8s-p6.yaml", (8, 16, 32, 64)))
FAMILY_PREDICT_LAUNCHES = dict.fromkeys(PREDICT_LAUNCHES, 0)
FAMILY_STEP_LAUNCHES = {**FAMILY_PREDICT_LAUNCHES, "tal_assign": 1}
V10 = ("yolov10n.yaml", "yolov10s.yaml", "yolov10m.yaml", "yolov10b.yaml", "yolov10l.yaml", "yolov10x.yaml")
V10_FULL = "yolov10s.yaml"
V10_STEP_LAUNCHES = {**FAMILY_PREDICT_LAUNCHES, "tal_assign": 2}  # one-to-many at topk 10, one-to-one at topk 1
V10_RTOL = 3e-2  # bf16 folded against fp32 unfused, of the largest magnitude (the families phase's)
# the segment phase: the six packaged seg YAMLs at their smallest scale, yolov8s-seg at full width; bf16 folded
# against fp32 unfused within SEG_RTOL of the largest magnitude (the families phase's); the predictor's device
# masks against the same post-processing in fp32 on the CPU on at most SEG_MASK_SHARE of the pixels; a micro-step's
# four loss items with K2 against the plain assigner within SEG_ITEM_RTOL, its bf16 grads bit for bit or within
# SEG_GRAD_RTOL per graph row; a mask outside its box by at most one pixel (retina_masks) or one prototype cell
SEG = ("yolov8n-seg.yaml", "yolov8n-seg-p6.yaml", "yolo11n-seg.yaml", "yolo12n-seg.yaml", "yolov9c-seg.yaml",
       "yolov9e-seg.yaml")
SEG_FULL = "yolov8s-seg.yaml"
SEG_RTOL, SEG_MASK_SHARE, SEG_ITEM_RTOL, SEG_GRAD_RTOL = 3e-2, 1e-3, 1e-5, 1e-3
SEG_BATCH, SEG_STEPS, SEG_MASKS = 32, 4, 256  # predict's batch; micro-steps counted; the loss's masks per image
SEG_COPY_PASTE = 0.5  # the segment phase's copy_paste epochs, one in each mode
# the int8_graphs phase: three graphs quantized at full width (yolov9c: RepNCSPELAN4 with RepConv's branches
# float; yolov10s: SCDown, PSA and v10Detect; yolov8s-seg: Proto and Segment), their int8 forward timed at
# INT8_GRAPH_BATCH beside the bf16 one; every other packaged detect, v10 and seg graph quantized at its smallest
# scale and run once at batch 8. The card's int8 graph in fp32 compute (TF32 off) against the same quantized
# model on the CPU at batch 2: the int8 sums are exact on both, but the float layers (BN-folded biases, grouped
# and transposed convs, attention) sum in another order, which can move a value across the next conv's
# quantization boundary, a level that the layers after it carry: each output within INT8_CPU_MAX of its
# largest magnitude, or within INT8_CPU_SLACK times the CPU's own gap when its input moves by one ulp where that
# is larger (a graph at unit gain, the world phase's: there a flipped level cascades, and a one-ulp change of the
# input moves the CPU's decoded output up to 2e-1 of its largest magnitude, its mean 3e-4), and within
# INT8_CPU_MEAN on average; the share of its values that moved reported
INT8_FULL = ("yolov9c.yaml", "yolov10s.yaml", "yolov8s-seg.yaml")
INT8_SWEEP = tuple(c for c in FAMILIES + V10 + SEG if c not in INT8_FULL)
INT8_GRAPH_BATCH = 32
INT8_CPU_MAX, INT8_CPU_MEAN, INT8_CPU_SLACK = 5e-2, 5e-3, 2.0
# the pose phase: the four packaged pose YAMLs at their smallest scale, yolov8s-pose at full width; bf16 folded
# against fp32 unfused within POSE_RTOL of the largest magnitude (the families phase's); a micro-step's five loss
# items with K2 against the plain assigner within POSE_ITEM_RTOL, its bf16 grads bit for bit or within
# POSE_GRAD_RTOL per graph row (the segment phase's); the forward and predict timed at POSE_BATCH; the fit epoch's
# dataset carries COCO's flip_idx
POSE = ("yolov8n-pose.yaml", "yolov8n-pose-p6.yaml", "yolo11n-pose.yaml", "yolo12n-pose.yaml")
POSE_FULL = "yolov8s-pose.yaml"
POSE_RTOL, POSE_ITEM_RTOL, POSE_GRAD_RTOL = 3e-2, 1e-5, 1e-3
POSE_BATCH, POSE_STEPS = 32, 4
POSE_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
# the obb phase: the three packaged OBB YAMLs at their smallest scale, yolov8s-obb at full width (DOTAv1's 15
# classes, 1024 px, a train batch of 16 with up to 300 GT boxes an image); bf16 folded against fp32 unfused within
# OBB_RTOL of the largest magnitude (the families phase's); the card's rotated NMS rows against the CPU's on the
# same prediction, at most OBB_NMS_ROW_SHARE of them moved (a probiou within an ulp of the threshold); the OBB loss
# on the card against the CPU in fp32: the items within OBB_ITEM_RTOL, each grad within OBB_GRAD_RTOL of its norm
OBB_GRAPHS = ("yolov8n-obb.yaml", "yolo11n-obb.yaml", "yolo12n-obb.yaml")
OBB_FULL = "yolov8s-obb.yaml"
OBB_NC, OBB_IMGSZ, OBB_BATCH, OBB_STEPS, OBB_MAX_GT = 15, 1024, 16, 4, 300
OBB_RTOL, OBB_NMS_ROW_SHARE, OBB_ITEM_RTOL, OBB_GRAD_RTOL = 3e-2, 1e-2, 1e-4, 1e-3
# the programs process (--programs): dynamic .pt2 programs exported on the card, each loaded with YOLO(path) and
# held bit for bit to its live model at PROGRAM_BATCHES (boxes, masks and keypoints), class priors zeroed
FLOAT_PROGRAMS = ("yolov9t.yaml", "yolo12n.yaml", "yolov3-tiny.yaml", "yolov8s-seg.yaml", "yolov8s-pose.yaml",
                  "yolov8s-obb.yaml")
INT8_PROGRAMS = ("yolov10s.yaml", "yolov8s-seg.yaml")
PROGRAM_BATCHES = (1, 3)
# and rtdetr-l's bf16 programs, static at batch 3 (held at that batch) and dynamic, and yolov8s-worldv2's dynamic
# int8 program at the COCO prompts: (cfg, kind, dynamic)
QUERY_WORLD_PROGRAMS = (("rtdetr-l.yaml", "bf16", False), ("rtdetr-l.yaml", "bf16", True),
                        ("yolov8s-worldv2.yaml", "int8", True))
STATIC_PROGRAM_BATCH = 3
# the classify phase: the six *-cls* graphs' forwards at 224 px (bf16 BN-folded against the fp32 unfused forward,
# TF32 off: the logits within CLS_RTOL of their largest magnitude); yolov8s-cls at full width (nc 1000) and its
# training on a seeded image folder of CLS_NC classes (CLS_TRAIN and CLS_VAL PNGs of 256 px a class; 60 micro-steps,
# so that the BatchNorm statistics that eval reads have moved); its int8 model's top-1 against the bf16 model's on
# the val images (at least CLS_INT8_AGREE of them the same); its programs' probs within CLS_PROGRAM_RTOL of the live
# model's largest probability
CLS_GRAPHS = ("yolov8s-cls.yaml", "yolov8-cls-resnet50.yaml", "yolov8-cls-resnet101.yaml", "yolo11s-cls.yaml",
              "yolo11-cls-resnet18.yaml", "yolo12s-cls.yaml")
CLS_FULL, CLS_RESNET = "yolov8s-cls.yaml", "yolov8-cls-resnet50.yaml"
CLS_IMGSZ, CLS_BATCH, CLS_NC, CLS_TRAIN, CLS_VAL = 224, 64, 10, 48, 8
CLS_FIT = {"epochs": 2, "batch": 16, "nbs": 16, "imgsz": CLS_IMGSZ, "optimizer": "SGD", "lr0": 0.01,
           "warmup_epochs": 0.0, "erasing": 0.4, "auto_augment": "randaugment", "dropout": 0.1, "workers": 8,
           "seed": SEED, "save_period": -1}
CLS_RTOL, CLS_INT8_AGREE, CLS_PROGRAM_RTOL = 3e-2, 0.8, 1e-2
# the rtdetr phase: rtdetr-l (nc 80, 640 px) at full width and the other four RT-DETR YAMLs, seeded weights with
# the score heads' bias priors zeroed. The bf16 BN-folded forward against the fp32 unfused one (TF32 off) at batch
# RTDETR_CHECK_BATCH: the two select their queries by a top-k over 8400 anchors' scores that bf16 rounds, so the
# queries are matched by their anchor; at least RTDETR_SHARED of the fp32 queries' anchors are selected in bf16 too,
# those queries' boxes (normalised) and scores within RTDETR_ATOL; each kept query (score over 0.25) whose top-1
# class differs must have had its fp32 top two within RTDETR_FLIP_MARGIN (a near tie that the rounding decides: the
# seeded class scores of 80 classes often lie that close; sound runs read at most 6.9e-3), and the share with the
# same top-1 is reported. Every check draws the weights that the seeded init zeroes in the head (the box heads' last
# layers, the deformable attention's sampling_offsets and attention_weights) from a normal of std RTDETR_DRAW_STD
# (draw_query_paths), so that the boxes leave their anchors and the sampling depends on the query. The forward and predict at RTDETR_BATCH; RTDETR_STEPS micro-steps at RTDETR_STEP_BATCH (max_gt MAX_GT:
# the denoising group of 3 x 2 x 32 queries); one micro-step's loss on the card against the CPU's in fp32 at batch
# RTDETR_CPU_BATCH with the same weights, batch and denoising draws: the head alone, fed the CPU's feature maps, its
# total and items within RTDETR_ITEM_RTOL, and where a matched layer's assignment differs, both assignments' total
# costs (the CPU's costs) within RTDETR_TIE_RTOL of each other: a near tie (untrained boxes give many assignments of
# equal cost); the whole model's total within RTDETR_ITEM_RTOL (its last layer's items are reported beside the
# CPU's own change under a 1e-6 scaling of its input: the seeded train-mode graph amplifies a rounding to 2e-3 in
# them); val on RTDETR_VAL seeded PNGs
RTDETR_FULL = "rtdetr-l.yaml"
RTDETR_OTHERS = ("rtdetr-x.yaml", "rtdetr-resnet50.yaml", "rtdetr-resnet101.yaml", "yolov8-rtdetr.yaml")
RTDETR_BATCH, RTDETR_STEP_BATCH, RTDETR_STEPS, RTDETR_CHECK_BATCH, RTDETR_CPU_BATCH, RTDETR_VAL = 32, 16, 8, 2, 2, 16
RTDETR_SHARED, RTDETR_ATOL, RTDETR_ITEM_RTOL, RTDETR_TIE_RTOL = 0.9, 5e-2, 1e-3, 1e-5
RTDETR_FLIP_MARGIN, RTDETR_DRAW_STD = 1.5e-2, 0.02
# the int8_graphs phase's rtdetr-l: quantized on the int8 phase's frames, its queries against the bf16 model's at
# RTDETR_CHECK_BATCH, matched by anchor: at least RTDETR_INT8_SHARED of the bf16 queries' anchors selected by int8
# too, and of the kept ones (score over 0.25) that both select, at least RTDETR_INT8_TOP1 with the same top-1 class
RTDETR_INT8_SHARED, RTDETR_INT8_TOP1 = 0.5, 0.5
# the world phase: yolov8s-worldv2 (BN contrastive heads) and yolov8s-world (ImagePoolingAttn) at 640 px, seeded
# weights brought to unit gain on UNIT_GAIN_SIZE px (unit_gain), the COCO names' hash-projected text features as 80
# prompts (the train path's K2 then takes nc 80) (ready), the contrastive heads' class prior (-10) zeroed where
# detections are needed; the fp32 unfused forward on the card (TF32 off) against the same weights on the CPU: each
# raw map and decoded channel within WORLD_CPU_RTOL of its largest magnitude (on the CPU, a 2-ulp change of the input
# or of every layer's output moves them 0.9e-5 to 2e-5: the random graph amplifies a rounding; a wrong module moves
# them by O(1e-1)); bf16 folded against fp32 unfused on
# the card within WORLD_BF16_SLACK times the same gap on the CPU (a random graph at unit gain amplifies bf16's
# roundings to 5 to 30 % of the largest magnitude by the head); the forward and predict at WORLD_BATCH; a swap to
# WORLD_SWAP prompts; TRAIN_STEPS micro-steps at batch 16 (K2 once each) and one against the plain assigner
WORLD_FULL, WORLD_V1 = "yolov8s-worldv2.yaml", "yolov8s-world.yaml"
WORLD_CPU_RTOL, WORLD_BF16_SLACK, WORLD_BATCH, UNIT_GAIN_SIZE = 1e-3, 2.0, 32, 160
WORLD_SWAP = ("person", "bus", "traffic light")


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


def swin_flops(shape) -> int:
    """Operations the SwinBlock forward on x of `shape` needs: per real token
    2*C*C (q) + 2*C*2C (k, v) + 4*49*C (its attention row over the 49 keys
    of its window) + 2*C*C (out) + 16*C*C (MLP); a pad token's output is
    cropped and its k, v are one constant row, counted once."""
    b, h, w, c = shape
    return b * h * w * (24 * c * c + 4 * 49 * c) + (4 * c * c if h % 7 or w % 7 else 0)


def swin_bound(shape, dtype):
    """(ms, "operations" or "bytes"): the least time the card could take for
    the SwinBlock forward on x of `shape`: swin_flops; bytes: x read and y
    written once, weights read once."""
    b, h, w, c = shape
    nbytes = 2 * b * h * w * c * elt(dtype) + 12 * c * c * elt(dtype) + 13 * c * 4
    return bound(swin_flops(shape), nbytes, dtype)


def swin_bwd_flops(shape) -> int:
    """Operations the SwinBlock backward on x and g of `shape` needs, per real
    token: the forward recomputed as far as the grads need it, 16*C*C (qkv,
    out, fc1; fc2's output is not needed) + 4*49*C (scores, a.v); the dX
    products 24*C*C (dh = g W2, dy1n = dpre W1, do = dout Wout, dxn = dqkv
    Wqkv) + 8*49*C (dv, da, dq, dk); the dW products 24*C*C (the same four,
    over all tokens). Pad tokens are one constant row: their k, v (4*C*C),
    and their k, v grads' share of dWqkv and dxn (8*C*C), count once."""
    b, h, w, c = shape
    return b * h * w * (64 * c * c + 12 * 49 * c) + (12 * c * c if h % 7 or w % 7 else 0)


def swin_bwd_bound(shape, dtype):
    """(ms, "operations" or "bytes") for the SwinBlock backward on x and g of
    `shape`: swin_bwd_flops; bytes: x and g read, dx written, weights read
    once in x's dtype; the 12*C*C + 13*C fp32 grads written once."""
    b, h, w, c = shape
    nbytes = (3 * b * h * w * c + 12 * c * c) * elt(dtype) + (12 * c * c + 13 * c) * 4
    return bound(swin_bwd_flops(shape), nbytes, dtype)


def bwd_workspace_bytes(shape, heads, dtype) -> int:
    """Bytes of the two workspaces K3 allocates for x of `shape`
    (swin_block_bwd_workspace): the operands of the weight-grad products in
    x's dtype and the fp32 activations, partials and probabilities."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import _bwd_lib

    t_el, f_el = ctypes.c_size_t(), ctypes.c_size_t()
    _bwd_lib().swin_block_bwd_workspace(*shape, heads, ctypes.byref(t_el), ctypes.byref(f_el))
    return t_el.value * elt(dtype) + 4 * f_el.value


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled one (the last component of its nested
    name), with <bf16> or <f32> for a template kernel of that type and
    <true> or <false> for one templated on a bool (K4: the bf16 compute
    dtype)."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    rest = mangled[i:]
    tags = {"I13__nv_bfloat16": "<bf16>", "If": "<f32>", "ILb1E": "<true>", "ILb0E": "<false>"}
    return name + next((t for prefix, t in tags.items() if rest.startswith(prefix)), "")


def ptxas_summary(log: str) -> dict:
    """{kernel: {"registers", "stack_frame", "spill_stores", "spill_loads", "smem_static"}}
    from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {}
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            frame = re.search(r"(\d+) bytes stack frame", ln)
            out[name].update(spill_stores=int(st), spill_loads=int(ld), stack_frame=int(frame.group(1)) if frame else 0)
        elif name and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem_static"] = int(sm.group(1)) if sm else 0
    return out


def swin_int8_ops(shape):
    """(int8 operations, bf16 FLOP) of the int8 SwinBlock on x of `shape`:
    per real token 24*C*C int8 operations (qkv 6, out 2, fc1 8, fc2 8) and
    4*49*C bf16 FLOP of attention; a pad token's k, v (4*C*C int8) are one
    constant row, counted once."""
    b, h, w, c = shape
    tokens = b * h * w
    return tokens * 24 * c * c + (4 * c * c if h % 7 or w % 7 else 0), tokens * 4 * 49 * c


def swin_int8_tops(shape, ms: float) -> float:
    """Achieved TOP/s of the int8 SwinBlock: its int8 operations and bf16
    FLOP over the kernel time."""
    return sum(swin_int8_ops(shape)) / ms / 1e9


def swin_int8_bound(shape, x_dtype, y_dtype):
    """(ms, "operations" or "bytes") for the int8 SwinBlock on x of `shape`.
    Operations: per real token 24*C*C int8 operations (qkv 6, out 2, fc1 8,
    fc2 8) at the int8 peak plus 4*49*C bf16 FLOP of attention at the bf16
    peak; a pad token's k, v (4*C*C int8) are one constant row, counted
    once. Bytes: x read and y written once in their dtypes, the 12*C*C int8
    weights, their 12*C fp32 scales and the 13*C fp32 vectors read once."""
    b, h, w, c = shape
    tokens = b * h * w
    i8_ops, bf16_flop = swin_int8_ops(shape)
    t_ops = i8_ops / PEAK_FLOPS[torch.int8] + bf16_flop / PEAK_FLOPS[torch.bfloat16]
    t_bytes = (tokens * c * (elt(x_dtype) + elt(y_dtype)) + 12 * c * c + 4 * 25 * c) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tal_candidate_pairs(args) -> int:
    """(image, GT, anchor) pairs whose anchor centre lies strictly inside a
    valid GT, counted on the card with the plain version's gate: the only
    pairs whose align or overlap can be nonzero."""
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import select_candidates_in_gts

    _, _, anc, _, gbox, gmask = args
    return int((select_candidates_in_gts(anc, gbox) & (gmask.reshape(*gbox.shape[:2], 1) > 0)).sum())


def tal_bound(args, ncls, dense=False):
    """(ms, "operations" or "bytes") for the assigner on `args`: TAL_PAIR_FLOP
    per candidate pair (tal_candidate_pairs) on the fp32 CUDA cores, since
    the work depends on the data and the bound counts what these inputs
    need (every other pair's align and overlap are 0 by
    the gate); dense=True charges every (image, GT, anchor) pair instead, the
    bound used before the one-launch kernel. Bytes: inputs (scores, predicted
    boxes, anchors, GT labels, boxes and mask) read and outputs (labels,
    boxes, scores, fg, GT index) written once."""
    b, a, nc = args[0].shape
    g = args[4].shape[1]
    nbytes = 4 * (b * a * nc + 4 * b * a + 2 * a + 6 * b * g) + b * a * (4 + 16 + 4 * ncls + 1 + 4)
    pairs = b * g * a if dense else tal_candidate_pairs(args)
    return bound(TAL_PAIR_FLOP * pairs, nbytes, torch.float32)


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


def tal_inputs(b, g, nc, imgsz, device, seed, strides=(8, 16, 32)):
    """Assigner inputs at the shapes of the train path: sigmoid scores,
    predicted xyxy boxes and GTs in pixels over the anchors of an imgsz
    image at the levels of `strides`, 70 % of GT rows valid, plus a
    duplicated GT; and the anchor grid, (h, w, stride) per level."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.anchors import make_anchors

    grid = [(imgsz // s, imgsz // s, s) for s in strides]
    anc, st = make_anchors([(h, w) for h, w, _ in grid], strides)
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

    return (t(scores), t(pboxes), (anc * st).to(device), t(glab), t(gbox), t(gmask)), grid


def host_ms(fn, iters: int = 20) -> float:
    """Host time of fn() per call, after a synchronise, with no wait for the
    card: where it exceeds the device time, back-to-back calls (cuda_ms)
    time the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dt


def graph_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device time of fn() per call: iters calls captured in one CUDA graph,
    replayed reps times between CUDA events, so no host work is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def sass_counts(lib_path: str):
    """{"IMMA", "HMMA", "IDP4A": instructions of each kind} in a built
    library's SASS (cuobjdump -sass of the toolkit); None where the toolkit
    has no cuobjdump."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.cuda_build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True, text=True, timeout=120).stdout
    ops = {"IMMA": r"\bIMMA\b", "HMMA": r"\bHMMA\b", "IDP4A": r"\bIDP\.?4A\b"}  # dp4a is IDP.4A in SASS
    return {op: len(re.findall(rx, sass)) for op, rx in ops.items()}


def phase_build():
    """Build and load the four kernels' libraries, one nvcc each, in parallel;
    each one's ptxas summary and its tensor-core and dp4a instruction counts."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin, swin_int8, tal

    t0 = time.perf_counter()
    loaders = {"swin_block_fwd": swin._lib, "swin_block_bwd": swin._bwd_lib, "tal_assign": tal._lib,
               "swin_block_int8": swin_int8._lib}
    with ThreadPoolExecutor(len(loaders)) as ex:
        libs = dict(zip(loaders, ex.map(lambda f: f(), loaders.values())))
    ptxas = {name: ptxas_summary((Path(lib._name).parent / "build.log").read_text()) for name, lib in libs.items()}
    sass = {name: sass_counts(lib._name) for name, lib in libs.items()}
    return {"seconds": round(time.perf_counter() - t0, 3), "ptxas": ptxas, "sass": sass}


def no_tf32(fn, *args):
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn(*args)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def phase_kernel(dev):
    """Each kernel vs its plain version, TF32 off; then the width cases
    (wide_cases), whose rows also go to the kernels line."""
    fwd_ok, fwd = no_tf32(fwd_cases, dev)
    bwd_ok, bwd = no_tf32(bwd_cases, dev)
    tal_ok, tal = tal_cases(dev)
    int8_ok, int8 = int8_cases(dev)
    wide_ok, wide = no_tf32(wide_cases, dev)
    return fwd_ok and bwd_ok and tal_ok and int8_ok and wide_ok, {
        "swin_block_fwd": fwd, "swin_block_bwd": bwd, "tal_assign": tal, "swin_block_int8": int8, "widths": wide,
    }, wide


def wide_cases(dev):
    """The Swin widths of the two graphs above the flagship's 256, 2 heads:
    K1 fast and exact in bf16 and fp32 at (8, 40, 40, C), C in WIDE_FWD; K3
    in bf16 at (16, 40, 40, C), C in WIDE_BWD, and in fp32 at the padded
    (4, 20, 20, C) for 640 and 768; K4 with int8 I/O at (8, 40, 40, C), C in
    WIDE_INT8, and at INT8_SMALL_CASES. The tolerances, times and
    shared-memory checks of fwd_cases, bwd_cases and int8_cases."""
    fwd_ok, fwd = fwd_cases(dev, [((8, 40, 40, c), 2, dt, fast) for c in WIDE_FWD
                                  for dt, fast in ((torch.bfloat16, True), (torch.bfloat16, False),
                                                   (torch.float32, False))])
    bwd_ok, bwd = bwd_cases(dev, [((16, 40, 40, c), 2, torch.bfloat16) for c in WIDE_BWD]
                            + [((4, 20, 20, c), 2, torch.float32) for c in (640, 768)])
    int8_ok, int8 = int8_cases(dev, [((8, 40, 40, c), 2) for c in WIDE_INT8] + list(INT8_SMALL_CASES),
                               modes=("int8_io",))
    return fwd_ok and bwd_ok and int8_ok, {"swin_block_fwd": fwd, "swin_block_bwd": bwd, "swin_block_int8": int8}


def fwd_cases(dev, cases=None):
    """K1 at the flagship's Swin shapes, scale s and scale n, fast (predict)
    and exact (train), and at shapes whose rows (21 x 21 and 20 x 20 pad
    their windows) and channels (C=64, heads of 32) exercise the padded
    tensor-core tiles, or at `cases` ((shape, heads, dtype, fast), ...):
    fp32 within 1e-3 absolute, bf16 within 3e-2 of the output's largest
    magnitude. Each case also holds the shared memory the built library
    reports against fwd_smem_bytes, its copy for the CPU."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin as S
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block

    if cases is None:
        cases = [(shape, heads, dtype, fast)
                 for shape, heads in (((8, 42, 42, 256), 2), ((8, 40, 40, 256), 2), ((8, 14, 14, 128), 2),
                                      ((2, 21, 21, 64), 2), ((4, 20, 20, 128), 4))
                 for dtype in (torch.float32, torch.bfloat16) for fast in (True, False)]
    rows, ok = [], True
    for shape, heads, dtype, fast in cases:
        rng = np.random.default_rng(SEED)
        x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev).to(dtype)
        p = swin_params(shape[-1], rng, dev, dtype)
        y = swin_block(x, p, heads, fast=fast)
        torch.cuda.synchronize()
        ref = swin_block(x, p, heads, fast=fast, impl="plain")
        abs_err = (y.float() - ref.float()).abs().max().item()
        rerr = rel_err(y, ref)
        smem = S._lib().swin_block_fwd_smem_bytes(S._DTYPES[dtype], shape[-1], heads)
        good = bool(torch.isfinite(y.float()).all()) and (
            abs_err <= 1e-3 if dtype == torch.float32 else rerr <= 3e-2) and (
            smem == S.fwd_smem_bytes(shape[-1], heads, dtype))
        ok &= good
        bound_ms, bound_by = swin_bound(shape, dtype)
        rows.append({
            "shape": list(shape), "heads": heads, "dtype": str(dtype).split(".")[-1], "fast": fast,
            "wide": S.fwd_is_wide(shape[-1], heads, dtype),
            "max_abs_err": abs_err, "max_rel_err": rerr, "smem_bytes": smem, "ok": good,
            "kernel_us": 1e3 * cuda_ms(lambda: swin_block(x, p, heads, fast=fast)),
            "plain_us": 1e3 * cuda_ms(lambda: swin_block(x, p, heads, fast=fast, impl="plain"), iters=5),
            "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
        })
        del x, p
    return ok, rows


def bwd_errors(got, ref):
    """{name: max |got - ref| / max |ref|} over dx and the 12 grads."""
    (dx, grads), (rdx, rgrads) = got, ref
    return {"dx": rel_err(dx, rdx), **{k: rel_err(grads[k], rgrads[k]) for k in rgrads}}


def bwd_cases(dev, cases=None):
    """K3 vs swin_block_bwd_plain: dx and the 12 grads, each within
    BWD_RTOL of its largest magnitude. The parameters are fp32 masters, as
    the train path hands them; (4, 20, 20, 256) pads to 21 x 21; C=64 and
    heads of 32 exercise the padded tensor-core tiles; or `cases` ((shape,
    heads, dtype), ...). Each case also holds the shared memory the built
    library reports against bwd_smem_bytes, its copy for the CPU."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin as S
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block_bwd

    if cases is None:
        cases = [(shape, heads, dtype)
                 for shape, heads in (((16, 40, 40, 256), 2), ((4, 20, 20, 256), 2), ((2, 21, 21, 64), 2),
                                      ((4, 20, 20, 128), 4))
                 for dtype in (torch.float32, torch.bfloat16)]
    rows, ok = [], True
    for shape, heads, dtype in cases:
        rng = np.random.default_rng(SEED + 1)
        x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev).to(dtype)
        g = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev).to(dtype)
        p = swin_params(shape[-1], rng, dev, torch.float32)
        got = swin_block_bwd(x, g, p, heads)
        torch.cuda.synchronize()
        errs = bwd_errors(got, swin_block_bwd(x, g, p, heads, impl="plain"))
        finite = all(bool(torch.isfinite(t).all()) for t in (got[0].float(), *got[1].values()))
        smem = S._bwd_lib().swin_block_bwd_smem_bytes(S._DTYPES[dtype], shape[-1], heads)
        good = finite and max(errs.values()) <= BWD_RTOL[dtype] and smem == S.bwd_smem_bytes(shape[-1], heads,
                                                                                              dtype)
        ok &= good
        bound_ms, bound_by = swin_bwd_bound(shape, dtype)
        rows.append({
            "shape": list(shape), "heads": heads, "dtype": str(dtype).split(".")[-1], "ok": good,
            "max_rel_err": max(errs.values()), "rel_err": errs, "smem_bytes": smem,
            "max_abs_err_dx": (got[0].float() - swin_block_bwd(x, g, p, heads, impl="plain")[0].float()
                               ).abs().max().item(),
            "kernel_us": 1e3 * cuda_ms(lambda: swin_block_bwd(x, g, p, heads), iters=5),
            "plain_us": 1e3 * cuda_ms(lambda: swin_block_bwd(x, g, p, heads, impl="plain"), iters=3),
            "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
        })
        del x, g, p, got
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
    """K2 vs the plain assigner at the train path's shapes (640 px: A=8400;
    topk 10, and topk 1 as YOLOv10's one-to-one loss hands it), in one
    launch per call: its time per call by events over back-to-back
    calls (host work included) and on the device alone (graph_ms), beside
    the bound over the candidate pairs and the dense bound."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import launch_config, tal_assign_cuda
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    rows, ok = [], True
    for b, g, nc, k in ((16, 4 * MAX_GT, 1, 10), (16, MAX_GT, 80, 10), (16, 4 * MAX_GT, 1, 1)):
        args, grid = tal_inputs(b, g, nc, 640, dev, SEED + g)
        before = tal_assign_cuda.launches
        got = task_aligned_assign(*args, topk=k, num_classes=nc, grid=grid)
        torch.cuda.synchronize()
        one_launch = tal_assign_cuda.launches == before + 1
        row = tal_compare(got, task_aligned_assign(*args, topk=k, num_classes=nc, impl="plain"))
        ok &= row["ok"] and one_launch
        cs, smem, held = launch_config(b, args[0].shape[1], g, k)
        rows.append({
            "b": b, "g": g, "a": args[0].shape[1], "nc": nc, "topk": k, **row, "one_launch": one_launch,
            "fg_anchors": int(got.fg_mask.sum()), "candidate_pairs": tal_candidate_pairs(args),
            "blocks_per_image": cs, "smem_bytes": smem, "clusters_held_at_once": held,
            "kernel_us": 1e3 * cuda_ms(lambda: task_aligned_assign(*args, topk=k, num_classes=nc, grid=grid)),
            "kernel_device_us": 1e3 * graph_ms(lambda: task_aligned_assign(*args, topk=k, num_classes=nc,
                                                                           grid=grid)),
            "plain_us": 1e3 * cuda_ms(lambda: task_aligned_assign(*args, topk=k, num_classes=nc, impl="plain"),
                                      iters=5),
            "bound_us": 1e3 * tal_bound(args, nc)[0], "dense_bound_us": 1e3 * tal_bound(args, nc, dense=True)[0],
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


def int8_cases(dev, cases=(((8, 40, 40, 256), 2), ((32, 40, 40, 256), 2)),
               modes=("int8_io", "bf16_io", "sm16_int8_io")):
    """K4 at the int8 path's Swin shapes, batch 8 (predict) and 32 (speed),
    bf16 compute (or at `cases`, (shape, heads), ...): int8 I/O as the int8
    path runs it, bf16 I/O, and the bf16 softmax (sm16, K4v) with int8 I/O
    (or `modes` of these); fp32 weights quantized as quantize_model does,
    activation scales from the input; and the shared memory the built
    library asks for at each C against smem_bytes, the wrapper's copy of it
    for the CPU, with the global scratch bytes a launch at the shape takes
    (the wide layouts' residual stream); times by events over back-to-back
    calls and on the device alone (graph_ms)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin_int8 import q8, swin_block_int8

    rows, ok = [], True
    for shape, heads in cases:
        c = shape[-1]
        smem = S8._lib().swin_block_int8_smem_bytes(c, heads, 1)
        ok &= smem == S8.smem_bytes(c, heads, True)
        rng = np.random.default_rng(SEED + 3)
        x = torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev).to(torch.bfloat16)
        p = swin_params(c, rng, dev, torch.float32)
        q = swin_quant(x, p, heads)
        xq = q8(x.float(), q["x_in_scale"]).to(torch.int8)
        for mode, xin, kw in (("int8_io", xq, dict(in8=True, out8=True)), ("bf16_io", x, {}),
                              ("sm16_int8_io", xq, dict(in8=True, out8=True, sm16=True))):
            if mode not in modes:
                continue
            y = swin_block_int8(xin, p, q, heads, **kw)
            torch.cuda.synchronize()
            row = int8_compare(y, swin_block_int8(xin, p, q, heads, impl="plain", **kw))
            ok &= row["ok"]
            ms = cuda_ms(lambda: swin_block_int8(xin, p, q, heads, **kw))
            bound_ms, bound_by = swin_int8_bound(shape, xin.dtype, y.dtype)
            rows.append({
                "shape": list(shape), "heads": heads, "mode": mode, "out_dtype": str(y.dtype).split(".")[-1], **row,
                "wide": S8.int8_is_wide(c, heads, True),
                "stream_in_global": S8.int8_stream_in_global(c, heads, True),
                "scratch_bytes": S8._lib().swin_block_int8_scratch_bytes(*shape, heads, 1),
                "kernel_us": 1e3 * ms, "tops": swin_int8_tops(shape, ms),
                "device_us": 1e3 * graph_ms(lambda: swin_block_int8(xin, p, q, heads, **kw)),
                "plain_us": 1e3 * cuda_ms(lambda: swin_block_int8(xin, p, q, heads, impl="plain", **kw), iters=3),
                "bound_us": 1e3 * bound_ms, "bound_by": bound_by, "smem_bytes": smem,
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
    results = yolo.predict(frames, imgsz=640, conf=0.001, batch=8, verbose=False)
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


def same_detections(a, b) -> bool:
    """The same frames' Results, box for box and bit for bit."""
    return len(a) == len(b) and all(np.array_equal(x.boxes.data, y.boxes.data) for x, y in zip(a, b))


def same_state(m1, m2) -> bool:
    s1, s2 = m1.state_dict(), m2.state_dict()
    return s1.keys() == s2.keys() and all(s1[k].dtype == s2[k].dtype and torch.equal(s1[k], s2[k]) for k in s1)


def same_tree(a, b) -> bool:
    """Nested dicts and lists with equal leaves: arrays and tensors by dtype, shape and bits."""
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list) or isinstance(b, list):
        return isinstance(a, list) and isinstance(b, list) and len(a) == len(b) and all(map(same_tree, a, b))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(
            a.cpu(), b.cpu())
    if isinstance(a, (np.ndarray, np.generic)):
        return np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def write_pngs(frames, root: Path) -> list:
    root.mkdir(parents=True, exist_ok=True)
    paths = [root / f"frame{i:02d}.png" for i in range(len(frames))]
    for f, p in zip(frames, paths):
        p.write_bytes(png_bytes(np.ascontiguousarray(f[..., ::-1])))  # BGR frames, RGB PNGs
    return paths


def counted(fn):
    """fn()'s result and the kernels' launches in that call alone."""
    reset_counts()
    out = fn()
    return out, counts()


def phase_serve(dev):
    """Serving from files: the flagship with fp32 masters, bf16 compute,
    written as JAX-format .ckpt files (unfused, then BN-folded) and as a
    trainer-style payload, each read back (state bit for bit, detections on
    the slice phase's frames bit for bit); predict from the frames written
    as PNGs (a directory, a glob, a list of paths: detections equal to the
    in-memory predict's), with save, save_txt and save_crop; a 16-frame MJPG
    video (cv2) served with stream=True, vid_stride=2; test-time
    augmentation (K1 6 launches a batch, at P4 grids 40, 34 and 28), K1
    alone at the two new grids vs its plain version (fwd_cases' limits) and
    the three forwards with K1 vs the plain Swin version (bf16 3e-2, fp32
    2e-3 with TF32 off); an ensemble of two checkpoints (4 launches a batch);
    predict img/s at batch 32 from 32 PNGs and from in-memory frames, and
    the TTA forward's ms at batch 32 beside the plain forward's, with its
    device time by kernel (these on the checkpoint loaded with bf16
    weights, BN-folded, as the speed phase serves)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import tta_inputs
    from improving_yolov8_cbam_swinblock_tpu_torch.utils import serialization
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import jax_variables_from_state

    frames = slice_frames()
    kw = dict(imgsz=640, conf=0.001, batch=8, verbose=False)
    build = dict(device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    launches = {}
    try:
        # 1. checkpoints, unfused and fused, and a trainer-style payload
        base = YOLO("yolov8s-cbam-swin.yaml", seed=SEED, **build)
        base.save(str(root / "unfused.ckpt"))
        unfused = YOLO(str(root / "unfused.ckpt"), **build)
        state_ok = same_state(base.model, unfused.model) and not unfused.is_fused
        ref = base.predict(frames, **kw)
        base.save(str(root / "fused.ckpt"))
        fused = YOLO(str(root / "fused.ckpt"), **build)
        state_ok = state_ok and fused.is_fused and same_state(base.model, fused.model)
        ckpt_predict_ok = same_detections(ref, unfused.predict(frames, **kw)) and same_detections(
            ref, fused.predict(frames, **kw))
        fresh = YOLO(str(root / "unfused.ckpt"), **build).model  # `unfused` was BN-folded by its predict
        v = jax_variables_from_state(fresh)
        payload = {"step": np.asarray(8), "params": v["params"], "batch_stats": v["batch_stats"],
                   "mom_buf": {k: torch.from_numpy(a).to(torch.bfloat16) for k, a in v["params"]["model_0"]["conv"].items()},
                   "var_buf": {}, "ema_params": v["params"], "ema_stats": v["batch_stats"],
                   "ema_updates": np.asarray(8), "epoch": np.asarray(0), "best_fitness": np.asarray(0.5),
                   "model_yaml": base.model.yaml, "nc": 1, "names": {"0": "object"},
                   "args": {"imgsz": 640, "lr0": 0.01, "amp": True, "name": "train"}}
        (root / "last.ckpt").write_bytes(serialization.dumps(payload))
        back = serialization.loads((root / "last.ckpt").read_bytes())
        last = YOLO(str(root / "last.ckpt"), **build)
        payload_ok = (same_tree(back, payload) and same_state(last.model, fresh)
                      and last.names == {0: "object"} and last.overrides == {"imgsz": 640})
        sizes = {p.name: p.stat().st_size for p in root.glob("*.ckpt")}

        # 2. files: a directory, a glob and a list of PNG paths; the outputs; a video
        paths = write_pngs(frames, root / "frames")
        by_dir, launches["files"] = counted(lambda: unfused.predict(str(root / "frames"), **kw))
        by_glob = unfused.predict(str(root / "frames" / "*.png"), **kw)
        by_list = unfused.predict([str(p) for p in paths], **kw)
        files_ok = (all(same_detections(ref, r) for r in (by_dir, by_glob, by_list))
                    and [r.path for r in by_dir] == [str(p) for p in paths])
        out_dir = root / "runs" / "predict"
        saved = unfused.predict(str(root / "frames"), save=True, save_txt=True, save_crop=True, max_det=20,
                                project=str(root / "runs"), **kw)
        crops_expected = sum(1 for r in saved for b in r.boxes.xyxy
                             if min(int(b[2]), 640) > max(int(b[0]), 0) and min(int(b[3]), 480) > max(int(b[1]), 0))
        written = {"images": len(list(out_dir.glob("*.jpg"))), "labels": len(list((out_dir / "labels").glob("*.txt"))),
                   "crops": len(list((out_dir / "crops").rglob("*.jpg")))}
        outputs_ok = written == {"images": 8, "labels": 8, "crops": crops_expected} and crops_expected > 0
        try:
            import cv2
        except ImportError:
            cv2 = None
        video = {"cv2": cv2 is not None}
        video_ok = False
        if cv2 is not None:
            clip = write_clip(root / "clip.avi", frames)
            vres, launches["video"] = counted(
                lambda: list(unfused.predict(str(clip), stream=True, vid_stride=2, **kw)))
            video.update(paths=[r.path.rsplit("/", 1)[-1] for r in vres], launches=launches["video"]["swin_block_fwd"])
            video_ok = ([r.path for r in vres] == [f"{clip}#{i}" for i in range(0, 16, 2)] and boxes_ok(vres, 480, 640)
                        and launches["video"]["swin_block_fwd"] == 2 * 8)

        # 3. test-time augmentation
        grids = []
        hook = unfused.model.model[7].register_forward_hook(lambda m, i, o: grids.append(o.shape[2]))
        try:
            tta, launches["tta"] = counted(lambda: unfused.predict(frames, augment=True, **kw))
        finally:
            hook.remove()
        tta_ok = (launches["tta"]["swin_block_fwd"] == 6 and grids == list(TTA_SWIN_GRIDS) and len(tta) == 8
                  and boxes_ok(tta, 480, 640))
        fp32 = YOLO(str(root / "unfused.ckpt"), device="cuda", dtype=torch.float32).fuse()
        k1_ok, k1_rows = no_tf32(fwd_cases, dev, [((8, g, g, 256), 2, dt, True) for g in TTA_SWIN_GRIDS[1:]
                                                   for dt in (torch.bfloat16, torch.float32)])
        tta_ok = tta_ok and k1_ok
        tta_errs = {}
        for dtype, model, rtol in (("bf16", unfused.model, 3e-2), ("fp32", fp32.model, 2e-3)):
            x = letterboxed(frames, 640, dev, model.dtype)
            for grid, xi in zip(TTA_SWIN_GRIDS, tta_inputs(x, 32)):
                good, errs, _ = no_tf32(compare_forward, model, xi, rtol)
                tta_errs[f"{dtype}_p4_{grid}"] = {"ok": good, **errs}
                tta_ok = tta_ok and good

        # 4. an ensemble of two checkpoints
        YOLO("yolov8s-cbam-swin.yaml", seed=SEED + 1, **build).save(str(root / "seed1.ckpt"))
        ens = YOLO([str(root / "unfused.ckpt"), str(root / "seed1.ckpt")], **build)
        ens_res, launches["ensemble"] = counted(lambda: ens.predict(frames, **kw))
        ensemble_ok = launches["ensemble"]["swin_block_fwd"] == 4 and len(ens_res) == 8 and boxes_ok(ens_res, 480, 640)

        # 5. times at batch 32, served as the speed phase serves: bf16 weights, BN-folded
        serving = YOLO(str(root / "unfused.ckpt"), device="cuda", dtype=torch.bfloat16).fuse()
        bs = 32
        rng = np.random.default_rng(SEED + 1)
        frames32 = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(bs)]
        write_pngs(frames32, root / "png32")
        times = {"batch": bs}
        for label, src in (("disk_png", str(root / "png32")), ("in_memory", frames32)):
            serving.predict(src, imgsz=640, batch=bs, verbose=False)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                serving.predict(src, imgsz=640, batch=bs, verbose=False)
            times[f"predict_img_per_s_{label}"] = 2 * bs / (time.perf_counter() - t0)
        xb = torch.rand(bs, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
        xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            times["forward_ms"] = cuda_ms(lambda: serving.model(xb), iters=10)
            times["tta_forward_ms"] = cuda_ms(lambda: serving.model.predict_augment(xb), iters=5)
            times["tta_inputs_ms"] = cuda_ms(lambda: list(tta_inputs(xb, 32)), iters=5)  # flip, resize, pad
        times["tta_over_forward"] = times["tta_forward_ms"] / times["forward_ms"]
        times["tta_profile"] = forward_profile(serving.model.predict_augment, xb, times["tta_forward_ms"],
                                               "swin_block_fwd")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {k: sum(v[k] for v in launches.values()) for k in PREDICT_LAUNCHES}
    ok = state_ok and ckpt_predict_ok and payload_ok and files_ok and outputs_ok and video_ok and tta_ok and ensemble_ok
    return ok, {
        "ckpt_state_bit_equal": state_ok, "ckpt_predict_bit_equal": ckpt_predict_ok, "trainer_payload_ok": payload_ok,
        "ckpt_bytes": sizes, "files_equal_in_memory": files_ok, "written": written, "outputs_ok": outputs_ok,
        "video": video, "video_ok": video_ok, "tta_ok": tta_ok, "tta_p4_grids": grids,
        "tta_kernel_vs_plain_rel_err": tta_errs, "k1_at_tta_grids": k1_rows, "ensemble_ok": ensemble_ok,
        "launches": launches, "times": times,
    }, total


def write_clip(path: Path, frames) -> Path:
    """A 16-frame 480x640 MJPG video (cv2) of the 8 frames twice over."""
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (640, 480))
    for i in range(16):
        vw.write(frames[i % 8])
    vw.release()
    return path


def track_replay(results_per_call, tracker_yaml):
    """predict's detections through a fresh port tracker (which resets the
    shared id counter), frame by frame across calls: each frame's (n, 8)
    tracks, and each update's host seconds."""
    from improving_yolov8_cbam_swinblock_tpu_torch.trackers import build_tracker

    trk = build_tracker(tracker_yaml)
    tracks, secs = [], []
    for r in (r for results in results_per_call for r in results):
        d = r.boxes.data
        t0 = time.perf_counter()
        tracks.append(trk.update(d[:, :4], d[:, 4], d[:, 5]))
        secs.append(time.perf_counter() - t0)
    return tracks, secs


def tracked_as(results, tracks) -> bool:
    """track's Results against a replay: where a frame has tracks, its boxes
    are their 7 columns [x1, y1, x2, y2, id, conf, cls] and its track_ids
    their ids, bit for bit; where it has none, no ids."""
    return len(results) == len(tracks) and all(
        (r.boxes.data.shape[1] == 7 and np.array_equal(r.boxes.data, t[:, :7])
         and np.array_equal(r.track_ids, t[:, 4].astype(int))) if len(t) else len(r.track_ids) == 0
        for r, t in zip(results, tracks))


def add_counts(*cs) -> dict:
    return {k: sum(c[k] for c in cs) for k in PREDICT_LAUNCHES}


def class_biases(model) -> list:
    """(name, tensor) of the last class conv's bias of every Detect-family
    head of `model` (a WorldDetect's: its contrastive heads' bias, -10 at
    init), and of every score head of an RT-DETR head."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import Detect
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules_world import WorldDetect
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.transformer import RTDETRDecoder

    names = {id(p): n for n, p in model.named_parameters()}
    out = [(names[id(h.bias)], h.bias) for head in model.modules() if isinstance(head, WorldDetect) for h in head.cv4]
    out += [(names[id(seq[-1].bias)], seq[-1].bias) for head in model.modules()
            if isinstance(head, Detect) and not isinstance(head, WorldDetect)
            for _, cv3 in head.branches() for seq in cv3]
    return out + [(names[id(lin.bias)], lin.bias) for head in model.modules() if isinstance(head, RTDETRDecoder)
                  for lin in (head.enc_score_head, *head.dec_score_head)]


@contextlib.contextmanager
def zero_class_priors(model):
    """While open, the last class conv's bias of every Detect-family head of
    `model` is 0: a seeded model's class scores then sit near 0.5, not at
    the prior of 5 objects per image (about 1e-4), so a phase measures what
    consumes the detections at full load. The biases are put back after."""
    biases = [b for _, b in class_biases(model)]
    kept = [b.detach().clone() for b in biases]
    with torch.no_grad():
        for b in biases:
            b.zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            for b, k in zip(biases, kept):
                b.copy_(k)


def start_without_class_priors(trainer) -> None:
    """An on_pretrain_routine_end callback: the trainer's seeded model and its
    EMA start with the class-logit biases at 0 (zero_class_priors' state), so
    that the fit phase trains and validates at full load: its K1-against-plain
    val compares metrics over the same crowded detections as before the
    priors were repaired, not over near ties at the prior."""
    with torch.no_grad():
        for name, b in class_biases(trainer.model):
            b.zero_()
            trainer.ema[name].zero_()


def phase_track(yolo, dev):
    """phase_track_full with the model's class priors zeroed (zero_class_priors)."""
    with zero_class_priors(yolo.model):
        return phase_track_full(yolo, dev)


def phase_track_full(yolo, dev):
    """The last predict-side verbs on the slice phase's model (the flagship s,
    bf16, BN-folded, seeded weights) at 640 px. Track: YOLO.track over the
    serve phase's 16-frame MJPG video at batch 16 with each packaged
    tracker (ids equal to a host replay of predict's detections through a
    fresh port tracker; a second call with persist=True continues them;
    stream=True equals the list path at its batch of 1; K1 2 launches per
    predict batch), the tracker's update ms per frame against predict's ms
    per frame (host clock), and the slice phase's frames tracked as a list in
    memory. Embed: YOLO.embed of 32 frames (layer 25) equal bit for bit to a
    forward hook's mean pool, against the plain Swin version within 3e-2 of
    the largest magnitude, and its ms at batch 32 beside the forward's (CUDA
    events). Visualize: predict(visualize=True) on 2 frames, one PNG per
    rank-4 layer per frame, and its seconds."""
    import scipy

    frames = slice_frames()
    kw = dict(imgsz=640, conf=TRACK_CONF, verbose=False)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_track_"))
    c = {}
    try:
        # 1. a video, each tracker: list, persist, stream (against the list path at its batch of 1), replay
        clip = str(write_clip(root / "clip.avi", frames))
        trackers, ok = {}, True
        for name in TRACKERS:
            first, c[f"{name}_list"] = counted(lambda: yolo.track(clip, tracker=name, batch=16, **kw))
            second, c[f"{name}_persist"] = counted(
                lambda: yolo.track(clip, tracker=name, batch=16, persist=True, **kw))
            streamed, c[f"{name}_stream"] = counted(lambda: list(yolo.track(clip, tracker=name, stream=True, **kw)))
            listed = yolo.track(clip, tracker=name, batch=1, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds = yolo.predict(clip, batch=16, **kw)
            predict_ms = (time.perf_counter() - t0) * 1e3 / len(preds)
            tracks, secs = track_replay([preds, preds], name)
            ids = [set(r.track_ids.tolist()) for r in first + second]
            row = {
                "detections_per_frame": [len(r) for r in preds],
                "tracked_per_frame": [len(r.track_ids) for r in first],
                "max_id": {"first": max(map(max, filter(None, ids[:16])), default=0),
                           "persist": max(map(max, filter(None, ids[16:])), default=0)},
                "equal_replay": tracked_as(first + second, tracks),
                "stream_equal_list_batch1": len(streamed) == len(listed) == 16 and all(
                    np.array_equal(a.boxes.data, b.boxes.data) and np.array_equal(a.track_ids, b.track_ids)
                    for a, b in zip(streamed, listed)),
                "stream_ids_equal_batch16": [r.track_ids.tolist() for r in streamed] == [
                    r.track_ids.tolist() for r in first],
                # why not: the detections themselves differ between batches of 1 and 16 (bf16 convs)
                "detections_equal_batch1_batch16": same_detections(yolo.predict(clip, batch=1, **kw), preds),
                "k1_launches": {k.split("_")[-1]: v["swin_block_fwd"] for k, v in c.items() if k.startswith(name)},
                "predict_ms_per_frame": predict_ms,
                "update_ms_per_frame": {"median": 1e3 * float(np.median(secs)), "mean": 1e3 * float(np.mean(secs)),
                                        "max": 1e3 * max(secs)},
            }
            row["ok"] = (row["equal_replay"] and row["stream_equal_list_batch1"] and min(row["detections_per_frame"]) > 0
                         and sum(row["tracked_per_frame"]) > 0
                         and row["max_id"]["persist"] > row["max_id"]["first"] > 0
                         and row["k1_launches"] == {"list": 2, "persist": 2, "stream": 2 * 16})
            trackers[name] = row
            ok = ok and row["ok"]

        # 2. frames in memory, as a list of arrays (no cv2 on this path)
        mem, c["memory"] = counted(lambda: yolo.track(frames, tracker="bytetrack.yaml", batch=8, **kw))
        mem_tracks, _ = track_replay([yolo.predict(frames, batch=8, **kw)], "bytetrack.yaml")
        memory = {"tracked_per_frame": [len(r.track_ids) for r in mem], "equal_replay": tracked_as(mem, mem_tracks),
                  "k1_launches": c["memory"]["swin_block_fwd"]}
        memory_ok = memory["equal_replay"] and sum(memory["tracked_per_frame"]) > 0 and memory["k1_launches"] == 2

        # 3. embed at batch 32 from the layer before Detect
        rng = np.random.default_rng(SEED + 1)
        frames32 = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(EMBED_BATCH)]
        pooled = []
        hook = yolo.model.model[EMBED_LAYER].register_forward_hook(
            lambda m, i, o: pooled.append(o.mean((2, 3)).float().cpu().numpy()))
        try:
            emb, c["embed"] = counted(lambda: yolo.embed(frames32, imgsz=640))
        finally:
            hook.remove()
        swins = swin_modules(yolo.model)
        try:
            for m in swins:
                m.impl = "plain"
            plain = yolo.embed(frames32, imgsz=640)
        finally:
            for m in swins:
                m.impl = None
        x = letterboxed(frames32, 640, dev, torch.bfloat16)
        with torch.inference_mode():
            embed_ms = cuda_ms(lambda: yolo.model.embed(x, (EMBED_LAYER,)), iters=10)
            forward_ms = cuda_ms(lambda: yolo.model(x), iters=10)
        embed = {"shape": list(emb.shape), "dtype": str(emb.dtype),
                 "equal_hook": len(pooled) == 1 and np.array_equal(emb, pooled[0]),
                 "kernel_vs_plain_rel_err": float(np.abs(emb - plain).max() / np.abs(plain).max()),
                 "k1_launches": c["embed"]["swin_block_fwd"], "batch": EMBED_BATCH, "embed_ms": embed_ms,
                 "forward_ms": forward_ms}
        embed_ok = (embed["shape"] == [EMBED_BATCH, 512] and embed["equal_hook"] and embed["k1_launches"] == 2
                    and embed["kernel_vs_plain_rel_err"] <= 3e-2 and bool(np.isfinite(emb).all()))

        # 4. visualize on 2 frames
        two = np.stack(frames[:2])
        t0 = time.perf_counter()
        _, c["visualize"] = counted(
            lambda: yolo.predict(two, visualize=True, project=str(root), name="vis", batch=2, **kw))
        vis_s = time.perf_counter() - t0
        with torch.inference_mode():
            n_maps = len(yolo.model.features(letterboxed(frames[:1], 640, dev, torch.bfloat16)))
        pngs = {d.name: len(list(d.glob("stage*_features.png"))) for d in (root / "vis").iterdir()}
        visualize = {"pngs_per_frame": pngs, "rank4_layers": n_maps, "seconds": vis_s, "seconds_per_frame": vis_s / 2,
                     "k1_launches": c["visualize"]["swin_block_fwd"]}
        visualize_ok = pngs == {"array[0]": n_maps, "array[1]": n_maps} and n_maps == 26 and visualize[
            "k1_launches"] == 4
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = ok and memory_ok and embed_ok and visualize_ok
    launches = {"track": add_counts(*(v for k, v in c.items() if k.endswith(("list", "persist", "stream", "memory")))),
                "embed": c["embed"], "visualize": c["visualize"]}
    return ok, {"scipy": scipy.__version__, "trackers": trackers, "memory": memory, "memory_ok": memory_ok,
                "embed": embed, "embed_ok": embed_ok, "visualize": visualize, "visualize_ok": visualize_ok,
                "launches": {k: v["swin_block_fwd"] for k, v in launches.items()}}, launches


def train_batches(n, dev, aug=True, b=TRAIN["batch"]):
    """Seeded synthetic batches in the loader's format, on the card: img
    (b, 640, 640, 3) uint8, cls (b, 32) (one class), bboxes (b, 32, 4)
    normalised xywh, mask (b, 32) with about half the rows valid, and aug,
    the default hyperparameters of the device augmentation; b is the train
    path's 16 unless given."""
    from improving_yolov8_cbam_swinblock_tpu_torch.cfg import AUG_KEYS, get_cfg

    defaults = get_cfg()
    hyp = torch.tensor([float(getattr(defaults, k)) for k in AUG_KEYS], device=dev)
    rng = np.random.default_rng(SEED + 2)
    s = TRAIN["imgsz"]
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
    grads (every parameter's in a graph without a SwinBlock)."""
    assert (tr.step + 1) % tr.accumulate, "the micro-step would update the parameters"
    swins = swin_modules(tr.model)
    layers = tuple(f"model.{m.i}." for m in swins) or ("model.",)
    snap = {k: v.clone() for k, v in tr.model.state_dict().items()}
    gen = tr.aug_gen.get_state()
    for m in swins:
        m.impl = impl
    tr.tal_impl = impl
    try:
        items = step(batch)
        grads = {n: p.grad.detach().float().clone() for n, p in tr.model.named_parameters()
                 if n.startswith(layers) and p.grad is not None}
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


def grads_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


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
    return train_run(dev, {}, TRAIN_STEPS)


def train_run(dev, overrides, steps, expect=STEP_LAUNCHES):
    """train_run's checks on the trainer with TRAIN and `overrides` (the
    model; the flagship by default; each trainer's model readied after its
    setup, ready): `steps` micro-steps with the kernels'
    launches counted per step (`expect` each), the optimizer firing
    every `accumulate` steps, finite losses; then one micro-step with the
    kernels vs with the plain versions, in bf16 and in fp32, from one state
    and batch. A graph without a SwinBlock compares the grads of every
    parameter, as one vector per graph row, its one kernel on the step
    being K2."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer

    tr = DetectionTrainer(overrides={**TRAIN, **overrides}).setup()
    ready(tr.model)
    step, acc = tr._make_train_step(nb=TRAIN_NB)
    batches = train_batches(steps + 1, dev)
    reset_counts()
    t0 = time.perf_counter()
    per_step, fired, losses = [], [], []
    for i in range(steps):
        before, updates = counts(), tr.ema_updates
        items = step(batches[i])
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in counts().items()})
        losses.append(items.tolist())
        if tr.ema_updates > updates:
            fired.append(i + 1)
    seconds = time.perf_counter() - t0
    launches = counts()
    ok = (acc == 4 and fired == list(range(acc, steps + 1, acc)) and all(d == expect for d in per_step)
          and bool(np.isfinite(losses).all()) and tr.optimizer_name == "SGD")

    # the comparison: the bf16 trainer, and an fp32 one (amp off) in its state
    tr32 = DetectionTrainer(overrides={**TRAIN, **overrides, "amp": False}).setup()
    ready(tr32.model)
    tr32.model.load_state_dict(tr.model.state_dict())
    step32, _ = tr32._make_train_step(nb=TRAIN_NB)
    tr32.step = tr.step
    tr32.aug_gen.set_state(tr.aug_gen.get_state())
    (i16k, g16k), (i16p, g16p), quiet16 = compare_step(tr, step, batches[-1], lambda f, *a: f(*a))
    (i32k, g32k), (i32p, g32p), quiet32 = compare_step(tr32, step32, batches[-1], no_tf32)
    del tr32, step32
    fp32_grad, bf16_grad = block_errs(g32k, g32p), block_errs(g16k, g16p)
    bf16_vs_fp32 = {"kernel": block_errs(g16k, g32p), "plain": block_errs(g16p, g32p)}
    n_swin = len(swin_modules(tr.model))
    what = "swin" if n_swin else "row"  # grads held per SwinBlock, or per graph row in a graph without one
    cmp = {"fp32": {"loss_items_kernel": i32k.tolist(), "loss_items_plain": i32p.tolist(),
                    "loss_items_rel_err": item_errs(i32k, i32p), f"{what}_grad_rel_l2": fp32_grad,
                    **({"swin_grad_max_rel_err": {n: rel_err(g32k[n], g32p[n]) for n in g32p}} if n_swin else {})},
           "bf16": {"loss_items_kernel": i16k.tolist(), "loss_items_plain": i16p.tolist(),
                    "loss_items_rel_err": item_errs(i16k, i16p), f"{what}_grad_rel_l2": bf16_grad,
                    f"{what}_grad_rel_l2_vs_fp32_plain": bf16_vs_fp32}}
    if not n_swin:  # the assigner is the step's one kernel: how far two plain bf16 runs differ, beside it
        _, g16p2 = micro_step(tr, step, batches[-1], "plain")
        cmp["bf16"].update(bitwise_equal_grads=grads_equal(g16k, g16p), plain_repeat_bitwise_equal=grads_equal(
            g16p2, g16p), row_grad_rel_l2_plain_repeat=block_errs(g16p2, g16p))
        cmp["fp32"]["bitwise_equal_grads"] = grads_equal(g32k, g32p)
    n_grads = 12 * n_swin if n_swin else sum(1 for p in tr.model.parameters() if p.requires_grad)
    cmp_ok = (quiet16 and quiet32 and len(g32p) == n_grads and (not n_swin or len(fp32_grad) == n_swin)
              and max(item_errs(i32k, i32p)) <= FP32_ITEM_RTOL and max(fp32_grad.values()) <= FP32_GRAD_RTOL
              and max(item_errs(i16k, i16p)) <= BF16_ITEM_RTOL
              and all(bf16_vs_fp32["kernel"][i] <= BF16_GRAD_SLACK * bf16_vs_fp32["plain"][i] for i in bf16_grad))
    return ok and cmp_ok, {
        "model": tr.args.model or "default", "steps": steps, "accumulate": acc, "optimizer_fired_at": fired,
        "ema_updates": tr.ema_updates,
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
    img/s at batch 32; the int8 model served from the frames written as PNG
    files (K4 2 launches, the same detections)."""
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
    results = yolo.predict(frames, imgsz=640, conf=0.001, batch=8, verbose=False)
    t2 = time.perf_counter()
    launches = counts()
    predict_launches = {k: v - calib_launches[k] for k, v in launches.items()}
    boxes_good = boxes_ok(results, 480, 640)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as d:  # served from PNG files: the same detections
        write_pngs(frames, Path(d))
        from_files, file_launches = counted(lambda: yolo.predict(d, imgsz=640, conf=0.001, batch=8, verbose=False))
    files_ok = file_launches["swin_block_int8"] == 2 and same_detections(results, from_files)
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
    yolo.predict(frames32, imgsz=640, batch=bs, verbose=False)  # warm-up
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for _ in range(2):
        yolo.predict(frames32, imgsz=640, batch=bs, verbose=False)
    predict_img_s = 2 * bs / (time.perf_counter() - t3)
    return ok and k_ok and oracle_ok and files_ok and out_shape == (8, 5, 8400), {
        "calibration_launches": calib_launches, "predict_launches": predict_launches,
        "from_png_files_equal": files_ok, "from_png_files_launches": file_launches,
        "calibrate_s": t1 - t0, "predict_s_first_call": t2 - t1,
        "detections_per_frame": [len(r) for r in results], "boxes_ok": bool(boxes_good),
        "kernel_vs_plain_rel_err": k_err, "kernel_vs_plain_ok": k_ok, "kernel_vs_plain_rtol": INT8_MODEL_RTOL,
        "int8_vs_float_swin_block": oracle, "oracle_ok": oracle_ok,
        "int8_vs_float_model_at_swin_layers": model_level,
        "batch": bs, "int8_forward_ms": int8_ms, "int8_forward_img_per_s": bs * 1e3 / int8_ms,
        "float_fp32_weights_forward_ms": float_ms, "float_fp32_weights_forward_img_per_s": bs * 1e3 / float_ms,
        "int8_predict_img_per_s_conf0.25": predict_img_s,
    }, yolo, launches, int8_ms


def served_frames(dev) -> torch.Tensor:
    """The slice phase's 8 frames letterboxed to 640, uint8 RGB (8, 640, 640, 3) on the card."""
    from improving_yolov8_cbam_swinblock_tpu_torch.data.augment import letterbox

    return torch.stack([letterbox(f, 640, device=dev)[0].flip(-1) for f in slice_frames()]).contiguous()


def repeat_frames(x: torch.Tensor, b: int) -> torch.Tensor:
    """b frames: x's, repeated."""
    return x[torch.arange(b, device=x.device) % x.shape[0]].contiguous()


def export_serve(d: Path) -> None:
    """The export phase's second process: the programs listed in
    d/programs.json loaded by the port's Backend alone (nothing else of the
    port is imported here), each run on d/frames.npy at its batches with the
    kernels' launches counted per call, TF32 off; a static program is also
    called at a batch it must refuse. Writes d/served.pt."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    x8 = torch.from_numpy(np.load(d / "frames.npy")).cuda()
    served = {}
    for name, spec in json.loads((d / "programs.json").read_text()).items():
        t0 = time.perf_counter()
        be = Backend(spec["path"])
        row = {"load_s": time.perf_counter() - t0, "outputs": {}, "launches": {},
               "ops": [str(n.target) for n in be._fn.graph.nodes if "yolov8_cbam_swin" in str(n.target)]}
        for b in spec["batches"]:
            x = repeat_frames(x8, b)
            reset_counts()
            row["outputs"][b] = torch.from_numpy(be(x))
            torch.cuda.synchronize()
            row["launches"][b] = counts()
        if spec.get("refuse"):
            try:
                be(repeat_frames(x8, spec["refuse"]))
                row["refused"] = False
            except Exception as e:  # noqa: BLE001  the static program must refuse; record how
                row["refused"] = f"{type(e).__name__}: {e}"[:160]
        served[name] = row
    torch.save(served, d / "served.pt")


def held(got: torch.Tensor, ref: torch.Tensor, rtol: float) -> dict:
    """Bit for bit, or else within rtol of the largest magnitude, with the gap."""
    exact = got.shape == ref.shape and torch.equal(got, ref)
    err = rel_err(got, ref) if got.shape == ref.shape else float("inf")
    return {"bit_for_bit": bool(exact), "max_rel_err": err, "ok": bool(exact or err <= rtol)}


def phase_export(dev):
    """The export path on the flagship at 640 px, seeded weights: YOLO.export
    to .pt2 programs (bf16 dynamic; fp32 static batch 8; int8 batch 8; bf16
    nms batch 8), each loaded by Backend in a second process (export_serve)
    and held to the live model on the slice phase's frames (bit for bit, or
    within EXPORT_RTOL with the gap printed); K1 or K4 launches per call;
    the loaded bf16 program's forward at batch 32 against the live forward
    (CUDA events, in turns); each export's seconds; YOLO.benchmark's sweep."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.exporter import ExportForward
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import e2e_postprocess

    x8 = served_frames(dev)
    y16 = YOLO("yolov8s-cbam-swin.yaml", device="cuda", dtype=torch.bfloat16, seed=SEED).fuse()
    y32 = YOLO("yolov8s-cbam-swin.yaml", device="cuda", dtype=torch.float32, seed=SEED).fuse()
    yq = YOLO("yolov8s-cbam-swin.yaml", device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32,
              seed=SEED).fuse()
    rng = np.random.default_rng(SEED)  # the exporter's synthetic calibration frames (and the int8 phase's)
    live8 = quantize_model(copy.deepcopy(yq.model), [rng.integers(0, 255, (8, 640, 640, 3), dtype=np.uint8)
                                                     for _ in range(2)])
    info, export_s = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        d = Path(tmp)
        programs = {}
        for name, y, kw, batches, refuse in (
                ("bf16_dynamic", y16, dict(half=True, dynamic=True), EXPORT_BATCHES, None),
                ("fp32_batch8", y32, dict(batch=8), (8,), 4),
                ("int8_batch8", yq, dict(int8=True, batch=8), (8,), None),
                ("bf16_nms_batch8", y16, dict(half=True, nms=True, batch=8), (8,), None)):
            t0 = time.perf_counter()
            path = y.export(format="pt2", imgsz=640, project=str(d / name), **kw)
            export_s[name] = time.perf_counter() - t0
            programs[name] = {"path": path, "batches": list(batches), "refuse": refuse}
        np.save(d / "frames.npy", x8.cpu().numpy())
        (d / "programs.json").write_text(json.dumps(programs))
        here = Path(__file__).resolve().parent
        code = (f"import sys; from pathlib import Path; sys.path.insert(0, {str(here)!r}); import chip_smoke; "
                f"chip_smoke.export_serve(Path({str(d)!r}))")
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", code], cwd=here, timeout=900, capture_output=True, text=True)
        info["second_process_s"] = time.perf_counter() - t0
        if child.returncode:
            return False, {**info, "export_s": export_s, "second_process_rc": child.returncode,
                           "second_process_stderr": child.stderr[-3000:]}, {}
        served = torch.load(d / "served.pt")
        # the loaded bf16 program against the live forward at batch 32, CUDA events, in turns
        prog, live = Backend(programs["bf16_dynamic"]["path"])._fn, ExportForward(y16.model)
        x32 = repeat_frames(x8, 32)
        with torch.inference_mode():
            t = {"live": [], "program": []}
            for which in ("live", "program", "program", "live"):
                t[which].append(cuda_ms(lambda: (live if which == "live" else prog)(x32), iters=10))
    with torch.inference_mode():
        refs = {"bf16_dynamic": {b: no_tf32(live, repeat_frames(x8, b)) for b in EXPORT_BATCHES},
                "fp32_batch8": {8: no_tf32(ExportForward(y32.model), x8)},
                "int8_batch8": {8: no_tf32(ExportForward(live8), x8)}}
    refs["bf16_nms_batch8"] = {8: e2e_postprocess(refs["bf16_dynamic"][8], 300, 1)}
    rtols = {"bf16_dynamic": EXPORT_RTOL["bf16"], "fp32_batch8": EXPORT_RTOL["fp32"],
             "int8_batch8": EXPORT_RTOL["bf16"], "bf16_nms_batch8": EXPORT_RTOL["bf16"]}
    kernel = {"bf16_dynamic": "swin_block_fwd", "fp32_batch8": "swin_block_fwd", "int8_batch8": "swin_block_int8",
              "bf16_nms_batch8": "swin_block_fwd"}
    ok, launches = True, {k: 0 for k in counts()}
    for name, row in served.items():
        per = {}
        for b, out in row["outputs"].items():
            per[b] = {**held(out, refs[name][b].float().cpu(), rtols[name]), "launches": row["launches"][b]}
            ok &= per[b]["ok"] and row["launches"][b][kernel[name]] == 2 and sum(row["launches"][b].values()) == 2
            for k, v in row["launches"][b].items():
                launches[k] += v
        op = "yolov8_cbam_swin." + ("swin_block_int8" if name.startswith("int8") else "swin_block_fwd") + ".default"
        ok &= row["ops"] == [op] * 2
        info[name] = {"export_s": export_s[name], "load_s": row["load_s"], "ops": row["ops"], "by_batch": per,
                      **({"refused_batch4": row["refused"]} if "refused" in row else {})}
    ok &= bool(served["fp32_batch8"]["refused"]) and tuple(served["bf16_nms_batch8"]["outputs"][8].shape) == (8, 300, 6)
    live_ms, prog_ms = sum(t["live"]) / 2, sum(t["program"]) / 2
    rows = y16.benchmark(formats=["torch", "pt2"], imgsz=640, batch=32)
    ok &= [r["status"] for r in rows] == ["ok", "ok"]
    return ok, {**info, "batch32_forward_ms": {"live": t["live"], "program": t["program"], "live_mean": live_ms,
                                               "program_mean": prog_ms, "program_over_live": prog_ms / live_ms},
                "benchmark": rows}, launches


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG (rows unfiltered, zlib level 1), written with the stdlib only."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], 1).tobytes()

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_fit_dataset(root: Path) -> Path:
    """The fit phase's seeded YOLO dataset (tests/synth_data.py's layout:
    images/<split>/*.png, labels/<split>/*.txt, data.yaml): coloured boxes
    on a low-frequency background, 1-5 per image, nc=1; most images
    480x640, every 8th 384x512 and every 8th after the 4th 300x700."""
    rng = np.random.default_rng(SEED + 3)
    colors = np.array([(255, 64, 64), (64, 255, 64), (64, 64, 255), (255, 255, 64), (255, 64, 255)], np.uint8)
    for split, n in (("train", FIT_TRAIN), ("val", FIT_VAL)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = {3: (384, 512), 7: (300, 700)}.get(i % 8, (480, 640))
            low = torch.tensor(rng.integers(0, 120, (1, 3, 8, 8)), dtype=torch.float32)
            img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
            img = img[0].permute(1, 2, 0).round().to(torch.uint8).numpy().copy()
            lines = []
            for _ in range(int(rng.integers(1, 6))):
                bw, bh = rng.uniform(0.1, 0.5, 2)
                cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
                x1, y1, x2, y2 = int((cx - bw / 2) * w), int((cy - bh / 2) * h), int((cx + bw / 2) * w), int((cy + bh / 2) * h)
                img[y1:y2, x1:x2] = colors[rng.integers(0, len(colors))]
                lines.append(f"0 {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
            (root / "images" / split / f"{split}_{i:04d}.png").write_bytes(png_bytes(img))
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text("\n".join(lines) + "\n")
    data = root / "data.yaml"  # JSON is YAML
    data.write_text(json.dumps({"path": str(root), "train": "images/train", "val": "images/val", "nc": 1,
                                "names": {"0": "object"}}))
    return data


def train_state(tr) -> dict:
    """A copy of everything a checkpoint restores."""
    return {"model": {k: v.detach().clone() for k, v in tr.model.state_dict().items()},
            "optimizer": copy.deepcopy(tr.optimizer.state_dict()),
            "ema": {k: v.clone() for k, v in tr.ema.items()},
            "scalars": [tr.ema_updates, tr.step, tr.epoch, tr.best_fitness], "aug_gen": tr.aug_gen.get_state()}


def same_bits(a, b) -> bool:
    """Nested dicts, lists and tensors equal bit for bit (tensors: same dtype, shape and bytes)."""
    if isinstance(a, torch.Tensor):
        raw = lambda t: t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)  # noqa: E731
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(raw(a), raw(b)))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a == b


def val_pair(model, validator, rtol) -> dict:
    """Validation with the Swin blocks on the kernel (key None) and on the
    plain version, and compare_forward on the val batches."""
    out = {}
    for impl in (None, "plain"):
        for m in swin_modules(model):
            m.impl = impl
        out[impl] = validator()
    for m in swin_modules(model):
        m.impl = None
    x = torch.cat([torch.as_tensor(b["img"], device=model.device) for b in validator.loader])
    out["forward_ok"], out["forward_rel_err"], _ = compare_forward(model, x.permute(0, 3, 1, 2).to(model.dtype) / 255.0,
                                                                   rtol)
    return out


@contextlib.contextmanager
def counted_fit(steps, vals):
    """While open, each train micro-step of a DetectionTrainer appends to
    `steps` its epoch, the mosaic value it was handed (the batch's `aug` on
    the device path, the loader's hyp on the host path), its kernel launches
    and whether the batch's boxes are finite and inside [0, 1] under their
    mask, and each validation batch appends its launches to `vals`."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import (DetectionValidator, OBBValidator,
                                                                            SegmentationValidator)

    mk, fwd, seg_fwd = DetectionTrainer._make_train_step, DetectionValidator.forward_nms, SegmentationValidator.forward_nms
    obb_fwd = OBBValidator.forward_nms

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()}

    def counted_step(self, nb):
        step, acc = mk(self, nb)

        def run(batch):
            before = counts()
            m, b = batch["mask"] > 0, batch["bboxes"]
            if b.shape[-1] == 5:  # an OBB batch: a rotated rectangle's centre may lie outside the frame
                boxes_ok = bool(np.isfinite(b).all() and (b[m][:, 2:4] > 0).all())
            else:
                boxes_ok = bool(np.isfinite(b).all() and (b[m] >= 0).all() and (b[m] <= 1).all())
            out = step(batch)
            mosaic = float(batch["aug"][0]) if "aug" in batch else float(self.train_loader.hyp["mosaic"])
            steps.append({"epoch": self.epoch, "mosaic": mosaic, "launches": delta(before), "boxes_ok": boxes_ok})
            return out
        return run, acc

    def counted_val(f):
        def run(self, img):
            before = counts()
            out = f(self, img)
            vals.append(delta(before))
            return out
        return run

    DetectionTrainer._make_train_step = counted_step
    DetectionValidator.forward_nms, SegmentationValidator.forward_nms = counted_val(fwd), counted_val(seg_fwd)
    OBBValidator.forward_nms = counted_val(obb_fwd)
    try:
        yield
    finally:
        DetectionTrainer._make_train_step = mk
        DetectionValidator.forward_nms, SegmentationValidator.forward_nms = fwd, seg_fwd
        OBBValidator.forward_nms = obb_fwd


def phase_fit(dev):
    """The data path and the train loop on the card (the module docstring's fit phase)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import DetectionValidator
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.patches import _decoder

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    steps, vals, snaps = [], [], {}
    save = DetectionTrainer.save_checkpoint

    def snap_save(self, path):
        save(self, path)
        if Path(path).name == "epoch0.pt":
            snaps["epoch0"] = train_state(self)

    DetectionTrainer.save_checkpoint = snap_save
    try:
        with counted_fit(steps, vals):
            t0 = time.perf_counter()
            data = write_fit_dataset(tmp / "data")
            write_s = time.perf_counter() - t0
            yolo = YOLO("yolov8s-cbam-swin.yaml", device="cuda", seed=SEED)
            yolo.add_callback("on_pretrain_routine_end", start_without_class_priors)
            reset_counts()
            t0 = time.perf_counter()
            metrics = yolo.train(data=str(data), project=str(tmp / "runs"), **FIT)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = counts()
            tr = yolo.trainer
            rows = [dict(r) for r in tr.metrics_rows]
            want_step, want_val = STEP_LAUNCHES, PREDICT_LAUNCHES
            nb, nv = len(tr.train_loader), len(tr.val_loader)
            files = {f: (tr.wdir / f).exists() for f in ("last.pt", "best.pt", "epoch0.pt")}
            csv_rows = (tr.save_dir / "results.csv").read_text().strip().splitlines()
            path_ok = (nb == 4 and nv == 2 and len(steps) == 8 and all(s["launches"] == want_step for s in steps)
                       and [s["mosaic"] for s in steps] == [1.0] * 4 + [0.0] * 4
                       and len(vals) == 4 and all(v == want_val for v in vals) and all(files.values())
                       and len(csv_rows) == 3 and "metrics/mAP50-95" in csv_rows[0]
                       and all(np.isfinite([r[k] for k in r if k.startswith("train/")]).all() for r in rows))

            # a fresh trainer loads epoch 1's checkpoint bit for bit, then resumes epoch 2 only
            tr2 = DetectionTrainer(overrides={**FIT, "data": str(data), "project": str(tmp / "runs"), "name": "resume",
                                              "resume": str(tr.wdir / "epoch0.pt")}, device="cuda").setup()
            tr2.load_checkpoint(tr.wdir / "epoch0.pt")
            restored = {k: same_bits(v, snaps["epoch0"][k]) for k, v in train_state(tr2).items()}
            n_steps = len(steps)
            tr2.train()
            resume_ok = (all(restored.values()) and len(steps) - n_steps == 4
                         and [r["epoch"] for r in tr2.metrics_rows] == [1])
            del tr2

            # YOLO(best.pt).val against the trainer's record of that epoch; then with the plain block
            best = YOLO(str(tr.wdir / "best.pt"), device="cuda")
            rec = next(r for r in rows if r["metrics/fitness"] == tr.best_fitness)
            keys = ("precision", "recall", "mAP50", "mAP50-95", "fitness")
            t0 = time.perf_counter()
            vm = best.val(data=str(data), batch=FIT["batch"], imgsz=FIT["imgsz"], workers=FIT["workers"], verbose=False)
            val_s = time.perf_counter() - t0
            record_err = max(abs(vm[k] - rec[f"metrics/{k}"]) for k in keys)
            kvp = {"bf16": val_pair(best.model, best.validator, FIT_FORWARD_RTOL["bf16"]), "fp32": None}
            f32 = DetectionModel(best.model.yaml, dtype=torch.float32, device=dev, param_dtype=torch.float32)
            f32.load_state_dict(best.model.state_dict())
            kvp["fp32"] = no_tf32(val_pair, f32, DetectionValidator(f32, best.validator.loader, best.validator.args),
                                  FIT_FORWARD_RTOL["fp32"])
            rel = {dt: {k: abs(v[None][k] - v["plain"][k]) / max(abs(v[None][k]), abs(v["plain"][k]), 1e-12)
                        for k in keys} for dt, v in kvp.items()}
            val_ok = (record_err <= FIT_RECORD_ATOL and all(v["forward_ok"] for v in kvp.values())
                      and max(rel["fp32"].values()) <= FIT_FP32_METRIC_RTOL)
            del f32
            loader_alone = {}  # each loader by itself for an epoch: decode, letterbox and stack, in its threads
            for name, ld in (("train", tr.train_loader), ("val", tr.val_loader)):
                t0 = time.perf_counter()
                n = sum(1 for _ in ld)
                loader_alone[f"{name}_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / n
            bs = FIT["batch"]
            timing = [{"epoch": e["epoch"] + 1, "epoch_s": e["train_s"] + e["val_s"], "train_loop_s": e["train_s"],
                       "train_img_per_s_with_loader": e["batches"] * bs / e["train_s"],
                       "loader_wait_ms_per_train_batch": 1e3 * e["loader_wait_s"] / e["batches"],
                       "micro_step_ms": 1e3 * (e["train_s"] - e["loader_wait_s"]) / e["batches"],
                       "val_s": e["val_s"], "val_img_per_s": e["val_seen"] / e["val_s"],
                       "loader_wait_ms_per_val_batch": 1e3 * e["val_loader_s"] / e["val_batches"],
                       "val_device_ms_per_batch": 1e3 * e["val_device_s"] / e["val_batches"],
                       "val_host_ms_per_batch": 1e3 * e["val_host_s"] / e["val_batches"]} for e in tr.epoch_stats]
            return path_ok and resume_ok and val_ok, {
                "dataset_write_s": write_s, "train_call_s": fit_s, "micro_steps": n_steps, "train_batches": nb,
                "val_batches_per_epoch": nv, "launches": launches, "launches_per_step": steps[:8],
                "launches_per_val_batch": vals[:4], "files": files, "csv_rows": len(csv_rows) - 1, "rows": rows,
                "final_metrics": metrics, "path_ok": path_ok, "resume": {"restored_bit_for_bit": restored,
                                                                           "ok": resume_ok},
                "val_best_pt": dict(vm), "val_best_pt_s": val_s, "record_max_abs_err": record_err,
                "record_atol": FIT_RECORD_ATOL,
                "kernel_vs_plain": {dt: {"metrics_kernel": v[None], "metrics_plain": v["plain"], "metric_rel_err": rel[dt],
                                         "metric_rtol": FIT_FP32_METRIC_RTOL if dt == "fp32" else "not held",
                                         "forward_rel_err": v["forward_rel_err"], "forward_rtol": FIT_FORWARD_RTOL[dt]}
                                    for dt, v in kvp.items()},
                "val_ok": val_ok,
                "timing": timing, "loader_alone": loader_alone, "decoder": _decoder(),
            }, launches, loader_alone["train_ms_per_batch"]
    finally:
        DetectionTrainer.save_checkpoint = save
        shutil.rmtree(tmp, ignore_errors=True)


def host_events(epochs: int, batches: int, val_batches: int) -> list:
    """The callback events the JAX package's trainer fires in YOLO.train, in
    order (its engine/trainer.py setup, train and validate, and
    engine/validator.py's val batches)."""
    val = ["on_val_start"] + ["on_val_batch_start", "on_val_batch_end"] * val_batches + ["on_val_end"]
    epoch = ["on_train_epoch_start"] + ["on_train_batch_end"] * batches + val + ["on_model_save", "on_fit_epoch_end"]
    return ["on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start"] + epoch * epochs + [
        "on_train_end"]


def loader_ms(loader, epoch: int = 0) -> float:
    """ms per batch of one epoch of the loader by itself: decode (or the cache), transforms, stack."""
    loader.set_epoch(epoch)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return 1e3 * (time.perf_counter() - t0) / n


def host_stack_ms(ds, hyp: dict, reps: int = 3) -> dict:
    """ms of each host transform on one thread at the phase's imgsz, on the
    dataset's first 13 frames (the median of `reps`), and of one whole
    train_transform with the phase's hyp."""
    from improving_yolov8_cbam_swinblock_tpu_torch.data import augment as A

    s = ds.imgsz
    samples = [ds.load_sample(i % len(ds)) for i in range(13)]

    def ms(fn):
        out = []
        for r in range(reps):
            t0 = time.perf_counter()
            fn(np.random.default_rng(r))
            out.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(out))

    canvas = A.mosaic4(samples[:4], s, np.random.default_rng(0))
    border = canvas.pop("mosaic_border")
    img = A.random_perspective(dict(canvas), np.random.default_rng(0), border=border)["img"]
    return {"mosaic4": ms(lambda g: A.mosaic4(samples[:4], s, g)),
            "mosaic9": ms(lambda g: A.mosaic9(samples[:9], s, g)),
            "random_perspective_affine": ms(lambda g: A.random_perspective(dict(canvas), g, border=border,
                                                                           degrees=10.0, shear=2.0)),
            "random_perspective_perspective": ms(lambda g: A.random_perspective(
                dict(canvas), g, border=border, degrees=10.0, shear=2.0, perspective=5e-4)),
            "random_hsv": ms(lambda g: A.random_hsv(img, g)),
            "mixup": ms(lambda g: A.mixup({"img": img, "bboxes": np.zeros((0, 4)), "cls": np.zeros(0)},
                                          {"img": img, "bboxes": np.zeros((0, 4)), "cls": np.zeros(0)}, g)),
            "train_transform": ms(lambda g: A.train_transform(samples, s, MAX_GT, g, hyp))}


def phase_fit_host(dev, device_loader_ms):
    """The host side of YOLO.train and YOLO.val (the module docstring's fit_host phase)."""
    import importlib.util

    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.data.dataset import DataLoader, YOLODataset
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.callbacks import EVENTS, NEVER_FIRED

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_host_"))
    steps, vals = [], []
    try:
        with counted_fit(steps, vals):
            data = write_fit_dataset(tmp / "data")
            yolo = YOLO("yolov8s-cbam-swin.yaml", device=str(dev), seed=SEED)
            events = []
            for e in EVENTS:
                if e not in NEVER_FIRED and not e.startswith(("on_predict", "on_export")):
                    yolo.add_callback(e, lambda obj, e=e: events.append(e))
            reset_counts()
            t0 = time.perf_counter()
            metrics = yolo.train(data=str(data), project=str(tmp / "runs"), **FIT_HOST)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = counts()
            train_vals = list(vals)
            tr = yolo.trainer
            nb, nv = len(tr.train_loader), len(tr.val_loader)
            v = tr.validator
            kept = sum(len(st[1]) for st in v.metrics.stats)
            pred_json = tmp / "runs" / "val" / "predictions.json"
            records = len(json.loads(pred_json.read_text())) if pred_json.exists() else 0
            files = {f: (tr.save_dir / f).exists() for f in ("results.csv", "metrics.jsonl")}
            have = {"cv2": importlib.util.find_spec("cv2") is not None,
                    "matplotlib": importlib.util.find_spec("matplotlib") is not None}
            plots = {**{f: (tr.save_dir / f, "cv2") for f in ("train_batch0.jpg", "train_batch1.jpg",
                                                                "train_batch2.jpg")},
                     **{f: (tr.save_dir / f, "matplotlib") for f in ("labels.jpg", "results.png")},
                     **{f: (tmp / "runs" / "val" / f, "matplotlib") for f in (
                         "confusion_matrix.png", "PR_curve.png", "P_curve.png", "R_curve.png", "F1_curve.png")}}
            written = {f: path.exists() for f, (path, _) in plots.items()}
            plots_ok = all(written[f] == have[need] for f, (_, need) in plots.items())
            path_ok = (nb == 4 and nv == 2 and len(steps) == 8 and all(st["launches"] == STEP_LAUNCHES for st in steps)
                       and [st["mosaic"] for st in steps] == [1.0] * 4 + [0.0] * 4
                       and all(st["boxes_ok"] for st in steps) and not tr.train_loader.device_augment
                       and len(train_vals) == 4 and all(x == PREDICT_LAUNCHES for x in train_vals)
                       and events == host_events(2, nb, nv) and all(files.values()) and pred_json.exists()
                       and records == kept and plots_ok
                       and all(np.isfinite([r[k] for k in r if k.startswith("train/")]).all() for r in tr.metrics_rows))

            # the loader by itself, one epoch each: the host stack with its RAM cache warm, mosaic on (epoch
            # 1's transforms) and off (epoch 2's); the same without the cache (every image decoded again)
            ld = tr.train_loader
            alone = {"host_mosaic_off_cached_ms_per_batch": loader_ms(ld, 1)}
            ld.hyp["mosaic"] = 1.0
            alone["host_mosaic_on_cached_ms_per_batch"] = loader_ms(ld)
            cold = DataLoader(YOLODataset(ld.ds.img_dir, imgsz=FIT_HOST["imgsz"], max_gt=MAX_GT, nc=1), FIT_HOST["batch"], train=True,
                              hyp=dict(ld.hyp), seed=SEED, workers=FIT_HOST["workers"], device_augment=False)
            alone["host_mosaic_on_uncached_ms_per_batch"] = loader_ms(cold)
            alone["device_path_ms_per_batch"] = device_loader_ms  # the fit phase's loader_alone
            alone["one_thread_ms_per_sample"] = host_stack_ms(ld.ds, dict(ld.hyp))
            alone["first_batch_ms_by_workers"] = {}  # mosaic on, cached: how the host stack scales over threads
            for w in (1, 2, 4, 8):
                it = iter(DataLoader(ld.ds, FIT_HOST["batch"], train=True, hyp=dict(ld.hyp), seed=SEED, workers=w,
                                     device_augment=False))
                t0 = time.perf_counter()
                next(it)
                alone["first_batch_ms_by_workers"][w] = 1e3 * (time.perf_counter() - t0)
                it.close()
            bs = FIT_HOST["batch"]
            timing = [{"epoch": e["epoch"] + 1, "train_loop_s": e["train_s"],
                       "train_img_per_s_with_loader": e["batches"] * bs / e["train_s"],
                       "loader_wait_ms_per_train_batch": 1e3 * e["loader_wait_s"] / e["batches"],
                       "micro_step_ms": 1e3 * (e["train_s"] - e["loader_wait_s"]) / e["batches"],
                       "val_s": e["val_s"]} for e in tr.epoch_stats]

            # int8 on the trained weights: YOLO(best.pt) BN-folded and quantized on two batches of the train
            # images (letterboxed), then YOLO.val beside the float val of the same weights
            best = str(tr.wdir / "best.pt")
            calib_loader = DataLoader(YOLODataset(ld.ds.img_dir, imgsz=FIT_HOST["imgsz"], max_gt=MAX_GT, nc=1), FIT_HOST["batch"], train=False,
                                      workers=FIT_HOST["workers"])
            it = iter(calib_loader)
            calib = [next(it)["img"] for _ in range(2)]
            it.close()
            vkw = {"batch": bs, "imgsz": FIT_HOST["imgsz"], "workers": FIT_HOST["workers"], "verbose": False}
            float_yolo = YOLO(best, device=str(dev))
            del vals[:]
            reset_counts()
            float_val = float_yolo.val(data=str(data), **vkw)
            float_vals = list(vals)
            int8_yolo = YOLO(best, device=str(dev)).fuse()
            quantize_model(int8_yolo.model, calib)
            del vals[:]
            reset_counts()
            int8_val = int8_yolo.val(data=str(data), **vkw)
            int8_launches = counts()
            int8_vals = list(vals)
            keys = ("precision", "recall", "mAP50", "mAP50-95")
            int8_ok = (len(int8_vals) == 2 and all(x == INT8_PREDICT_LAUNCHES for x in int8_vals)
                       and len(float_vals) == 2 and all(x == PREDICT_LAUNCHES for x in float_vals)
                       and all(np.isfinite(int8_val[k]) for k in keys))
            return path_ok and int8_ok, {
                "settings": FIT_HOST, "train_call_s": train_s, "train_batches": nb, "val_batches_per_epoch": nv,
                "launches": launches, "launches_per_step": steps[:8], "launches_per_val_batch": train_vals,
                "mosaic_by_step": [st["mosaic"] for st in steps], "boxes_ok": all(st["boxes_ok"] for st in steps),
                "events_ok": events == host_events(2, nb, nv), "event_counts": {e: events.count(e) for e in set(events)},
                "integrations": tr.integrations, "files": files, "predictions_json_records": records,
                "val_kept_detections": kept, "have": have, "plots_written": written, "plots_ok": plots_ok,
                "final_metrics": metrics, "path_ok": path_ok, "loader_alone": alone, "timing": timing,
                "int8_on_trained_weights": {
                    "float": {k: float_val[k] for k in keys}, "int8": {k: int8_val[k] for k in keys},
                    "int8_minus_float": {k: int8_val[k] - float_val[k] for k in keys},
                    "launches_per_float_val_batch": float_vals, "launches_per_int8_val_batch": int8_vals,
                    "ok": int8_ok},
            }, {"fit_host": launches, "fit_host_int8_val": int8_launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def family_predict(cfg, frames, dev):
    """YOLO(cfg).predict of the slice phase's frames in bf16 (BN-folded, as
    predict runs it), its launches counted; then its forward against the
    fp32 unfused forward of the same seeded weights (TF32 off): each raw
    Detect map and decoded channel within 3e-2 of the largest magnitude."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    yolo = YOLO(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    reset_counts()
    t0 = time.perf_counter()
    results = yolo.predict(frames, imgsz=640, conf=0.001, batch=8, verbose=False)
    seconds = time.perf_counter() - t0
    launches = counts()
    fp32 = YOLO(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    with torch.inference_mode():
        out, maps = yolo.model(letterboxed(frames, 640, dev, torch.bfloat16))
        out32, maps32 = no_tf32(fp32.model, letterboxed(frames, 640, dev, torch.float32))
    errs = {"detect_maps": [rel_err(a, b) for a, b in zip(maps, maps32)],
            "decoded_channels_max": max(rel_err(out[:, i], out32[:, i]) for i in range(4 + yolo.model.nc))}
    boxes_good = boxes_ok(results, 480, 640)
    ok = (launches == FAMILY_PREDICT_LAUNCHES and len(results) == 8 and boxes_good and yolo.is_fused
          and not fp32.is_fused and bool(torch.isfinite(out).all()) and len(maps) == len(yolo.model.strides)
          and max(errs["detect_maps"] + [errs["decoded_channels_max"]]) <= 3e-2)
    return ok, {"model": cfg, "params": sum(p.numel() for p in fp32.model.parameters()),
                "strides": list(yolo.model.strides), "launches": launches, "boxes_ok": bool(boxes_good),
                "detections_per_frame": [len(r) for r in results], "predict_s_first_call": seconds,
                "bf16_folded_vs_fp32_rel_err": errs, "ok": ok}, launches


def k2_at(strides, dev):
    """K2 alone at the train path's B=16, G=128, nc=1, 640 px, over the
    anchor levels of `strides`: against the plain version, its time per
    call by events and on the device alone (graph_ms), and its bound over
    the candidate pairs."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    args, grid = tal_inputs(16, 4 * MAX_GT, 1, 640, dev, SEED + len(strides), strides)
    before = tal_assign_cuda.launches
    got = task_aligned_assign(*args, num_classes=1, grid=grid)
    torch.cuda.synchronize()
    one_launch = tal_assign_cuda.launches == before + 1
    row = tal_compare(got, task_aligned_assign(*args, num_classes=1, impl="plain"))
    bound_ms, bound_by = tal_bound(args, 1)
    device_ms = graph_ms(lambda: task_aligned_assign(*args, num_classes=1, grid=grid))
    return {"strides": list(strides), "b": 16, "a": args[0].shape[1], "g": 4 * MAX_GT, "nc": 1, **row,
            "one_launch": one_launch, "ok": row["ok"] and one_launch, "fg_anchors": int(got.fg_mask.sum()),
            "candidate_pairs": tal_candidate_pairs(args),
            "ms": cuda_ms(lambda: task_aligned_assign(*args, num_classes=1, grid=grid)), "device_ms": device_ms,
            "plain_ms": cuda_ms(lambda: task_aligned_assign(*args, num_classes=1, impl="plain"), iters=5),
            "bound_ms": bound_ms, "bound_by": bound_by, "device_ms_over_bound": device_ms / bound_ms,
            "dense_bound_ms": tal_bound(args, 1, dense=True)[0]}


def levels_step(cfg, dev):
    """A four-level graph (batch 16, 640 px, bf16 over fp32 masters): one
    micro-step from the fresh state with K2 and with the plain assigner on
    one batch (the loss items, the grads as one vector per graph row), then
    one micro-step with its launches counted."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer

    tr = DetectionTrainer(overrides={**TRAIN, "model": cfg}).setup()
    step, _ = tr._make_train_step(nb=TRAIN_NB)
    batch = train_batches(1, dev)[0]
    (ik, gk), (ip, gp), quiet = compare_step(tr, step, batch, lambda f, *a: f(*a))
    reset_counts()
    items = step(batch)
    torch.cuda.synchronize()
    launches = counts()
    grad = block_errs(gk, gp)
    ok = (launches == FAMILY_STEP_LAUNCHES and bool(torch.isfinite(items).all()) and quiet
          and max(item_errs(ik, ip)) <= BF16_ITEM_RTOL and len(tr.model.strides) == 4)
    info = {"model": cfg, "strides": list(tr.model.strides), "launches": launches, "loss_items": items.tolist(),
            "k2_vs_plain": {"loss_items_rel_err": item_errs(ik, ip), "row_grad_rel_l2_max": max(grad.values()),
                            "bitwise_equal_grads": grads_equal(gk, gp)}, "ok": ok}
    del tr, step
    torch.cuda.empty_cache()
    return ok, info, launches


def one_epoch_fit(cfg, step_launches, after=None):
    """YOLO(cfg).train for one epoch on the fit phase's dataset (4
    micro-steps, 2 val batches), then YOLO(best.pt).val (2 more): each
    micro-step's launches must be `step_launches`, each val batch's none (a
    graph without a SwinBlock), the metrics finite; `after(best)`, where
    given, adds its checks of the reloaded YOLO (a dict with "ok"). Returns
    (its row, its launches)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fit1_"))
    steps, vals = [], []
    try:
        data = write_fit_dataset(tmp / "data")
        fy = YOLO(cfg, device="cuda", seed=SEED)
        reset_counts()
        with counted_fit(steps, vals):
            metrics = fy.train(data=str(data), project=str(tmp / "runs"), **{**FIT, "epochs": 1, "save_period": -1})
            torch.cuda.synchronize()
            fit_launches = counts()
            best = YOLO(str(fy.trainer.wdir / "best.pt"), device="cuda")
            t0 = time.perf_counter()
            vm = best.val(data=str(data), batch=FIT["batch"], imgsz=FIT["imgsz"], workers=FIT["workers"],
                          verbose=False)
            val_s = time.perf_counter() - t0
        e = fy.trainer.epoch_stats[0]
        reloaded = after(best) if after is not None else {"ok": True}
        fit_ok = (len(steps) == 4 and all(st["launches"] == step_launches for st in steps)
                  and len(vals) == 4 and all(v == FAMILY_PREDICT_LAUNCHES for v in vals)
                  and all(np.isfinite(list(metrics.values()))) and all(np.isfinite(list(vm.values())))
                  and reloaded["ok"])
        fit = {"model": cfg, "launches": fit_launches, "launches_per_step": steps, "reloaded": reloaded,
               "launches_per_val_batch": vals, "final_metrics": metrics, "val_best_pt": dict(vm),
               "train_img_per_s_with_loader": e["batches"] * FIT["batch"] / e["train_s"],
               "val_img_per_s_in_train": e["val_seen"] / e["val_s"], "val_best_pt_img_per_s": FIT_VAL / val_s,
               "ok": fit_ok}
        del fy, best
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return fit, fit_launches


def phase_families(dev):
    """The other detect families (the module docstring's families phase)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    frames = slice_frames()
    predict, path = [], []
    for cfg in FAMILIES:
        _, info, launches = family_predict(cfg, frames, dev)
        predict.append(info)
        path.append(launches)
        torch.cuda.empty_cache()

    full = {}
    for cfg in FAMILIES_FULL:
        yolo = YOLO(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED).fuse()
        xb = torch.rand(32, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
        xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
        profile = forward_profile(yolo.model, xb, fwd_ms, "flash", "fmha", "attention", key="attention_share")
        del yolo, xb
        train_ok, train_info, (tr, step), train_launches = train_run(dev, {"model": cfg}, TRAIN_STEPS,
                                                                     FAMILY_STEP_LAUNCHES)
        cycle = itertools.cycle(train_batches(4, dev))
        step_ms = cuda_ms(lambda: step(next(cycle)), iters=8, warmup=4)
        del tr, step
        torch.cuda.empty_cache()
        path.append(train_launches)
        full[cfg] = {"ok": train_ok, "forward_ms_batch32": fwd_ms, "forward_img_per_s": 32e3 / fwd_ms,
                     "forward_profile": profile, "train": train_info, "train_ms_per_step_batch16": step_ms,
                     "train_img_per_s": TRAIN["batch"] * 1e3 / step_ms}

    levels, k2 = [], []
    for cfg, strides in FAMILIES_LEVELS:
        _, info, launches = levels_step(cfg, dev)
        levels.append(info)
        path.append(launches)
        k2.append(k2_at(strides, dev))

    fit, fit_launches = one_epoch_fit("yolo12s.yaml", FAMILY_STEP_LAUNCHES)
    path.append(fit_launches)

    ok = (all(r["ok"] for r in predict) and all(r["ok"] for r in full.values()) and all(r["ok"] for r in levels)
          and all(r["ok"] for r in k2) and fit["ok"])
    return ok, {"predict": predict, "full_width": full, "four_levels": levels, "k2_four_levels": k2, "fit": fit}, \
        {"families": add_counts(*path)}, k2


def v10_predict(cfg, frames, dev):
    """YOLO(cfg).predict of the slice phase's frames in bf16 (BN-folded, as
    predict runs it), its launches counted; then its forward against the
    fp32 unfused forward of the same seeded weights (TF32 off): each raw map
    of both branches and each channel of the one-to-one decode (xyxy)
    within V10_RTOL of the largest magnitude, and the (8, 300, 6)
    detections' scores, sorted, within V10_RTOL."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    yolo = YOLO(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    reset_counts()
    t0 = time.perf_counter()
    results = yolo.predict(frames, imgsz=640, conf=0.001, batch=8, verbose=False)
    seconds = time.perf_counter() - t0
    launches = counts()
    fp32 = YOLO(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    with torch.inference_mode():
        dets, maps = yolo.model(letterboxed(frames, 640, dev, torch.bfloat16))
        dets32, maps32 = no_tf32(fp32.model, letterboxed(frames, 640, dev, torch.float32))
        head = yolo.model.model[-1]
        dec, dec32 = head.decode(maps["one2one"], xywh=False), head.decode(maps32["one2one"], xywh=False)
    errs = {k: [rel_err(a, b) for a, b in zip(maps[k], maps32[k])] for k in ("one2many", "one2one")}
    errs["one2one_decoded_channels_max"] = max(rel_err(dec[:, i], dec32[:, i]) for i in range(dec.shape[1]))
    errs["sorted_scores_max_abs_err"] = (dets[..., 4].sort(-1)[0] - dets32[..., 4].sort(-1)[0]).abs().max().item()
    boxes_good = boxes_ok(results, 480, 640)
    ok = (launches == FAMILY_PREDICT_LAUNCHES and len(results) == 8 and boxes_good and yolo.is_fused
          and not fp32.is_fused and yolo.model.end2end and tuple(dets.shape) == (8, 300, 6)
          and bool(torch.isfinite(dets).all()) and max(max(errs["one2many"] + errs["one2one"]),
                                                       errs["one2one_decoded_channels_max"],
                                                       errs["sorted_scores_max_abs_err"]) <= V10_RTOL)
    return ok, {"model": cfg, "params": sum(p.numel() for p in fp32.model.parameters()), "launches": launches,
                "boxes_ok": bool(boxes_good), "detections_per_frame": [len(r) for r in results],
                "predict_s_first_call": seconds, "bf16_folded_vs_fp32_rel_err": errs, "ok": ok}, launches


def v10_program(yolo, dev):
    """yolov10s (bf16, BN-folded) exported asking for nms=True at batch 8:
    the option dropped with a warning (the head's detections are NMS-free
    already), the sidecar end2end; the program loaded by Backend and held
    bit for bit to the live model on the slice phase's frames (TF32 off)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.exporter import ExportForward
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend

    x8 = served_frames(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_v10_") as tmp:
        t0 = time.perf_counter()
        path = yolo.export(format="pt2", imgsz=640, batch=8, nms=True, project=tmp)
        export_s = time.perf_counter() - t0
        be = Backend(path)
        reset_counts()
        out = torch.from_numpy(no_tf32(be, x8))
        launches = counts()
        meta = dict(be.metadata)
    with torch.inference_mode():
        ref = no_tf32(ExportForward(yolo.model), x8).float().cpu()
    exact = out.shape == ref.shape and torch.equal(out, ref)
    ok = (exact and tuple(out.shape) == (8, 300, 6) and be.end2end and meta.get("end2end") is True
          and meta.get("nms") is False and Path(path).name == "model_640.pt2" and launches == FAMILY_PREDICT_LAUNCHES)
    return ok, {"path": Path(path).name, "export_s": export_s, "shape": list(out.shape), "bit_for_bit": bool(exact),
                "max_abs_err": (out - ref).abs().max().item() if out.shape == ref.shape else None,
                "sidecar": {k: meta.get(k) for k in ("end2end", "nms", "max_det", "layout")}, "launches": launches,
                "ok": ok}


def phase_v10(dev):
    """YOLOv10 (the module docstring's v10 phase)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    frames = slice_frames()
    predict, path = [], []
    for cfg in V10:
        _, info, launches = v10_predict(cfg, frames, dev)
        predict.append(info)
        path.append(launches)
        torch.cuda.empty_cache()

    yolo = YOLO(V10_FULL, device="cuda", dtype=torch.bfloat16, seed=SEED).fuse()
    xb = torch.rand(32, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
    profile = forward_profile(yolo.model, xb, fwd_ms, "sort", "Sort", "gather", key="topk_share")
    del xb
    program_ok, program = v10_program(yolo, dev)
    del yolo
    torch.cuda.empty_cache()

    train_ok, train_info, (tr, step), train_launches = train_run(dev, {"model": V10_FULL}, TRAIN_STEPS,
                                                                 V10_STEP_LAUNCHES)
    cycle = itertools.cycle(train_batches(4, dev))
    step_ms = cuda_ms(lambda: step(next(cycle)), iters=8, warmup=4)
    del tr, step
    torch.cuda.empty_cache()
    path.append(train_launches)

    fit, fit_launches = one_epoch_fit(V10_FULL, V10_STEP_LAUNCHES)
    path.append(fit_launches)
    full = {"ok": train_ok and program_ok, "forward_ms_batch32": fwd_ms, "forward_img_per_s": 32e3 / fwd_ms,
            "forward_profile": profile, "program": program, "train": train_info,
            "train_ms_per_step_batch16": step_ms, "train_img_per_s": TRAIN["batch"] * 1e3 / step_ms}
    ok = all(r["ok"] for r in predict) and full["ok"] and fit["ok"]
    return ok, {"predict": predict, "full_width": {V10_FULL: full}, "fit": fit}, {"v10": add_counts(*path)}


def write_seg_dataset(root: Path) -> Path:
    """The segment phase's seeded YOLO segmentation dataset, written with the
    stdlib as the fit phase writes its own (FIT_TRAIN and FIT_VAL images,
    most 480x640, every 8th 384x512 and every 8th after the 4th 300x700,
    nc=1): 1 to 4 filled ellipses per image on a low-frequency background,
    each labelled with the 16-vertex polygon on its outline."""
    rng = np.random.default_rng(SEED + 4)
    colors = np.array([(255, 64, 64), (64, 255, 64), (64, 64, 255), (255, 255, 64)], np.uint8)
    t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    for split, n in (("train", FIT_TRAIN), ("val", FIT_VAL)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = {3: (384, 512), 7: (300, 700)}.get(i % 8, (480, 640))
            low = torch.tensor(rng.integers(0, 120, (1, 3, 8, 8)), dtype=torch.float32)
            img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
            img = img[0].permute(1, 2, 0).round().to(torch.uint8).numpy().copy()
            yy, xx = np.mgrid[0:h, 0:w]
            lines = []
            for _ in range(int(rng.integers(1, 5))):
                a, b = rng.uniform(0.05, 0.22, 2)
                cx, cy = rng.uniform(a, 1 - a), rng.uniform(b, 1 - b)
                inside = ((xx + 0.5) / w - cx) ** 2 / a ** 2 + ((yy + 0.5) / h - cy) ** 2 / b ** 2 <= 1
                img[inside] = colors[rng.integers(0, len(colors))]
                poly = np.stack([cx + a * np.cos(t), cy + b * np.sin(t)], 1).clip(0, 1)
                lines.append("0 " + " ".join(f"{v:.6f}" for v in poly.reshape(-1)))
            (root / "images" / split / f"{split}_{i:04d}.png").write_bytes(png_bytes(img))
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text("\n".join(lines) + "\n")
    data = root / "data.yaml"  # JSON is YAML
    data.write_text(json.dumps({"path": str(root), "train": "images/train", "val": "images/val", "nc": 1,
                                "names": {"0": "object"}}))
    return data


def seg_predict(cfg, frames, dev):
    """YOLO(cfg).predict of the slice phase's frames in bf16 (BN-folded, as
    predict runs it) at conf 0.25 with its class priors zeroed
    (zero_class_priors), its launches counted, each result's masks (n,
    480, 640) bool; then its forward against the fp32 unfused forward of the
    same seeded weights (TF32 off): each raw map, the mask coefficients and
    the prototypes within SEG_RTOL of the largest magnitude. The decoded
    channels' largest gap is reported, not held (yolo12n-seg's and
    yolov9e-seg's read 3.1 to 3.3 %)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    yolo = YOLO(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    with zero_class_priors(yolo.model):
        reset_counts()
        t0 = time.perf_counter()
        results = yolo.predict(frames, imgsz=640, conf=0.25, batch=8, verbose=False)
        seconds = time.perf_counter() - t0
        launches = counts()
    fp32 = YOLO(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    with torch.inference_mode():
        out, (maps, mc, proto) = yolo.model(letterboxed(frames, 640, dev, torch.bfloat16))
        out32, (maps32, mc32, proto32) = no_tf32(fp32.model, letterboxed(frames, 640, dev, torch.float32))
    errs = {"detect_maps": [rel_err(a, b) for a, b in zip(maps, maps32)], "coefficients": rel_err(mc, mc32),
            "prototypes": rel_err(proto, proto32),
            "decoded_channels_max": max(rel_err(out[:, i], out32[:, i]) for i in range(out.shape[1]))}
    masks_ok = all(r.masks is not None and r.masks.data.dtype == bool and r.masks.shape == (len(r), 480, 640)
                   for r in results)
    ok = (launches == FAMILY_PREDICT_LAUNCHES and len(results) == 8 and boxes_ok(results, 480, 640) and masks_ok
          and yolo.is_fused and yolo.task == "segment" and tuple(proto.shape[1:]) == (32, 160, 160)
          and bool(torch.isfinite(out).all())
          and max(errs["detect_maps"] + [errs["coefficients"], errs["prototypes"]]) <= SEG_RTOL)
    return ok, {"model": cfg, "params": sum(p.numel() for p in fp32.model.parameters()), "launches": launches,
                "masks_ok": bool(masks_ok), "detections_per_frame": [len(r) for r in results],
                "predict_s_first_call": seconds, "bf16_folded_vs_fp32_rel_err": errs, "ok": ok}, launches


def masks_in_boxes(results, slack) -> bool:
    """Every mask of `results` inside its box widened by `slack` pixels."""
    for r in results:
        for m, (x1, y1, x2, y2) in zip(r.masks.data, r.boxes.xyxy):
            ys, xs = np.nonzero(m.any(1))[0], np.nonzero(m.any(0))[0]
            if len(xs) and (xs[0] < x1 - slack or xs[-1] > x2 + slack or ys[0] < y1 - slack or ys[-1] > y2 + slack):
                return False
    return True


def seg_mask_paths(yolo, frames, dev) -> dict:
    """The predictor's mask post-processing on the card against the same
    function on the same prototypes and kept rows in fp32 on the CPU
    (native_masks), for the first two frames, with and without retina_masks:
    the share of pixels that differ; and one frame's masks on the card
    alone (CUDA events) and with their copy to the host (host clock)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.data.augment import letterbox_geometry
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import native_masks
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.boxes import scale_boxes
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import non_max_suppression

    out = {}
    _, _, (padw, _, padh, _) = letterbox_geometry((480, 640), 640)
    pad = (padw, padh)
    with torch.inference_mode():
        pred, (_, _, proto) = yolo.model(letterboxed(frames[:2], 640, dev, yolo.model.dtype))
        dets = non_max_suppression(pred, conf_thres=0.25, iou_thres=0.7, max_det=300, nc=yolo.model.nc)
        for retina in (False, True):
            diff = total = 0
            for i in range(2):
                rows = dets[i][dets[i][:, 4] > 0]
                boxes0 = scale_boxes((640, 640), rows[:, :4].cpu(), (480, 640))
                got = native_masks(proto[i], rows, 640, pad, (480, 640), boxes0, retina).cpu()
                ref = native_masks(proto[i].float().cpu(), rows.float().cpu(), 640, pad, (480, 640), boxes0, retina)
                diff += int((got != ref).sum())
                total += ref.numel()

            def frame():  # the first frame's masks, as the predictor makes them
                return native_masks(proto[0], rows0, 640, pad, (480, 640), boxes00, retina)

            rows0 = dets[0][dets[0][:, 4] > 0]
            boxes00 = scale_boxes((640, 640), rows0[:, :4].cpu(), (480, 640))
            out["retina" if retina else "proto"] = {
                "pixels": total, "share_off": diff / max(total, 1),
                "masks": int(sum((dets[i][:, 4] > 0).sum() for i in range(2))),
                "frame_device_ms": cuda_ms(frame, iters=5, warmup=1),
                "frame_with_copy_to_host_ms": host_ms(lambda: frame().cpu().numpy(), iters=5)}
    return out


def seg_batches(n, dev):
    """train_batches (without `aug`: the segment step runs no device
    augmentation) with each image's overlap map at 160 x 160: each valid
    box filled with its row index + 1, the larger boxes first."""
    out = []
    for batch in train_batches(n, dev, aug=False):
        xywh, mask = batch["bboxes"].cpu().numpy(), batch["mask"].cpu().numpy()
        seg = np.zeros((xywh.shape[0], 160, 160), np.int32)
        for b in range(xywh.shape[0]):
            for j in np.argsort(-xywh[b, :, 2] * xywh[b, :, 3]):
                if mask[b, j]:
                    x1, y1 = ((xywh[b, j, :2] - xywh[b, j, 2:] / 2) * 160).astype(int)
                    x2, y2 = ((xywh[b, j, :2] + xywh[b, j, 2:] / 2) * 160).astype(int)
                    seg[b, max(y1, 0):y2, max(x1, 0):x2] = j + 1
        out.append({**batch, "seg_map": torch.tensor(seg, device=dev)})
    return out


def seg_train(dev):
    """yolov8s-seg's train micro-step at batch 16, 640 px, bf16 over fp32
    masters: SEG_STEPS micro-steps with the launches counted per step (K2
    once each), the step's time (CUDA events) and the card's peak memory
    over one step beside the (B, SEG_MASKS, 160, 160) fp32 mask tensors;
    then one micro-step from one state and batch with K2 and with the plain
    assigner (the four loss items, the grads as one vector per graph row)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer

    tr = DetectionTrainer(overrides={**TRAIN, "model": SEG_FULL}).setup()
    step, acc = tr._make_train_step(nb=TRAIN_NB)
    batches = seg_batches(SEG_STEPS + 1, dev)
    per_step, losses = [], []
    reset_counts()
    for i in range(SEG_STEPS):
        before = counts()
        items = step(batches[i])
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in counts().items()})
        losses.append(items.tolist())
    launches = counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (ik, gk), (ip, gp), quiet = compare_step(tr, step, batches[-1], lambda f, *a: f(*a))
    peak = torch.cuda.max_memory_allocated()
    grad = block_errs(gk, gp)
    cycle = itertools.cycle(batches[:SEG_STEPS])
    step_ms = cuda_ms(lambda: step(next(cycle)), iters=8, warmup=4)
    ok = (all(d == FAMILY_STEP_LAUNCHES for d in per_step) and bool(np.isfinite(losses).all()) and quiet
          and len(losses[0]) == 4 and max(item_errs(ik, ip)) <= SEG_ITEM_RTOL
          and (grads_equal(gk, gp) or max(grad.values()) <= SEG_GRAD_RTOL))
    mask_tensor = TRAIN["batch"] * SEG_MASKS * 160 * 160 * 4
    info = {"model": SEG_FULL, "accumulate": acc, "launches_per_step": per_step, "loss_items": losses,
            "loss_names": ["box", "seg", "cls", "dfl"], "step_ms_batch16": step_ms,
            "train_img_per_s": TRAIN["batch"] * 1e3 / step_ms,
            "k2_vs_plain": {"loss_items_kernel": ik.tolist(), "loss_items_plain": ip.tolist(),
                            "loss_items_rel_err": item_errs(ik, ip), "loss_items_equal": bool(torch.equal(ik, ip)),
                            "bitwise_equal_grads": grads_equal(gk, gp), "row_grad_rel_l2_max": max(grad.values())},
            "memory": {"peak_gib_over_two_micro_steps": peak / 2**30, "held_before_gib": base / 2**30,
                       "mask_tensor_gib": mask_tensor / 2**30}, "ok": ok}
    del tr, step, batches
    torch.cuda.empty_cache()
    return ok, info, launches


def seg_fit(dev):
    """YOLO(yolov8s-seg).train for one epoch on write_seg_dataset (4
    micro-steps on the loader's instance-aware host stack, 2 val batches),
    then YOLO(best.pt).val (2 more): K2 once per micro-step, no kernel per val
    batch, the box and mask metrics finite and equal to the trainer's
    record within FIT_RECORD_ATOL."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_seg_"))
    steps, vals = [], []
    try:
        data = write_seg_dataset(tmp / "data")
        fy = YOLO(SEG_FULL, device="cuda", seed=SEED)
        reset_counts()
        with counted_fit(steps, vals):
            metrics = fy.train(data=str(data), project=str(tmp / "runs"), **{**FIT, "epochs": 1, "save_period": -1})
            torch.cuda.synchronize()
            fit_launches = counts()
            best = YOLO(str(fy.trainer.wdir / "best.pt"), device="cuda")
            t0 = time.perf_counter()
            vm = best.val(data=str(data), batch=FIT["batch"], imgsz=FIT["imgsz"], workers=FIT["workers"],
                          verbose=False)
            val_s = time.perf_counter() - t0
        e = fy.trainer.epoch_stats[0]
        record_err = max(abs(vm[k] - metrics[k]) for k in metrics)
        csv_head = (fy.trainer.save_dir / "results.csv").read_text().splitlines()[0]
        ok = (len(steps) == 4 and all(st["launches"] == FAMILY_STEP_LAUNCHES and st["boxes_ok"] for st in steps)
              and len(vals) == 4 and all(v == FAMILY_PREDICT_LAUNCHES for v in vals) and record_err <= FIT_RECORD_ATOL
              and all(np.isfinite(list(metrics.values()))) and "train/seg_loss" in csv_head
              and vm.seg is not None and fy.trainer.train_loader.device_augment is False)
        del fy, best
        copy_paste = {}
        for mode in ("flip", "mixup"):
            copy_paste[mode], cp_launches = seg_copy_paste_epoch(data, tmp / f"cp_{mode}", mode)
            fit_launches = add_counts(fit_launches, cp_launches)
        ok = ok and all(v["ok"] for v in copy_paste.values())
        fit = {"model": SEG_FULL, "launches": fit_launches, "launches_per_step": steps, "launches_per_val_batch": vals,
               "final_metrics": metrics, "val_best_pt": dict(vm), "record_max_abs_err": record_err,
               "loader_wait_s": e["loader_wait_s"], "train_s": e["train_s"],
               "train_img_per_s_with_loader": e["batches"] * FIT["batch"] / e["train_s"],
               "val_img_per_s_in_train": e["val_seen"] / e["val_s"], "val_best_pt_img_per_s": FIT_VAL / val_s,
               "copy_paste": copy_paste, "ok": ok}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return fit, fit_launches


def masks_xy(res) -> dict:
    """Masks.xy (utils/patches.py find_contours on the host, numpy) of one
    served frame's masks, and of as many seeded filled ellipses on a frame
    of the same size (a seeded model's masks may hold few pixels): each
    one's ms (host clock, 3 calls), the polygons' count against the masks',
    the empty ones (a mask without pixels) and the points kept."""
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.results import Masks

    h, w = res.masks.shape[1:]
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:h, 0:w]
    n = len(res.masks)
    c, a = rng.uniform(0.1, 0.9, (n, 2)) * (w, h), rng.uniform(0.01, 0.15, (n, 2)) * (w, h)
    blobs = np.stack([((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1 for (cx, cy), (ax, ay) in zip(c, a)])
    out, ok = {}, n > 0
    for name, masks in (("served", res.masks), ("ellipses", Masks(blobs, (h, w)))):
        t0 = time.perf_counter()
        for _ in range(3):
            polys = masks.xy
        empty = int(sum(not m.any() for m in masks.data))
        out[name] = {"masks": len(masks), "frame": [h, w], "host_ms": (time.perf_counter() - t0) / 3 * 1e3,
                     "points": int(sum(len(p) for p in polys)), "empty_masks": empty}
        ok &= len(polys) == len(masks) and sum(len(p) == 0 for p in polys) == empty
    ok &= out["ellipses"]["empty_masks"] == 0
    return {"ok": bool(ok), **out}


def seg_copy_paste_epoch(data: Path, project: Path, mode: str) -> tuple:
    """YOLO(yolov8s-seg).train for one epoch (no val) on the segment dataset
    with copy_paste SEG_COPY_PASTE in `mode` (mixup mode: four more donors
    a sample, its donor mosaic after its own affine): K2 once per micro-step,
    finite losses; the epoch's train img/s with the loader."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    steps, vals = [], []
    y = YOLO(SEG_FULL, device="cuda", seed=SEED)
    reset_counts()
    with counted_fit(steps, vals):
        y.train(data=str(data), project=str(project), **{**FIT, "epochs": 1, "save_period": -1, "val": False,
                                                          "copy_paste": SEG_COPY_PASTE, "copy_paste_mode": mode})
        torch.cuda.synchronize()
    launches = counts()
    e = y.trainer.epoch_stats[0]
    losses = [v for k, v in y.trainer.metrics_rows[0].items() if k.startswith("train/")]
    ok = (len(steps) == FIT_TRAIN // FIT["batch"] and not vals and y.trainer.train_loader.hyp["copy_paste"] > 0
          and all(st["launches"] == FAMILY_STEP_LAUNCHES and st["boxes_ok"] for st in steps)
          and len(losses) == 4 and bool(np.isfinite(losses).all()))
    del y
    torch.cuda.empty_cache()
    return {"ok": bool(ok), "mode": mode, "copy_paste": SEG_COPY_PASTE, "launches_per_step": steps,
            "train_s": e["train_s"], "loader_wait_s": e["loader_wait_s"],
            "train_img_per_s_with_loader": e["batches"] * FIT["batch"] / e["train_s"]}, launches


def phase_segment(dev):
    """Instance segmentation (the module docstring's segment phase)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    frames = slice_frames()
    predict, path = [], []
    for cfg in SEG:
        _, info, launches = seg_predict(cfg, frames, dev)
        predict.append(info)
        path.append(launches)
        torch.cuda.empty_cache()

    yolo = YOLO(SEG_FULL, device="cuda", dtype=torch.bfloat16, seed=SEED).fuse()
    xb = torch.rand(SEG_BATCH, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
    profile = forward_profile(yolo.model, xb, fwd_ms, "dgrad", "deconv", "ConvTranspose", key="transposed_conv_share")
    del xb
    frames32 = frames * (SEG_BATCH // len(frames))
    served, polygons = {}, {}
    with zero_class_priors(yolo.model):  # the predictor at full load: seeded scores near 0.5, up to 300 masks a frame
        for retina in (False, True):
            kw = dict(imgsz=640, conf=0.25, batch=SEG_BATCH, retina_masks=retina, verbose=False)
            yolo.predict(frames32, **kw)  # warm-up
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = yolo.predict(frames32, **kw)
            dt = time.perf_counter() - t0
            path.append(counts())
            slack = 1 if retina else 4  # one prototype cell: 4 input pixels at gain 1
            served["retina" if retina else "proto"] = {
                "img_per_s": SEG_BATCH / dt, "masks_per_frame": [len(r) for r in res[:8]],
                "shapes_ok": all(r.masks.data.dtype == bool and r.masks.shape == (len(r), 480, 640) for r in res),
                "inside_boxes": masks_in_boxes(res[:8], slack), "slack_px": slack}
            if not retina:
                polygons = masks_xy(res[0])
        mask_paths = seg_mask_paths(yolo, frames, dev)
    del yolo
    torch.cuda.empty_cache()
    serve_ok = (all(v["shapes_ok"] and v["inside_boxes"] and sum(v["masks_per_frame"]) > 0 for v in served.values())
                and all(v["share_off"] <= SEG_MASK_SHARE and v["masks"] > 0 for v in mask_paths.values())
                and polygons["ok"])

    train_ok, train_info, train_launches = seg_train(dev)
    path.append(train_launches)
    fit, fit_launches = seg_fit(dev)
    path.append(fit_launches)
    full = {"ok": serve_ok and train_ok, "forward_ms_batch32": fwd_ms, "forward_img_per_s": SEG_BATCH * 1e3 / fwd_ms,
            "forward_profile": profile, "predict_batch32": served, "masks_xy": polygons,
            "device_vs_cpu_masks": mask_paths,
            "train": train_info}
    ok = all(r["ok"] for r in predict) and full["ok"] and fit["ok"]
    return ok, {"predict": predict, "full_width": {SEG_FULL: full}, "fit": fit}, {"segment": add_counts(*path)}


def pose_predict(cfg, frames, dev):
    """YOLO(cfg).predict of the slice phase's frames in bf16 (BN-folded, as
    predict runs it) at conf 0.25 with its class priors zeroed, its launches
    counted, each result's keypoints (n, 17, 3) inside the frame with
    visibilities in [0, 1]; then its forward against the fp32 unfused
    forward of the same seeded weights (TF32 off): each raw map and the raw
    keypoints within POSE_RTOL of the largest magnitude; the decoded
    channels' largest gap is reported."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    yolo = YOLO(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    with zero_class_priors(yolo.model):
        reset_counts()
        t0 = time.perf_counter()
        results = yolo.predict(frames, imgsz=640, conf=0.25, batch=8, verbose=False)
        seconds = time.perf_counter() - t0
        launches = counts()
    fp32 = YOLO(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    with torch.inference_mode():
        out, (maps, kpt) = yolo.model(letterboxed(frames, 640, dev, torch.bfloat16))
        out32, (maps32, kpt32) = no_tf32(fp32.model, letterboxed(frames, 640, dev, torch.float32))
    errs = {"detect_maps": [rel_err(a, b) for a, b in zip(maps, maps32)], "raw_keypoints": rel_err(kpt, kpt32),
            "decoded_channels_max": max(rel_err(out[:, i], out32[:, i]) for i in range(out.shape[1]))}
    ok = (launches == FAMILY_PREDICT_LAUNCHES and len(results) == 8 and boxes_ok(results, 480, 640)
          and keypoints_ok(results, 480, 640) and yolo.is_fused and yolo.task == "pose"
          and bool(torch.isfinite(out).all()) and max(errs["detect_maps"] + [errs["raw_keypoints"]]) <= POSE_RTOL)
    return ok, {"model": cfg, "params": sum(p.numel() for p in fp32.model.parameters()), "launches": launches,
                "detections_per_frame": [len(r) for r in results], "predict_s_first_call": seconds,
                "bf16_folded_vs_fp32_rel_err": errs, "ok": ok}, launches


def keypoints_ok(results, h, w) -> bool:
    """Every result with detections has (n, 17, 3) keypoints, finite, inside the (h, w) frame, visibilities in [0, 1]."""
    for r in results:
        if not len(r):
            continue
        k = r.keypoints.data if r.keypoints is not None else None
        if (k is None or k.shape != (len(r), 17, 3) or not np.isfinite(k).all() or (k[..., :2] < 0).any()
                or (k[..., 0] > w).any() or (k[..., 1] > h).any() or (k[..., 2] < 0).any() or (k[..., 2] > 1).any()):
            return False
    return True


def pose_keypoint_paths(yolo, frames, dev) -> dict:
    """The predictor's keypoints (scale_coords on the card) against the same
    function on the same kept rows in fp32 on the CPU, for the first two
    frames: whether they are equal bit for bit, the largest difference."""
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import DetectionPredictor
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import non_max_suppression

    p = DetectionPredictor(yolo.model, None)  # keypoints() reads the model's kpt_shape only
    with torch.inference_mode():
        pred = yolo.model(letterboxed(frames[:2], 640, dev, yolo.model.dtype))[0]
        dets = non_max_suppression(pred, conf_thres=0.25, iou_thres=0.7, max_det=300, nc=yolo.model.nc)
        pairs = [(img0, "x") for img0 in frames[:2]]
        got, ref = p.keypoints(dets, pairs, 640), p.keypoints(dets.float().cpu(), pairs, 640)
    diff = max((float(np.abs(g - r).max()) for g, r in zip(got, ref) if len(r)), default=0.0)
    return {"keypoints": int(sum(len(r) for r in ref)), "bit_for_bit": all(np.array_equal(g, r) for g, r in zip(got, ref)),
            "max_abs_diff_px": diff}


def pose_batches(n, dev):
    """train_batches (without `aug`: the pose step runs no device
    augmentation) with each row's 17 keypoints (b, 32, 17, 3): inside its
    box, visibility 0, 1 or 2, normalised as the loader gives them."""
    rng = np.random.default_rng(SEED + 5)
    out = []
    for batch in train_batches(n, dev, aug=False):
        xywh = batch["bboxes"].cpu().numpy()
        xy = xywh[..., None, :2] + rng.uniform(-0.5, 0.5, (*xywh.shape[:2], 17, 2)) * xywh[..., None, 2:]
        vis = rng.integers(0, 3, (*xywh.shape[:2], 17, 1))
        kpts = np.concatenate([np.clip(xy, 0, 1), vis], -1).astype(np.float32)
        kpts[kpts[..., 2] == 0, :2] = 0
        out.append({**batch, "kpts": torch.tensor(kpts, device=dev)})
    return out


def pose_train(dev):
    """yolov8s-pose's train micro-step at batch 16, 640 px, bf16 over fp32
    masters: POSE_STEPS micro-steps with the launches counted per step (K2
    once each) and the step's time (CUDA events); then one micro-step from
    one state and batch with K2 and with the plain assigner (the five loss
    items, the grads as one vector per graph row); autobatch's measure
    (utils/model_utils.py train_step_peak_bytes) at batch 16."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.model_utils import train_step_peak_bytes

    tr = DetectionTrainer(overrides={**TRAIN, "model": POSE_FULL}).setup()
    step, acc = tr._make_train_step(nb=TRAIN_NB)
    batches = pose_batches(POSE_STEPS + 1, dev)
    per_step, losses = [], []
    reset_counts()
    for i in range(POSE_STEPS):
        before = counts()
        items = step(batches[i])
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in counts().items()})
        losses.append(items.tolist())
    launches = counts()
    (ik, gk), (ip, gp), quiet = compare_step(tr, step, batches[-1], lambda f, *a: f(*a))
    grad = block_errs(gk, gp)
    cycle = itertools.cycle(batches[:POSE_STEPS])
    step_ms = cuda_ms(lambda: step(next(cycle)), iters=8, warmup=4)
    peak = train_step_peak_bytes(tr.model, 640, TRAIN["batch"])
    ok = (all(d == FAMILY_STEP_LAUNCHES for d in per_step) and bool(np.isfinite(losses).all()) and quiet
          and len(losses[0]) == 5 and max(item_errs(ik, ip)) <= POSE_ITEM_RTOL and peak > 0
          and (grads_equal(gk, gp) or max(grad.values()) <= POSE_GRAD_RTOL))
    info = {"model": POSE_FULL, "accumulate": acc, "launches_per_step": per_step, "loss_items": losses,
            "loss_names": ["box", "pose", "kobj", "cls", "dfl"], "step_ms_batch16": step_ms,
            "train_img_per_s": TRAIN["batch"] * 1e3 / step_ms, "autobatch_peak_gib_batch16": peak / 2**30,
            "k2_vs_plain": {"loss_items_kernel": ik.tolist(), "loss_items_plain": ip.tolist(),
                            "loss_items_rel_err": item_errs(ik, ip), "loss_items_equal": bool(torch.equal(ik, ip)),
                            "bitwise_equal_grads": grads_equal(gk, gp), "row_grad_rel_l2_max": max(grad.values())},
            "ok": ok}
    del tr, step, batches
    torch.cuda.empty_cache()
    return ok, info, launches


def write_pose_dataset(root: Path) -> Path:
    """The pose phase's seeded YOLO pose dataset, written with the stdlib as
    the fit phase writes its own (FIT_TRAIN and FIT_VAL images, most
    480x640, every 8th 384x512 and every 8th after the 4th 300x700, nc=1,
    kpt_shape [17, 3] and COCO's flip_idx): 1 to 4 filled boxes per image on
    a low-frequency background, each with 17 keypoints inside it, visibility
    0, 1 or 2, each point a dot of its own colour."""
    rng = np.random.default_rng(SEED + 6)
    colors = np.array([(255, 64, 64), (64, 255, 64), (64, 64, 255), (255, 255, 64)], np.uint8)
    for split, n in (("train", FIT_TRAIN), ("val", FIT_VAL)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = {3: (384, 512), 7: (300, 700)}.get(i % 8, (480, 640))
            low = torch.tensor(rng.integers(0, 120, (1, 3, 8, 8)), dtype=torch.float32)
            img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
            img = img[0].permute(1, 2, 0).round().to(torch.uint8).numpy().copy()
            lines = []
            for _ in range(int(rng.integers(1, 5))):
                bw, bh = rng.uniform(0.15, 0.45, 2)
                cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
                img[int((cy - bh / 2) * h):int((cy + bh / 2) * h), int((cx - bw / 2) * w):int((cx + bw / 2) * w)] = \
                    colors[rng.integers(0, len(colors))]
                k = np.stack([cx + rng.uniform(-0.45, 0.45, 17) * bw, cy + rng.uniform(-0.45, 0.45, 17) * bh,
                              rng.integers(0, 3, 17)], 1)
                for j, (x, y, v) in enumerate(k):
                    if v:
                        img[max(int(y * h) - 2, 0):int(y * h) + 2, max(int(x * w) - 2, 0):int(x * w) + 2] = 12 * j
                lines.append(f"0 {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f} " + " ".join(f"{v:.6f}" for v in k.reshape(-1)))
            (root / "images" / split / f"{split}_{i:04d}.png").write_bytes(png_bytes(img))
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text("\n".join(lines) + "\n")
    data = root / "data.yaml"  # JSON is YAML
    data.write_text(json.dumps({"path": str(root), "train": "images/train", "val": "images/val", "nc": 1,
                                "names": {"0": "person"}, "kpt_shape": [17, 3], "flip_idx": POSE_FLIP_IDX}))
    return data


def pose_fit(dev):
    """YOLO(yolov8s-pose).train for one epoch on write_pose_dataset (4
    micro-steps on the loader's instance-aware host stack with fliplr 0.5
    and the descriptor's flip_idx, 2 val batches), then YOLO(best.pt).val (2
    more): K2 once per micro-step, no kernel per val batch, the box and
    keypoint metrics ((B) and (P) keys) finite and equal to the trainer's
    record within FIT_RECORD_ATOL."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pose_"))
    steps, vals = [], []
    try:
        data = write_pose_dataset(tmp / "data")
        fy = YOLO(POSE_FULL, device="cuda", seed=SEED)
        reset_counts()
        with counted_fit(steps, vals):
            metrics = fy.train(data=str(data), project=str(tmp / "runs"),
                               **{**FIT, "epochs": 1, "save_period": -1, "fliplr": 0.5})
            torch.cuda.synchronize()
            fit_launches = counts()
            best = YOLO(str(fy.trainer.wdir / "best.pt"), device="cuda")
            t0 = time.perf_counter()
            vm = best.val(data=str(data), batch=FIT["batch"], imgsz=FIT["imgsz"], workers=FIT["workers"],
                          verbose=False)
            val_s = time.perf_counter() - t0
        e = fy.trainer.epoch_stats[0]
        record_err = max(abs(vm[k] - metrics[k]) for k in metrics)
        csv_head = (fy.trainer.save_dir / "results.csv").read_text().splitlines()[0]
        p_keys = sorted(k for k in vm if k.endswith("(P)") and not k.startswith("metrics/"))
        ok = (len(steps) == 4 and all(st["launches"] == FAMILY_STEP_LAUNCHES and st["boxes_ok"] for st in steps)
              and len(vals) == 4 and all(v == FAMILY_PREDICT_LAUNCHES for v in vals) and record_err <= FIT_RECORD_ATOL
              and all(np.isfinite(list(metrics.values()))) and "train/kobj_loss" in csv_head
              and len(p_keys) == 4 and vm.pose is not None and fy.trainer.train_loader.ds.flip_idx == POSE_FLIP_IDX
              and fy.trainer.train_loader.device_augment is False)
        fit = {"model": POSE_FULL, "launches": fit_launches, "launches_per_step": steps, "launches_per_val_batch": vals,
               "final_metrics": metrics, "val_best_pt": dict(vm), "pose_keys": p_keys,
               "record_max_abs_err": record_err, "loader_wait_s": e["loader_wait_s"], "train_s": e["train_s"],
               "train_img_per_s_with_loader": e["batches"] * FIT["batch"] / e["train_s"],
               "val_img_per_s_in_train": e["val_seen"] / e["val_s"], "val_best_pt_img_per_s": FIT_VAL / val_s,
               "ok": ok}
        del fy, best
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return fit, fit_launches


def pose_track(yolo, frames) -> tuple:
    """YOLO.track of the frames with bytetrack.yaml (fresh trackers): every
    Results keeps predict's keypoints, in the detections' order (the
    tracker re-orders the boxes only, as the JAX package does)."""
    plain = yolo.predict(frames, imgsz=640, conf=TRACK_CONF, batch=8, verbose=False)
    tracked, launches = counted(lambda: yolo.track(frames, tracker="bytetrack.yaml", imgsz=640, conf=TRACK_CONF,
                                                   batch=8, verbose=False))
    same = all(t.keypoints is not None and np.array_equal(t.keypoints.data, p.keypoints.data)
               for t, p in zip(tracked, plain) if len(p))
    ok = (same and len(tracked) == len(frames) and any(len(t.track_ids) for t in tracked)
          and launches == FAMILY_PREDICT_LAUNCHES)
    return ok, {"ok": bool(ok), "frames": len(tracked), "tracks_per_frame": [len(t.track_ids) for t in tracked],
                "keypoints_in_detection_order": bool(same), "launches": launches}, launches


def phase_pose(dev):
    """Pose estimation (the module docstring's pose phase)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    frames = slice_frames()
    predict, path = [], []
    for cfg in POSE:
        _, info, launches = pose_predict(cfg, frames, dev)
        predict.append(info)
        path.append(launches)
        torch.cuda.empty_cache()

    yolo = YOLO(POSE_FULL, device="cuda", dtype=torch.bfloat16, seed=SEED).fuse()
    xb = torch.rand(POSE_BATCH, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
    profile = forward_profile(yolo.model, xb, fwd_ms, "cudnn", "conv", key="conv_share")
    del xb
    frames32 = frames * (POSE_BATCH // len(frames))
    with zero_class_priors(yolo.model):  # the predictor at full load: seeded scores near 0.5, up to 300 a frame
        kw = dict(imgsz=640, conf=0.25, batch=POSE_BATCH, verbose=False)
        yolo.predict(frames32, **kw)  # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = yolo.predict(frames32, **kw)
        dt = time.perf_counter() - t0
        path.append(counts())
        served = {"img_per_s": POSE_BATCH / dt, "detections_per_frame": [len(r) for r in res[:8]],
                  "keypoints_ok": keypoints_ok(res, 480, 640), "boxes_ok": boxes_ok(res, 480, 640)}
        kpt_paths = pose_keypoint_paths(yolo, frames, dev)
        track_ok, track, track_launches = pose_track(yolo, frames)
        path.append(track_launches)
    del yolo
    torch.cuda.empty_cache()
    serve_ok = (served["keypoints_ok"] and served["boxes_ok"] and sum(served["detections_per_frame"]) > 0
                and kpt_paths["bit_for_bit"] and kpt_paths["keypoints"] > 0 and track_ok)

    train_ok, train_info, train_launches = pose_train(dev)
    path.append(train_launches)
    fit, fit_launches = pose_fit(dev)
    path.append(fit_launches)
    rng = np.random.default_rng(SEED)  # the int8 phase's calibration frames
    calib = [rng.integers(0, 255, (8, 640, 640, 3), dtype=np.uint8) for _ in range(2)]
    int8_ok, int8, int8_launches = int8_full(POSE_FULL, calib, frames, dev)
    path.append(int8_launches)
    full = {"ok": serve_ok and train_ok and int8_ok, "forward_ms_batch32": fwd_ms,
            "forward_img_per_s": POSE_BATCH * 1e3 / fwd_ms, "forward_profile": profile, "predict_batch32": served,
            "device_vs_cpu_keypoints": kpt_paths, "track": track, "train": train_info, "int8": int8}
    ok = all(r["ok"] for r in predict) and full["ok"] and fit["ok"]
    return ok, {"predict": predict, "full_width": {POSE_FULL: full}, "fit": fit}, {"pose": add_counts(*path)}


def obb_cfg(cfg, nc=OBB_NC) -> dict:
    """The OBB YAML with nc classes (DOTAv1's 15 by default)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load

    d = yaml_model_load(cfg)
    d["nc"] = nc
    return d


def obb_ok(results) -> bool:
    """Every result with detections has (n, 7) oriented boxes, finite, w >= h
    > 0, the angle in [0, pi), conf in (0, 1], and boxes that are their
    enclosing axis-aligned boxes."""
    for r in results:
        if not len(r):
            continue
        o = r.obb.data if r.obb is not None else None
        if (o is None or o.shape != (len(r), 7) or not np.isfinite(o).all() or (o[:, 2] < o[:, 3]).any()
                or (o[:, 3] <= 0).any() or (o[:, 4] < 0).any() or (o[:, 4] >= np.pi).any()
                or (o[:, 5] <= 0).any() or (o[:, 5] > 1).any()
                or not np.array_equal(r.boxes.xyxy, r.obb.xyxy.astype(np.float32))):
            return False
    return True


def obb_predict(cfg, frames, dev):
    """YOLO(cfg).predict of the slice phase's frames in bf16 (BN-folded) at
    640 px, nc 15, conf 0.25 with its class priors zeroed, its launches
    counted (none), each result's oriented boxes valid (obb_ok); then its
    forward against the fp32 unfused forward of the same seeded weights
    (TF32 off): each raw map and the angles within OBB_RTOL of the largest
    magnitude; the decoded channels' largest gap is reported."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    yolo = YOLO(obb_cfg(cfg), device="cuda", dtype=torch.bfloat16, seed=SEED)
    with zero_class_priors(yolo.model):
        reset_counts()
        t0 = time.perf_counter()
        results = yolo.predict(frames, imgsz=640, conf=0.25, batch=8, verbose=False)
        seconds = time.perf_counter() - t0
        launches = counts()
    fp32 = YOLO(obb_cfg(cfg), device="cuda", dtype=torch.float32, seed=SEED)
    with torch.inference_mode():
        out, (maps, ang) = yolo.model(letterboxed(frames, 640, dev, torch.bfloat16))
        out32, (maps32, ang32) = no_tf32(fp32.model, letterboxed(frames, 640, dev, torch.float32))
    errs = {"detect_maps": [rel_err(a, b) for a, b in zip(maps, maps32)], "angles": rel_err(ang, ang32),
            "decoded_channels_max": max(rel_err(out[:, i], out32[:, i]) for i in range(out.shape[1]))}
    ok = (launches == FAMILY_PREDICT_LAUNCHES and len(results) == 8 and obb_ok(results) and yolo.is_fused
          and yolo.task == "obb" and sum(len(r) for r in results) > 0 and bool(torch.isfinite(out).all())
          and max(errs["detect_maps"] + [errs["angles"]]) <= OBB_RTOL)
    return ok, {"model": cfg, "params": sum(p.numel() for p in fp32.model.parameters()), "launches": launches,
                "detections_per_frame": [len(r) for r in results], "predict_s_first_call": seconds,
                "bf16_folded_vs_fp32_rel_err": errs, "ok": ok}, launches


def obb_device_paths(yolo, frames, dev) -> dict:
    """The rotated NMS and the predictor's oriented boxes (rotated_boxes) on
    the card against the same functions in fp32 on the CPU on the same raw
    prediction (the first OBB_BATCH frames at 1024 px): the NMS rows equal
    but for at most OBB_NMS_ROW_SHARE of them (a probiou within an ulp of
    the threshold decides a suppression either way), the oriented boxes of
    the same rows bit for bit, with the CPU's ms of each."""
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import DetectionPredictor
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import non_max_suppression

    p = DetectionPredictor(yolo.model, None)  # rotated_boxes() reads nothing of the model
    kw = dict(conf_thres=0.25, iou_thres=0.7, max_det=300, nc=yolo.model.nc, rotated=True)
    pairs = [(img0, "x") for img0 in frames]
    with torch.inference_mode():
        pred = yolo.model(letterboxed(frames, OBB_IMGSZ, dev, yolo.model.dtype))[0]
        nms_ms = cuda_ms(lambda: non_max_suppression(pred, **kw), iters=3, warmup=1)
        dets = non_max_suppression(pred, **kw)
        t0 = time.perf_counter()
        dets_cpu = non_max_suppression(pred.float().cpu(), **kw)
        cpu_nms_s = time.perf_counter() - t0
        got, ref = p.rotated_boxes(dets, pairs, OBB_IMGSZ), p.rotated_boxes(dets.float().cpu(), pairs, OBB_IMGSZ)
    rows_g, rows_c = dets.cpu().numpy(), dets_cpu.numpy()
    same_rows = (rows_g == rows_c).all(-1)
    kept = int((rows_c[..., 4] > 0).sum())
    moved = float(1 - same_rows[rows_c[..., 4] > 0].mean()) if kept else 0.0
    obb_same = all(np.array_equal(g, r) for g, r in zip(got, ref))
    return {"rows_kept": kept, "nms_rows_bit_for_bit": bool(same_rows.all()), "nms_rows_moved_share": moved,
            "nms_rows_max_abs_diff": float(np.abs(rows_g - rows_c).max()), "nms_ms_batch16_card": nms_ms,
            "nms_s_batch16_cpu": cpu_nms_s, "obb_bit_for_bit": obb_same,
            "ok": kept > 0 and moved <= OBB_NMS_ROW_SHARE and obb_same}


def obb_batches(n, dev):
    """Seeded OBB batches in the loader's format at 1024 px, on the card:
    img (16, 1024, 1024, 3) uint8, cls (16, 300) of 15 classes, bboxes
    (16, 300, 5) normalised xywh and the angle in [-pi/2, 0), mask (16,
    300) with about half the rows valid (DOTA's dense scenes)."""
    rng = np.random.default_rng(SEED + 7)
    b, g, s = OBB_BATCH, OBB_MAX_GT, OBB_IMGSZ
    out = []
    for _ in range(n):
        boxes = np.concatenate([rng.uniform(0.05, 0.95, (b, g, 2)), rng.uniform(0.01, 0.2, (b, g, 2)),
                                rng.uniform(-np.pi / 2, 0, (b, g, 1))], -1).astype(np.float32)
        out.append({"img": torch.tensor(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8), device=dev),
                    "cls": torch.tensor(rng.integers(0, OBB_NC, (b, g)).astype(np.float32), device=dev),
                    "bboxes": torch.tensor(boxes, device=dev),
                    "mask": torch.tensor((rng.random((b, g)) < 0.5).astype(np.float32), device=dev)})
    return out


def obb_loss_card_vs_cpu(model, batch, dev) -> dict:
    """The OBB loss on one batch's head outputs (the card's train-mode bf16
    forward, cast to fp32) on the card and on the CPU in fp32: the three
    items within OBB_ITEM_RTOL and the grads of the raw maps and the angles
    within OBB_GRAD_RTOL of their norm; the card's loss ms and its peak
    memory over the forward's, and the CPU's seconds."""
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.obb_loss import obb_loss

    kw = dict(nc=model.nc, strides=model.strides)
    with torch.no_grad():
        maps, ang = model.train()(batch["img"].permute(0, 3, 1, 2).to(model.dtype) / 255.0)
    model.eval()
    out = {}
    for d in (dev, torch.device("cpu")):
        f = [m.detach().float().to(d).requires_grad_() for m in maps]
        a = ang.detach().float().to(d).requires_grad_()
        tgt = [batch[k].to(d) for k in ("cls", "bboxes", "mask")]
        if d.type == "cuda":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        total, items = obb_loss(f, a, *tgt, **kw)
        total.backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        out[d.type] = (torch.stack(list(items)).cpu(), [t.grad.cpu() for t in f + [a]], time.perf_counter() - t0)
    (ik, gk, sk), (ic, gc, sc) = out["cuda"], out["cpu"]
    grad_errs = [float((x - y).norm() / y.norm().clamp(min=1e-30)) for x, y in zip(gk, gc)]
    item_err = item_errs(ik, ic)
    ok = max(item_err) <= OBB_ITEM_RTOL and max(grad_errs) <= OBB_GRAD_RTOL and bool(torch.isfinite(ik).all())
    return {"ok": ok, "loss_items_card": ik.tolist(), "loss_items_cpu": ic.tolist(), "loss_items_rel_err": item_err,
            "grad_rel_l2": grad_errs, "loss_s_card_first_call": sk, "loss_s_cpu": sc,
            "assigner_and_loss_peak_gib_over_forward": peak / 2**30}


def obb_train(dev):
    """yolov8s-obb's train micro-step at batch 16, 1024 px, nc 15, max_gt
    300, bf16 over fp32 masters: OBB_STEPS micro-steps with the launches
    counted per step (none: the rotated assigner is plain PyTorch), the
    step's time (CUDA events) and peak memory, the parameters finite after
    the optimizer's steps; the loss on the card against
    the CPU (obb_loss_card_vs_cpu); autobatch's measure at batch 16."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.model_utils import train_step_peak_bytes

    tr = DetectionTrainer(overrides={**TRAIN, "model": obb_cfg(OBB_FULL), "imgsz": OBB_IMGSZ,
                                     "max_gt": OBB_MAX_GT}).setup()
    step, acc = tr._make_train_step(nb=TRAIN_NB)
    batches = obb_batches(OBB_STEPS + 1, dev)
    per_step, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(OBB_STEPS):
        before = counts()
        items = step(batches[i])
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in counts().items()})
        losses.append(items.tolist())
    launches = counts()
    step_peak = torch.cuda.max_memory_allocated()
    cycle = itertools.cycle(batches[:OBB_STEPS])
    step_ms = cuda_ms(lambda: step(next(cycle)), iters=4, warmup=2)
    finite = all(bool(torch.isfinite(p).all()) for p in tr.model.parameters())  # after two optimizer steps
    loss_cmp = obb_loss_card_vs_cpu(tr.model, batches[-1], dev)
    peak = train_step_peak_bytes(tr.model, OBB_IMGSZ, TRAIN["batch"])
    ok = (all(d == FAMILY_PREDICT_LAUNCHES for d in per_step) and bool(np.isfinite(losses).all())
          and len(losses[0]) == 3 and loss_cmp["ok"] and peak > 0 and finite)
    info = {"model": OBB_FULL, "nc": OBB_NC, "imgsz": OBB_IMGSZ, "max_gt": OBB_MAX_GT, "accumulate": acc,
            "launches_per_step": per_step, "loss_items": losses, "loss_names": ["box", "cls", "dfl"],
            "step_ms_batch16": step_ms, "train_img_per_s": TRAIN["batch"] * 1e3 / step_ms,
            "parameters_finite_after_updates": finite,
            "step_peak_gib": step_peak / 2**30, "autobatch_peak_gib_batch16_one_gt": peak / 2**30,
            "card_vs_cpu_fp32": loss_cmp, "ok": ok}
    del tr, step, batches
    torch.cuda.empty_cache()
    return ok, info, launches


def write_obb_dataset(root: Path) -> Path:
    """The OBB phase's seeded YOLO-OBB dataset, written with the stdlib as the
    fit phase writes its own (FIT_TRAIN and FIT_VAL images of 768x1024, every
    4th 1024x1024, nc 15): 4 to 12 filled rotated rectangles per image (the
    pixels whose centres fall inside, within each rectangle's bounding box)
    on a background of 8 x 8 blocks, each labelled by its 4 corners normalised
    (clipped to the image), as DOTA's tiles are."""
    rng = np.random.default_rng(SEED + 8)
    for split, n in (("train", FIT_TRAIN), ("val", FIT_VAL)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = (1024, 1024) if i % 4 == 3 else (768, 1024)
            low = rng.integers(0, 120, (8, 8, 3), dtype=np.uint8)
            img = np.repeat(np.repeat(low, h // 8, 0), w // 8, 1)  # a blocky low-frequency background
            lines = []
            for _ in range(int(rng.integers(4, 13))):
                c, wh, a = rng.uniform(0.1, 0.9, 2) * [w, h], rng.uniform(0.03, 0.25, 2) * [w, h], rng.uniform(0, np.pi)
                rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
                q = (np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * wh / 2) @ rot.T + c
                x0, y0 = np.clip(np.floor(q.min(0)).astype(int), 0, [w, h])
                x1, y1 = np.clip(np.ceil(q.max(0)).astype(int), 0, [w, h])
                gy, gx = np.mgrid[y0:y1, x0:x1] + 0.5
                u = (gx - c[0]) * np.cos(a) + (gy - c[1]) * np.sin(a)  # the pixel centre in the rectangle's frame
                v = -(gx - c[0]) * np.sin(a) + (gy - c[1]) * np.cos(a)
                img[y0:y1, x0:x1][(np.abs(u) <= wh[0] / 2) & (np.abs(v) <= wh[1] / 2)] = rng.integers(130, 256, 3)
                k = int(rng.integers(0, OBB_NC))
                lines.append(f"{k} " + " ".join(f"{v:.6f}" for v in np.clip(q / [w, h], 0, 1).reshape(-1)))
            (root / "images" / split / f"{split}_{i:04d}.png").write_bytes(png_bytes(img))
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text("\n".join(lines) + "\n")
    data = root / "data.yaml"  # JSON is YAML
    data.write_text(json.dumps({"path": str(root), "train": "images/train", "val": "images/val", "nc": OBB_NC,
                                "names": {str(k): f"class{k}" for k in range(OBB_NC)}}))
    return data


def obb_fit(dev):
    """YOLO(yolov8s-obb, nc 15).train for one epoch at 1024 px on
    write_obb_dataset (4 micro-steps on the loader's host stack with degrees
    10, 2 val batches), then YOLO(best.pt).val (2 more): no kernel per
    micro-step or val batch, best.pt's parameters finite, OBBValidator's (B)
    keys finite and equal to the trainer's record within FIT_RECORD_ATOL."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_obb_"))
    steps, vals = [], []
    try:
        data = write_obb_dataset(tmp / "data")
        fy = YOLO(obb_cfg(OBB_FULL), device="cuda", seed=SEED)
        reset_counts()
        with counted_fit(steps, vals):
            metrics = fy.train(data=str(data), project=str(tmp / "runs"),
                               **{**FIT, "epochs": 1, "save_period": -1, "imgsz": OBB_IMGSZ, "degrees": 10.0,
                                  "max_gt": OBB_MAX_GT})
            torch.cuda.synchronize()
            fit_launches = counts()
            best = YOLO(str(fy.trainer.wdir / "best.pt"), device="cuda")
            t0 = time.perf_counter()
            vm = best.val(data=str(data), batch=FIT["batch"], imgsz=OBB_IMGSZ, workers=FIT["workers"],
                          max_gt=OBB_MAX_GT, verbose=False)
            val_s = time.perf_counter() - t0
        e = fy.trainer.epoch_stats[0]
        record_err = max(abs(vm[k] - metrics[k]) for k in metrics)
        b_keys = sorted(k for k in vm if k.startswith("metrics/") and k.endswith("(B)"))
        finite = all(bool(torch.isfinite(p).all()) for p in best.model.parameters())
        ok = (len(steps) == 4 and all(st["launches"] == FAMILY_PREDICT_LAUNCHES and st["boxes_ok"] for st in steps)
              and len(vals) == 4 and all(v == FAMILY_PREDICT_LAUNCHES for v in vals) and record_err <= FIT_RECORD_ATOL
              and all(np.isfinite(list(metrics.values()))) and len(b_keys) == 4 and vm.box is not None
              and best.task == "obb" and fy.trainer.train_loader.device_augment is False and finite)
        fit = {"model": OBB_FULL, "best_parameters_finite": finite, "launches": fit_launches, "launches_per_step": steps, "launches_per_val_batch": vals,
               "final_metrics": metrics, "val_best_pt": dict(vm), "box_keys": b_keys, "record_max_abs_err": record_err,
               "loader_wait_s": e["loader_wait_s"], "train_s": e["train_s"],
               "train_img_per_s_with_loader": e["batches"] * FIT["batch"] / e["train_s"],
               "val_img_per_s_in_train": e["val_seen"] / e["val_s"], "val_best_pt_img_per_s": FIT_VAL / val_s,
               "ok": ok}
        del fy, best
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return fit, fit_launches


def obb_track(yolo, frames) -> tuple:
    """YOLO.track of the frames at 1024 px with bytetrack.yaml (fresh
    trackers): every Results keeps predict's oriented boxes, in the
    detections' order (the tracker re-orders the enclosing boxes only, as
    the JAX package does)."""
    kw = dict(imgsz=OBB_IMGSZ, conf=TRACK_CONF, batch=8, verbose=False)
    plain = yolo.predict(frames, **kw)
    tracked, launches = counted(lambda: yolo.track(frames, tracker="bytetrack.yaml", **kw))
    same = all(t.obb is not None and np.array_equal(t.obb.data, p.obb.data) for t, p in zip(tracked, plain) if len(p))
    ok = (same and len(tracked) == len(frames) and any(len(t.track_ids) for t in tracked)
          and launches == FAMILY_PREDICT_LAUNCHES)
    return ok, {"ok": bool(ok), "frames": len(tracked), "tracks_per_frame": [len(t.track_ids) for t in tracked],
                "obb_in_detection_order": bool(same), "launches": launches}, launches


def phase_obb(dev):
    """Oriented boxes (the module docstring's obb phase)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    frames = slice_frames()
    predict, path = [], []
    for cfg in OBB_GRAPHS:
        _, info, launches = obb_predict(cfg, frames, dev)
        predict.append(info)
        path.append(launches)
        torch.cuda.empty_cache()

    yolo = YOLO(obb_cfg(OBB_FULL), device="cuda", dtype=torch.bfloat16, seed=SEED).fuse()
    xb = torch.rand(OBB_BATCH, 3, OBB_IMGSZ, OBB_IMGSZ, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
    profile = forward_profile(yolo.model, xb, fwd_ms, "cudnn", "conv", key="conv_share")
    del xb
    frames16 = frames * (OBB_BATCH // len(frames))
    with zero_class_priors(yolo.model):  # the predictor at full load: seeded scores near 0.5, up to 300 a frame
        kw = dict(imgsz=OBB_IMGSZ, conf=0.25, batch=OBB_BATCH, verbose=False)
        yolo.predict(frames16, **kw)  # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = yolo.predict(frames16, **kw)
        dt = time.perf_counter() - t0
        path.append(counts())
        served = {"img_per_s": OBB_BATCH / dt, "detections_per_frame": [len(r) for r in res[:8]],
                  "obb_ok": obb_ok(res)}
        device_paths = obb_device_paths(yolo, frames16, dev)
        track_ok, track, track_launches = obb_track(yolo, frames)
        path.append(track_launches)
    del yolo
    torch.cuda.empty_cache()
    serve_ok = served["obb_ok"] and sum(served["detections_per_frame"]) > 0 and device_paths["ok"] and track_ok

    train_ok, train_info, train_launches = obb_train(dev)
    path.append(train_launches)
    fit, fit_launches = obb_fit(dev)
    path.append(fit_launches)
    rng = np.random.default_rng(SEED)  # the int8 phase's calibration frames
    calib = [rng.integers(0, 255, (8, 640, 640, 3), dtype=np.uint8) for _ in range(2)]
    int8_ok, int8, int8_launches = int8_full(OBB_FULL, calib, frames, dev)
    path.append(int8_launches)
    full = {"ok": serve_ok and train_ok and int8_ok, "forward_ms_batch16": fwd_ms,
            "forward_img_per_s": OBB_BATCH * 1e3 / fwd_ms, "forward_profile": profile, "predict_batch16": served,
            "device_vs_cpu": device_paths, "track": track, "train": train_info, "int8_640px": int8}
    ok = all(r["ok"] for r in predict) and full["ok"] and fit["ok"]
    return ok, {"predict": predict, "full_width": {OBB_FULL: full}, "fit": fit}, {"obb": add_counts(*path)}


def write_cls_dataset(root: Path) -> Path:
    """The classify phase's seeded image folder, written with the stdlib:
    train/ and val/ of CLS_NC classes, CLS_TRAIN and CLS_VAL PNGs a class of
    256 x 256 (every 4th 240 x 320): a class's colour on a blocky
    low-frequency background, with a rectangle of another colour."""
    rng = np.random.default_rng(SEED + 9)
    colors = rng.integers(0, 256, (CLS_NC, 3))
    for split, n in (("train", CLS_TRAIN), ("val", CLS_VAL)):
        for c in range(CLS_NC):
            d = root / split / f"class{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (240, 320) if i % 4 == 3 else (256, 256)
                low = rng.integers(-40, 40, (8, 8, 3))
                img = np.clip(colors[c] + np.repeat(np.repeat(low, h // 8, 0), w // 8, 1), 0, 255).astype(np.uint8)
                y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
                img[y0:y0 + h // 4, x0:x0 + w // 4] = rng.integers(0, 256, 3)
                (d / f"{i:03d}.png").write_bytes(png_bytes(img))
    return root


def cls_forward(cfg, frames, dev):
    """YOLO(cfg).predict of the frames at 224 px in bf16 (BN-folded), its
    launches counted (none), then its forward on the resized frames against
    the fp32 unfused forward of the same seeded weights (TF32 off): the
    logits (the head's linear output, hooked) within CLS_RTOL of their
    largest magnitude, the softmax's gap, its spread over the classes (a
    seeded graph without shortcuts gives near-uniform probabilities: its
    features shrink through every layer) and the share of frames whose
    top-1 class is the same."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    yolo = YOLO(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    results, launches = counted(lambda: yolo.predict(frames, imgsz=CLS_IMGSZ, batch=len(frames), verbose=False))
    fp32 = YOLO(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    x = torch.stack([torch.nn.functional.interpolate(torch.as_tensor(f[..., ::-1].copy(), device=dev).permute(
        2, 0, 1)[None].float(), size=(CLS_IMGSZ, CLS_IMGSZ), mode="bilinear", align_corners=False)[0]
        for f in frames]).round().clamp(0, 255) / 255.0
    x = x.contiguous(memory_format=torch.channels_last)
    logits = []
    hooks = [m.model.model[-1].linear.register_forward_hook(lambda mod, inp, out: logits.append(out.float()))
             for m in (yolo, fp32)]
    with torch.inference_mode():
        probs = yolo.model(x.to(torch.bfloat16))
        probs32 = no_tf32(fp32.model, x)
    for h in hooks:
        h.remove()
    err = rel_err(logits[0], logits[1])
    same_top1 = float((probs.argmax(1) == probs32.argmax(1)).float().mean())
    ok = (launches == FAMILY_PREDICT_LAUNCHES and len(results) == len(frames) and yolo.is_fused
          and yolo.task == "classify" and all(abs(float(r.probs.data.sum()) - 1) < 1e-3 for r in results)
          and bool(torch.isfinite(probs).all()) and err <= CLS_RTOL)
    info = {"model": cfg, "params": sum(p.numel() for p in fp32.model.parameters()), "launches": launches,
            "bf16_folded_vs_fp32_logits_rel_err": err, "probs_rel_err": rel_err(probs, probs32),
            "largest_logit_fp32": logits[1].abs().max().item(),
            "probs_spread_fp32": (probs32.max(1).values - probs32.min(1).values).max().item(),
            "same_top1_share": same_top1, "ok": ok}
    del yolo, fp32
    torch.cuda.empty_cache()
    return ok, info, launches


def cls_steps(cfg, dev, n: int, batch: int) -> tuple:
    """n train micro-steps of cfg (nc CLS_NC, 224 px, bf16 over fp32 masters,
    SGD, dropout 0.1) at `batch` on seeded uint8 images and labels: the
    loss items finite, the launches (none), the mean ms of the steps after
    the first (host clock, the card synchronised) and the peak memory."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load

    model = yaml_model_load(cfg)
    model["nc"] = CLS_NC
    tr = DetectionTrainer(overrides={"model": model, "batch": batch, "nbs": 64, "imgsz": CLS_IMGSZ, "amp": True,
                                     "optimizer": "SGD", "dropout": 0.1, "seed": SEED}, device=dev).setup()
    step, _ = tr._make_train_step(nb=100)
    rng = np.random.default_rng(SEED + 10)
    batches = [{"img": rng.integers(0, 256, (batch, CLS_IMGSZ, CLS_IMGSZ, 3), dtype=np.uint8),
                "label": rng.integers(0, CLS_NC, batch).astype(np.int32)} for _ in range(2)]
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    items, times = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items.append(step(batches[i % 2]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts()
    losses = torch.stack(items).float().cpu().numpy()
    ok = launches == FAMILY_PREDICT_LAUNCHES and bool(np.isfinite(losses).all()) and losses.shape == (n, 1)
    info = {"model": cfg, "batch": batch, "losses": losses[:, 0].tolist(), "launches": launches,
            "micro_step_ms": 1e3 * float(np.mean(times[1:] if n > 1 else times)),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "ok": ok}
    del tr, step
    torch.cuda.empty_cache()
    return ok, info, launches


def cls_fit(data: Path, project: Path) -> tuple:
    """YOLO(yolov8s-cls).train for CLS_FIT's two epochs on the image folder
    (RandAugment, erasing 0.4, dropout 0.1; val each epoch), then
    YOLO(best.pt).val on the folder against the trainer's best record (its
    fitness): the losses finite, no kernel launched, top1 and top5 printed."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    y = YOLO(CLS_FULL, device="cuda", seed=SEED)
    reset_counts()
    t0 = time.perf_counter()
    metrics = y.train(data=str(data), project=str(project), **CLS_FIT)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    tr = y.trainer
    best = YOLO(str(tr.wdir / "best.pt"), device="cuda")
    t0 = time.perf_counter()
    vm = best.val(data=str(data), batch=CLS_FIT["batch"], imgsz=CLS_IMGSZ, workers=8, verbose=False)
    val_s = time.perf_counter() - t0
    launches = counts()
    rows = tr.metrics_rows
    losses = [r["train/loss"] for r in rows]
    e = tr.epoch_stats[-1]
    ok = (len(rows) == 2 and bool(np.isfinite(losses).all()) and launches == FAMILY_PREDICT_LAUNCHES
          and best.task == "classify" and set(metrics) == {"top1", "top5", "fitness"}
          and abs(vm["fitness"] - tr.best_fitness) <= FIT_RECORD_ATOL and vm["top5"] == vm["metrics/accuracy_top5"]
          and tr.model.nc == CLS_NC)
    info = {"model": CLS_FULL, "settings": CLS_FIT, "train_loss_per_epoch": losses, "final_metrics": metrics,
            "val_best_pt": dict(vm), "best_fitness": tr.best_fitness, "launches": launches, "train_call_s": train_s,
            "val_call_s": val_s,
            "batches_per_epoch": e["batches"],
            "train_img_per_s_with_loader": e["batches"] * CLS_FIT["batch"] / e["train_s"],
            "loader_wait_ms_per_batch": 1e3 * e["loader_wait_s"] / e["batches"],
            "micro_step_ms_in_fit": 1e3 * (e["train_s"] - e["loader_wait_s"]) / e["batches"],
            "val_seen": tr.validator.seen, "val_img_per_s_best_pt": best.validator.seen / val_s, "ok": ok}
    return ok, info, launches, best


def cls_int8(best, data: Path, dev) -> tuple:
    """The trained yolov8s-cls (best.pt: fp32 weights, bf16 compute),
    BN-folded and quantized on two batches of 8 val images: its top-1 on
    every val image against the bf16 model's (at least CLS_INT8_AGREE the
    same), and its forward's ms at batch CLS_BATCH beside the bf16 one's."""
    from improving_yolov8_cbam_swinblock_tpu_torch import quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.data.classify import ClassificationDataset, ClassificationLoader

    loader = ClassificationLoader(ClassificationDataset(data / "val", imgsz=CLS_IMGSZ), 16, train=False, workers=8)
    imgs = np.concatenate([b["img"] for b in loader])[:CLS_NC * CLS_VAL]
    bf = copy.deepcopy(best.model).fuse()
    q = copy.deepcopy(best.model).fuse()
    reset_counts()
    quantize_model(q, [imgs[:8], imgs[8:16]])
    x = torch.as_tensor(imgs, device=dev).permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        pq, pb = q(x), bf(x)
        agree = float((pq.argmax(1) == pb.argmax(1)).float().mean())
        xb = x[torch.arange(CLS_BATCH, device=dev) % len(x)]
        int8_ms, bf16_ms = cuda_ms(lambda: q(xb), iters=10), cuda_ms(lambda: bf(xb), iters=10)
    launches = counts()
    convs = [m for m in q.modules() if hasattr(m, "runs_int8")]
    ok = (agree >= CLS_INT8_AGREE and launches == FAMILY_PREDICT_LAUNCHES and bool(torch.isfinite(pq).all())
          and all(c.runs_int8 for c in convs))
    info = {"ok": ok, "int8_convs": sum(c.runs_int8 for c in convs), "val_images": len(imgs),
            "top1_agreement_with_bf16": agree, "int8_forward_ms": int8_ms, "bf16_forward_ms": bf16_ms,
            "int8_over_bf16": int8_ms / bf16_ms, "batch": CLS_BATCH, "launches": launches}
    del bf, q
    torch.cuda.empty_cache()
    return ok, info, launches


def cls_programs(frames, project: Path) -> tuple:
    """yolov8s-cls (bf16, BN-folded, seeded) exported at 224 px with a static
    batch of 8 and with a dynamic batch, each served by YOLO(path) on the 8
    frames (the dynamic one also on 3): probs within CLS_PROGRAM_RTOL of the
    live model's largest probability (the gap printed), no kernel launched."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    y = YOLO(CLS_FULL, device="cuda", dtype=torch.bfloat16, seed=SEED).fuse()
    rows, ok = [], True
    reset_counts()
    for dynamic in (False, True):
        t0 = time.perf_counter()
        path = y.export(imgsz=CLS_IMGSZ, batch=8, dynamic=dynamic, project=str(project / f"dyn{int(dynamic)}"))
        export_s = time.perf_counter() - t0
        served = YOLO(path)
        for n in ((8, 3) if dynamic else (8,)):
            got = served.predict(frames[:n], batch=n, verbose=False)
            ref = y.predict(frames[:n], imgsz=CLS_IMGSZ, batch=n, verbose=False)
            g, r = np.stack([a.probs.data for a in got]), np.stack([a.probs.data for a in ref])
            gap = float(np.abs(g - r).max() / np.abs(r).max())
            rows.append({"dynamic": dynamic, "frames": n, "rel_gap": gap, "bit_for_bit": bool(np.array_equal(g, r)),
                         "export_s": export_s, "task": served.task})
            ok &= gap <= CLS_PROGRAM_RTOL and served.task == "classify"
    launches = counts()
    ok &= launches == FAMILY_PREDICT_LAUNCHES
    del y
    torch.cuda.empty_cache()
    return bool(ok), {"ok": bool(ok), "programs": rows, "launches": launches}, launches


def phase_classify(dev):
    """Image classification (the module docstring's classify phase)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    frames = slice_frames()
    forwards, path = [], []
    for cfg in CLS_GRAPHS:
        _, info, launches = cls_forward(cfg, frames, dev)
        forwards.append(info)
        path.append(launches)

    yolo = YOLO(CLS_FULL, device="cuda", dtype=torch.bfloat16, seed=SEED).fuse()
    xb = torch.rand(CLS_BATCH, 3, CLS_IMGSZ, CLS_IMGSZ, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: yolo.model(xb), iters=20)
    profile = forward_profile(yolo.model, xb, fwd_ms, "cudnn", "conv", key="conv_share")
    del xb
    frames64 = frames * (CLS_BATCH // len(frames))
    kw = dict(imgsz=CLS_IMGSZ, batch=CLS_BATCH, verbose=False)
    yolo.predict(frames64, **kw)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = yolo.predict(frames64, **kw)
    dt = time.perf_counter() - t0
    path.append(counts())
    served = {"img_per_s": CLS_BATCH / dt, "frames": len(res), "top5_of_frame0": res[0].probs.top5,
              "verbose_of_frame0": res[0].verbose()}
    del yolo
    torch.cuda.empty_cache()

    step_ok, steps, step_launches = cls_steps(CLS_FULL, dev, 4, 32)
    path.append(step_launches)
    rn_ok, resnet, rn_launches = cls_steps(CLS_RESNET, dev, 1, 32)
    path.append(rn_launches)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cls_"))
    try:
        t0 = time.perf_counter()
        data = write_cls_dataset(tmp / "data")
        write_s = time.perf_counter() - t0
        fit_ok, fit, fit_launches, best = cls_fit(data, tmp / "runs")
        path.append(fit_launches)
        int8_ok, int8, int8_launches = cls_int8(best, data, dev)
        path.append(int8_launches)
        del best
        prog_ok, programs, prog_launches = cls_programs(frames, tmp / "programs")
        path.append(prog_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    full = {"forward_ms_batch64": fwd_ms, "forward_img_per_s": CLS_BATCH * 1e3 / fwd_ms, "forward_profile": profile,
            "predict_batch64": served, "micro_steps_batch32": steps}
    ok = all(f["ok"] for f in forwards) and step_ok and rn_ok and fit_ok and int8_ok and prog_ok
    return ok, {"forwards": forwards, "full_width": {CLS_FULL: full, CLS_RESNET: resnet}, "dataset_write_s": write_s,
                "fit": fit, "int8": int8, "programs": programs}, {"classify": add_counts(*path)}


@torch.no_grad()
def draw_query_paths(model, seed: int = SEED, std: float = RTDETR_DRAW_STD) -> None:
    """Draw, from a seeded normal of `std`, the weights that an RT-DETR
    head's seeded init zeroes: the last layer of every box head and every
    deformable attention's sampling_offsets and attention_weights matrices.
    Seeded, every box is its anchor and the sampling points and their weights
    do not depend on the query; drawn, a check holds the box-refinement
    ladder and the query-dependent sampling. The draws are made on the CPU
    in a fixed module order, so two models of one graph get the same."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.transformer import MSDeformAttn

    g = torch.Generator().manual_seed(seed)
    head = model.model[-1]
    lins = [mlp.layers[-1] for mlp in (head.enc_bbox_head, *head.dec_bbox_head)]
    lins += [lin for m in head.modules() if isinstance(m, MSDeformAttn) for lin in (m.sampling_offsets, m.attention_weights)]
    for lin in lins:
        lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * std)


def rtdetr_queries(model, x):
    """model(x)'s (B, nq, 4 + nc) fp32 output and the anchor index of each
    query (the head's top-k, recomputed from its encoder scores, hooked)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import _topk_first

    head = model.model[-1]
    seen = []
    hook = head.enc_score_head.register_forward_hook(lambda mod, inp, out: seen.append(out.float().amax(-1)))
    try:
        with torch.inference_mode():
            y = model(x)[0].float()
    finally:
        hook.remove()
    return y, _topk_first(seen[0], y.shape[1])[1]


def rtdetr_check(cfg, dev) -> dict:
    """cfg's bf16 BN-folded forward against its fp32 unfused one (TF32 off)
    on RTDETR_CHECK_BATCH seeded 640 px images, the score heads' priors
    zeroed and the query paths drawn (draw_query_paths), queries matched
    by anchor (RTDETR_SHARED, RTDETR_ATOL; a changed top-1 class only at a
    near tie, RTDETR_FLIP_MARGIN); no kernel launched."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel

    x = torch.rand(RTDETR_CHECK_BATCH, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    x = x.contiguous(memory_format=torch.channels_last)
    fp32 = DetectionModel(cfg, device=dev, seed=SEED)
    bf16 = DetectionModel(cfg, device=dev, seed=SEED, dtype=torch.bfloat16)
    draw_query_paths(fp32)
    draw_query_paths(bf16)
    bf16.fuse()
    reset_counts()
    with zero_class_priors(fp32), zero_class_priors(bf16):
        y32, a32 = no_tf32(rtdetr_queries, fp32, x)
        y16, a16 = rtdetr_queries(bf16, x.to(torch.bfloat16))
    launches = counts()
    box_err, score_err, shared, kept, flip_margins = 0.0, 0.0, 0, 0, []
    for b in range(x.shape[0]):
        pos16 = {int(a): i for i, a in enumerate(a16[b].tolist())}
        for i, a in enumerate(a32[b].tolist()):
            j = pos16.get(int(a))
            if j is None:
                continue
            shared += 1
            box_err = max(box_err, (y16[b, j, :4] - y32[b, i, :4]).abs().max().item())
            score_err = max(score_err, (y16[b, j, 4:] - y32[b, i, 4:]).abs().max().item())
            if y32[b, i, 4:].max() > 0.25:
                kept += 1
                if y16[b, j, 4:].argmax() != y32[b, i, 4:].argmax():
                    top2 = y32[b, i, 4:].topk(2).values
                    flip_margins.append((top2[0] - top2[1]).item())
    n = a32.numel()
    info = {"model": cfg, "params": sum(p.numel() for p in fp32.parameters()), "queries": n,
            "shared_anchor_share": shared / n, "box_abs_err": box_err, "score_abs_err": score_err,
            "kept_fp32": kept, "same_top1_share": 1 - len(flip_margins) / max(kept, 1),
            "largest_fp32_margin_of_a_changed_top1": max(flip_margins, default=0.0),
            "finite": bool(torch.isfinite(y16).all()), "launches": launches}
    info["ok"] = (info["finite"] and shared / n >= RTDETR_SHARED and box_err <= RTDETR_ATOL
                  and score_err <= RTDETR_ATOL and kept > 0 and max(flip_margins, default=0.0) <= RTDETR_FLIP_MARGIN
                  and launches == FAMILY_PREDICT_LAUNCHES and bool(fp32.is_rtdetr))
    del fp32, bf16
    torch.cuda.empty_cache()
    return info


def rtdetr_forward_ms(model, dev) -> dict:
    """rtdetr-l's bf16 folded forward at RTDETR_BATCH (CUDA events), its
    device time by kernel (torch.profiler: the deformable sampling's
    grid_sampler share, the top-k's sort share) and, by events on the
    inputs the forward handed them, the six decoder layers and the top-k alone."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import _topk_first

    xb = torch.rand(RTDETR_BATCH, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    head = model.model[-1]
    args = []
    hook = head.decoder.register_forward_pre_hook(lambda mod, a, kw: args.append((a, kw)), with_kwargs=True)
    scores = []
    hook2 = head.enc_score_head.register_forward_hook(lambda mod, inp, out: scores.append(out.float().amax(-1)))
    with torch.inference_mode():
        model(xb)
        hook.remove()
        hook2.remove()
        fwd_ms = cuda_ms(lambda: model(xb), iters=10)
        a, kw = args[0]
        dec_ms = cuda_ms(lambda: head.decoder(*a, **kw), iters=10)
        topk_ms = cuda_ms(lambda: _topk_first(scores[0], head.nq), iters=10)
    profile = forward_profile(model, xb, fwd_ms, "grid_sampler", key="grid_sample_share",
                              more={"sort_share": ("sort", "Sort")})
    return {"batch": RTDETR_BATCH, "forward_ms": fwd_ms, "forward_img_per_s": RTDETR_BATCH * 1e3 / fwd_ms,
            "decoder_ms": dec_ms, "decoder_share": dec_ms / fwd_ms, "topk_ms": topk_ms, "profile": profile}


def write_rtdetr_val(root: Path) -> Path:
    """RTDETR_VAL seeded 480x640 PNGs with 1-5 coloured boxes of one class (val only), and their data.yaml."""
    rng = np.random.default_rng(SEED + 11)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
    for i in range(RTDETR_VAL):
        img = rng.integers(0, 90, (480, 640, 3), dtype=np.uint8)
        lines = []
        for _ in range(int(rng.integers(1, 6))):
            bw, bh = rng.uniform(0.1, 0.4, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            img[int((cy - bh / 2) * 480):int((cy + bh / 2) * 480), int((cx - bw / 2) * 640):int((cx + bw / 2) * 640)] = \
                rng.integers(100, 256, 3)
            lines.append(f"0 {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        (root / "images" / "val" / f"{i:03d}.png").write_bytes(png_bytes(img))
        (root / "labels" / "val" / f"{i:03d}.txt").write_text("\n".join(lines) + "\n")
    data = root / "data.yaml"
    data.write_text(json.dumps({"path": str(root), "train": "images/val", "val": "images/val", "nc": 80,
                                "names": {str(i): f"class{i}" for i in range(80)}}))
    return data


def rtdetr_serve(dev, tmp: Path) -> tuple:
    """YOLO("rtdetr-l.yaml") in bf16, BN-folded by predict, the score priors
    zeroed: predict of the slice phase's 480x640 frames at RTDETR_BATCH
    (img/s, boxes inside the frames, no kernel), and YOLO.val on the seeded
    PNGs (no NMS: every query of every image)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import RTDETR

    yolo = RTDETR(RTDETR_FULL, device=dev, dtype=torch.bfloat16, seed=SEED)
    frames = slice_frames() * (RTDETR_BATCH // 8)
    kw = dict(imgsz=640, batch=RTDETR_BATCH, conf=0.25, verbose=False)
    with zero_class_priors(yolo.model):
        yolo.predict(frames, **kw)  # warm-up (and the fold)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = yolo.predict(frames, **kw)
        dt = time.perf_counter() - t0
        launches = counts()
        data = write_rtdetr_val(tmp / "val")
        t0 = time.perf_counter()
        vm = yolo.val(data=str(data), batch=RTDETR_STEP_BATCH, imgsz=640, workers=8, verbose=False)
        val_s = time.perf_counter() - t0
    launches = add_counts(launches, counts())
    n_det = [len(r) for r in res]
    centres = np.concatenate([(r.boxes.xyxy[:, :2] + r.boxes.xyxy[:, 2:]) / 2 for r in res])
    boxes_in = (all(np.isfinite(r.boxes.data).all() and (r.boxes.conf > 0.25).all() and len(r) <= 300 for r in res)
                and (centres >= 0).all() and (centres <= [640, 480]).all())  # unclipped boxes: their centres
    ok = (boxes_in and min(n_det) > 0 and launches == FAMILY_PREDICT_LAUNCHES
          and np.isfinite(vm["fitness"]) and yolo.validator.seen == RTDETR_VAL)
    info = {"predict_img_per_s": RTDETR_BATCH / dt, "detections_per_frame": [min(n_det), max(n_det)],
            "val": {k: vm[k] for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness")},
            "val_img_per_s": RTDETR_VAL / val_s, "val_times": yolo.validator.times, "launches": launches, "ok": ok}
    del yolo
    torch.cuda.empty_cache()
    return ok, info, launches


def rtdetr_steps(dev) -> tuple:
    """RTDETR_STEPS micro-steps of rtdetr-l at RTDETR_STEP_BATCH, 640 px, bf16
    over fp32 masters, SGD, device augmentation on, max_gt MAX_GT: the
    denoising group and the Hungarian-matched loss; the items finite, the
    micro-step ms (host clock, the card synchronised), the host ms of the
    assignment per micro-step (costs' copy, scipy, indices' copy), the peak
    memory, no kernel."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.utils import detr_loss

    tr = DetectionTrainer(overrides={**TRAIN, "model": RTDETR_FULL, "batch": RTDETR_STEP_BATCH, "max_gt": MAX_GT},
                          device=dev).setup()
    step, _ = tr._make_train_step(nb=TRAIN_NB)
    batches = train_batches(2, dev, b=RTDETR_STEP_BATCH)
    assign_s = []
    orig_hungarian = detr_loss.hungarian_assign

    def timed_hungarian(*a):  # the forward finished first: the costs, their copy, scipy, the indices' copy
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_hungarian(*a)
        assign_s[-1] += time.perf_counter() - t0
        return out

    detr_loss.hungarian_assign = timed_hungarian
    items, times = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    try:
        for i in range(RTDETR_STEPS):
            assign_s.append(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            items.append(step(batches[i % 2]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        detr_loss.hungarian_assign = orig_hungarian
    launches = counts()
    losses = torch.stack(items).float().cpu().numpy()
    ok = launches == FAMILY_PREDICT_LAUNCHES and bool(np.isfinite(losses).all()) and losses.shape == (RTDETR_STEPS, 3)
    info = {"batch": RTDETR_STEP_BATCH, "max_gt": MAX_GT, "items_giou_cls_l1": losses.tolist(),
            "micro_step_ms": 1e3 * float(np.mean(times[1:])), "assign_host_ms_per_step": 1e3 * float(np.mean(assign_s[1:])),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "launches": launches, "ok": ok}
    del tr, step
    torch.cuda.empty_cache()
    return ok, info, launches


def rtdetr_card_vs_cpu(dev) -> dict:
    """rtdetr-l's train-mode forward and loss in fp32 (TF32 off) at
    RTDETR_CPU_BATCH on the CPU and on the card, with the same seeded
    weights (the query paths drawn, draw_query_paths), batch and denoising
    draws. Held: the head alone on the card, fed the CPU's three feature
    maps (the query selection, the decoder with its box ladder and
    deformable sampling, the denoising group, the Hungarian-matched loss):
    the total and the items within RTDETR_ITEM_RTOL of the CPU's; each
    matched layer's assignment as anchors (the top-k orders scores that the
    two devices round apart, so a query's index names another anchor on
    each), the share that differs, and where one does, both assignments'
    total costs under the CPU's costs within RTDETR_TIE_RTOL (a near tie;
    an anchor that only one device selected is counted apart). Reported:
    the whole model on the card against the CPU, beside the CPU against
    itself with its input scaled by 1 + 1e-6 (the seeded backbone's
    train-mode BatchNorm at batch 2 and the drawn decoder amplify a
    rounding that far, so only the whole model's total is held to
    RTDETR_ITEM_RTOL, not its last layer's items)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.transformer import cdn_draws
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import _topk_first
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.detr_loss import assign_host, match_costs, rtdetr_loss

    batch = {k: v.cpu() for k, v in train_batches(1, dev, aug=False, b=RTDETR_CPU_BATCH)[0].items()}
    x = batch["img"].permute(0, 3, 1, 2).float() / 255.0
    draws = cdn_draws(RTDETR_CPU_BATCH, 2 * 3 * MAX_GT, 80, torch.Generator().manual_seed(SEED), "cpu")
    cpu = DetectionModel(RTDETR_FULL, device="cpu", seed=SEED).train()
    draw_query_paths(cpu)
    card = DetectionModel(RTDETR_FULL, device=dev, seed=SEED).train()
    card.load_state_dict(cpu.state_dict())

    def run(m, d, xin, feats=None):
        """(assignment (L, B, G), each query's anchor (B, nq), [total, giou,
        cls, l1], the matched layers' costs, the head's input maps) of the
        model m on device d, or of its head alone on `feats`."""
        t = {"cls": batch["cls"].long().to(d), "bboxes": batch["bboxes"].to(d), "mask": batch["mask"].to(d),
             "dn_draws": {k: v.to(d) for k, v in draws.items()}}
        head = m.model[-1]
        seen, taken = [], []
        hooks = [head.enc_score_head.register_forward_hook(lambda mod, i, o: seen.append(o.float().amax(-1))),
                 head.register_forward_pre_hook(lambda mod, a: taken.append([f.detach().cpu() for f in a[0]]))]
        try:
            if feats is None:
                preds = m(xin.to(d).contiguous(memory_format=torch.channels_last), targets=t)
            else:
                preds = head([f.to(d) for f in feats], t)
        finally:
            for h in hooks:
                h.remove()
        num_dn = preds["dec_bboxes"].shape[2] - preds["enc_bboxes"].shape[1]
        anchors = _topk_first(seen[0], preds["enc_bboxes"].shape[1])[1].cpu()
        mb = torch.cat([preds["enc_bboxes"][None], preds["dec_bboxes"][:, :, num_dn:]], 0)
        ms = torch.cat([preds["enc_scores"][None], preds["dec_scores"][:, :, num_dn:]], 0)
        cost = match_costs(mb, ms, t["bboxes"], t["cls"], t["mask"] > 0).cpu()
        q = torch.from_numpy(assign_host(cost.reshape(-1, *cost.shape[-2:]).numpy())).reshape(cost.shape[:-2] + (-1,))
        total, items = rtdetr_loss(preds, t["cls"], t["bboxes"], t["mask"], 80, num_dn=num_dn)
        return q, anchors, torch.stack([total, *items]).detach().cpu(), cost, taken[0]

    with torch.no_grad():
        q_cpu, a_cpu, v_cpu, cost, feats = no_tf32(run, cpu, "cpu", x)
        q_head, a_head, v_head, _, _ = no_tf32(run, card, dev, x, feats)
        q_card, a_card, v_card, _, _ = no_tf32(run, card, dev, x)
        v_self = no_tf32(run, cpu, "cpu", x * (1 + 1e-6))[2]
    valid = (batch["mask"] > 0)[None].expand_as(q_cpu)
    as_anchor = lambda q, a: a[None].expand(q.shape[0], -1, -1).gather(2, q)  # (L, B, G) anchors assigned
    rel = lambda v: ((v - v_cpu).abs() / v_cpu.abs()).tolist()

    def moved(q_dev, a_dev) -> dict:
        """How the device's assignment differs from the CPU's, as anchors."""
        differ = (as_anchor(q_cpu, a_cpu) != as_anchor(q_dev, a_dev)) & valid
        gaps, apart = [], 0
        for li, bi in {(int(a), int(b)) for a, b, _ in differ.nonzero()}:
            cols = valid[li, bi].nonzero()[:, 0]
            pos = {int(a): i for i, a in enumerate(a_cpu[bi].tolist())}
            dev_q = [pos.get(int(a_dev[bi, q])) for q in q_dev[li, bi, cols].tolist()]
            if None in dev_q:
                apart += 1
                continue
            mine = cost[li, bi][torch.tensor(dev_q), cols].sum().item()
            theirs = cost[li, bi][q_cpu[li, bi, cols], cols].sum().item()
            gaps.append(abs(mine - theirs) / abs(theirs))
        return {"assignment_moved_share": float(differ.sum() / valid.sum()),
                "moved_assignment_cost_gap": max(gaps, default=0.0), "moved_with_an_anchor_one_side_only": apart,
                "query_order_moved_share": float((a_cpu != a_dev).float().mean())}

    head_alone = {"total_and_items_rel_err": rel(v_head), **moved(q_head, a_head)}
    info = {"batch": RTDETR_CPU_BATCH, "head_alone": head_alone,
            "whole_model": {"total_and_items_rel_err": rel(v_card), **moved(q_card, a_card)},
            "cpu_input_times_1_plus_1e-6_rel_err": rel(v_self),
            "cpu": v_cpu.tolist(), "card_head_alone": v_head.tolist(), "card": v_card.tolist()}
    info["ok"] = (max(head_alone["total_and_items_rel_err"]) <= RTDETR_ITEM_RTOL
                  and head_alone["moved_assignment_cost_gap"] <= RTDETR_TIE_RTOL
                  and abs(v_card[0] - v_cpu[0]).item() <= RTDETR_ITEM_RTOL * abs(v_cpu[0]).item()
                  and bool(torch.isfinite(v_card).all()))
    del cpu, card
    torch.cuda.empty_cache()
    return info


def phase_rtdetr(dev):
    """RT-DETR (the module docstring's rtdetr phase)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel

    checks = [rtdetr_check(RTDETR_FULL, dev)]
    path = [checks[0]["launches"]]
    model = DetectionModel(RTDETR_FULL, device=dev, seed=SEED, dtype=torch.bfloat16)
    draw_query_paths(model)
    model.fuse()
    reset_counts()
    with zero_class_priors(model):
        forward = rtdetr_forward_ms(model, dev)
    path.append(counts())
    del model
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_rtdetr_"))
    try:
        serve_ok, serve, serve_launches = rtdetr_serve(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    path.append(serve_launches)
    step_ok, steps, step_launches = rtdetr_steps(dev)
    path.append(step_launches)
    card_cpu = rtdetr_card_vs_cpu(dev)
    for cfg in RTDETR_OTHERS:
        checks.append(rtdetr_check(cfg, dev))
        path.append(checks[-1]["launches"])
    ok = all(c["ok"] for c in checks) and serve_ok and step_ok and card_cpu["ok"]
    return ok, {"forwards_bf16_vs_fp32": checks, "full_width": {str(RTDETR_FULL): {"forward": forward, "serve": serve,
                                                                               "micro_steps": steps,
                                                                               "loss_card_vs_cpu": card_cpu}}}, \
        {"rtdetr": add_counts(*path)}


def coco_names() -> list:
    """The 80 COCO class names, from the port's coco8 descriptor."""
    import yaml

    d = yaml.safe_load((Path(__file__).resolve().parent / PKG / "cfg" / "datasets" / "coco8.yaml").read_text())
    names = d["names"]
    return [names[i] for i in range(len(names))] if isinstance(names, dict) else list(names)


def world_check(cfg, dev) -> dict:
    """cfg readied (ready: the COCO prompts, unit gain), its class prior
    zeroed (every anchor then scores about 0.1 to 0.9 on some prompt):
    YOLO(cfg).predict of the slice phase's frames in bf16 (BN-folded, as
    predict runs it), boxes inside the frames and named by the prompts, no
    kernel launched; the fp32 unfused forward of the same
    seeded weights on the card (TF32 off) against the CPU's, each raw map
    and decoded channel within WORLD_CPU_RTOL of its largest magnitude; the
    bf16 folded forward's gap to fp32 on the card within WORLD_BF16_SLACK
    times the same gap on the CPU."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    frames = slice_frames()
    yolo = YOLO(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    fp32 = YOLO(cfg, device="cuda", dtype=torch.float32, seed=SEED)
    ready(yolo.model)
    ready(fp32.model)
    with zero_class_priors(yolo.model), zero_class_priors(fp32.model):
        results, launches = counted(lambda: yolo.predict(frames, imgsz=640, conf=0.25, batch=8, verbose=False))
        cpu16, cpu32 = copy.deepcopy(yolo.model).cpu(), copy.deepcopy(fp32.model).cpu()
        x16, x32 = letterboxed(frames, 640, dev, torch.bfloat16), letterboxed(frames, 640, dev, torch.float32)
        with torch.inference_mode():
            card16, card32 = yolo.model(x16), no_tf32(fp32.model, x32)
            host16, host32 = cpu16(x16.cpu()), cpu32(x32.cpu())

    def gaps(a, b) -> list:  # each raw map's, then the largest decoded channel's, over b's largest magnitude
        (out, maps), (ref, ref_maps) = a, b
        return ([rel_err(m.cpu(), r.cpu()) for m, r in zip(maps, ref_maps)]
                + [max(rel_err(out[:, i].cpu(), ref[:, i].cpu()) for i in range(ref.shape[1]))])

    errs = {"fp32_card_vs_cpu": gaps(card32, host32), "bf16_vs_fp32_card": gaps(card16, card32),
            "bf16_vs_fp32_cpu": gaps(host16, host32)}
    out = card16[0]
    names = coco_names()
    ok = (launches == FAMILY_PREDICT_LAUNCHES and len(results) == 8 and boxes_ok(results, 480, 640)
          and sum(map(len, results)) > 0 and results[0].names == dict(enumerate(names)) and yolo.is_fused
          and out.shape[1] == 4 + len(names) and bool(torch.isfinite(out).all())
          and max(errs["fp32_card_vs_cpu"]) <= WORLD_CPU_RTOL
          and all(c <= WORLD_BF16_SLACK * h for c, h in zip(errs["bf16_vs_fp32_card"], errs["bf16_vs_fp32_cpu"])))
    info = {"model": cfg, "params": sum(p.numel() for p in fp32.model.parameters()), "prompts": len(names),
            "launches": launches, "detections_per_frame": [len(r) for r in results],
            "class_scores": [float(out[:, 4:].min()), float(out[:, 4:].max())],
            "rel_err_maps_then_decoded": errs, "ok": bool(ok)}
    del yolo, fp32, cpu16, cpu32
    torch.cuda.empty_cache()
    return info


def world_serve(dev) -> tuple:
    """yolov8s-worldv2 in bf16, BN-folded, readied (ready): the forward's ms
    at WORLD_BATCH (CUDA events) with its device time by kernel, and
    yolov8s-world's (ImagePoolingAttn) beside it; with the class prior
    zeroed, predict of the slice phase's frames at WORLD_BATCH (img/s;
    every anchor has a class score over conf, so NMS runs at full load); then
    set_classes to WORLD_SWAP: the output (B, 4 + 3, A), predict's classes
    among the three and named by them; no kernel launched."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLOWorld

    xb = torch.rand(WORLD_BATCH, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    forward, path = {}, []
    for cfg in (WORLD_FULL, WORLD_V1):
        y = YOLOWorld(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
        ready(y.model)
        y.fuse()
        reset_counts()
        with torch.inference_mode():
            ms = cuda_ms(lambda: y.model(xb), iters=10)
        forward[cfg] = {"batch": WORLD_BATCH, "forward_ms": ms, "forward_img_per_s": WORLD_BATCH * 1e3 / ms,
                        "profile": forward_profile(y.model, xb, ms, "elementwise", key="elementwise_share",
                                                   more={"adaptive_pool_share": ("adaptive_max_pool",)})}
        path.append(counts())
        if cfg == WORLD_FULL:
            yolo = y
        else:
            del y
    frames = slice_frames() * (WORLD_BATCH // 8)
    kw = dict(imgsz=640, batch=WORLD_BATCH, conf=0.25, verbose=False)
    with zero_class_priors(yolo.model):
        yolo.predict(frames, **kw)  # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = yolo.predict(frames, **kw)
        dt = time.perf_counter() - t0
        path.append(counts())
        yolo.set_classes(WORLD_SWAP)
        with torch.inference_mode():
            width = yolo.model(xb[:8])[0].shape[1]
        swapped, launches = counted(lambda: yolo.predict(slice_frames(), imgsz=640, conf=0.25, batch=8,
                                                         verbose=False))
        path.append(launches)
    classes = {int(c) for r in swapped for c in r.boxes.cls}
    ok = (boxes_ok(res, 480, 640) and min(len(r) for r in res) > 0 and width == 4 + len(WORLD_SWAP)
          and yolo.model.nc == len(WORLD_SWAP) and classes <= set(range(len(WORLD_SWAP))) and len(classes) > 0
          and swapped[0].names == dict(enumerate(WORLD_SWAP)) and all(c == FAMILY_PREDICT_LAUNCHES for c in path))
    info = {"forward": forward, "predict_img_per_s_at_full_load": WORLD_BATCH / dt,
            "detections_per_frame": [min(map(len, res)), max(map(len, res))],
            "set_classes": {"prompts": list(WORLD_SWAP), "output_channels": width,
                            "detections_per_frame": [len(r) for r in swapped], "classes_seen": sorted(classes)},
            "ok": bool(ok)}
    del yolo, xb
    torch.cuda.empty_cache()
    return ok, info, add_counts(*path)


def phase_world(dev):
    """YOLO-World (the module docstring's world phase)."""
    rng = np.random.default_rng(SEED)  # the int8 phase's calibration frames
    calib = [rng.integers(0, 255, (8, 640, 640, 3), dtype=np.uint8) for _ in range(2)]
    checks = [world_check(cfg, dev) for cfg in (WORLD_FULL, WORLD_V1)]
    path = [c["launches"] for c in checks]
    serve_ok, serve, serve_launches = world_serve(dev)
    path.append(serve_launches)
    train_ok, train, (tr, step), train_launches = train_run(dev, {"model": WORLD_FULL}, TRAIN_STEPS,
                                                            FAMILY_STEP_LAUNCHES)
    cycle = itertools.cycle(train_batches(4, dev))
    step_ms = cuda_ms(lambda: step(next(cycle)), iters=8, warmup=4)
    train.update(nc=tr.model.nc, micro_step_ms_batch16=step_ms, train_img_per_s=TRAIN["batch"] * 1e3 / step_ms)
    del tr, step
    torch.cuda.empty_cache()
    path.append(train_launches)
    int8_ok, int8, int8_launches = int8_full(WORLD_FULL, calib, slice_frames(), dev)
    path.append(int8_launches)

    def trained_names(best) -> dict:  # best.pt reloads the data's names and scores against their features
        from improving_yolov8_cbam_swinblock_tpu_torch.utils.text_model import encode_texts

        names = list(best.names.values())
        same = torch.equal(best.model.txt_feats.cpu(), torch.from_numpy(encode_texts(names))[None])
        return {"names": names, "nc": best.model.nc, "features_of_the_names": bool(same),
                "ok": bool(same and best.model.is_world and names == ["object"])}

    fit, fit_launches = one_epoch_fit(WORLD_FULL, FAMILY_STEP_LAUNCHES, trained_names)
    path.append(fit_launches)
    ok = all(c["ok"] for c in checks) and serve_ok and train_ok and int8_ok and fit["ok"]
    return ok, {"forwards_bf16_vs_fp32": checks, "full_width": {WORLD_FULL: {"serve": serve, "train": train,
                                                                             "int8": int8, "fit": fit}}}, \
        {"world": add_counts(*path)}


def raw_maps(model, out) -> list:
    """The head's raw per-level maps of an eval output (both branches' of a
    YOLOv10 head): what the int8 convs feed, before the decode (whose boxes a
    seeded model's near-constant box logits pin to the anchors)."""
    if model.end2end:
        return list(out[1]["one2many"]) + list(out[1]["one2one"])
    return list(out[1][0] if model.task in ("segment", "pose", "obb") else out[1])


def int8_outputs(model, out) -> list:
    """The outputs a check holds: a YOLOv10 head's raw maps of both branches
    (its top-k orders near-equal scores by a rounding), a seg head's
    prediction and prototypes, a pose head's prediction and raw keypoints,
    else the decoded prediction."""
    if model.end2end:
        return list(out[1]["one2many"]) + list(out[1]["one2one"])
    if model.task == "segment":
        return [out[0], out[1][2]]
    if model.task == "pose":
        return [out[0], out[1][1]]
    return [out[0]]


def int8_card_vs_cpu(cfg, calib, frames, dev) -> dict:
    """cfg with fp32 weights and compute, readied (ready), BN-folded,
    quantized on the card on
    `calib`, then copied to the CPU: its outputs (int8_outputs) on the first
    two frames on the card (TF32 off) and on the CPU, each within
    INT8_CPU_MAX (or INT8_CPU_SLACK times the CPU's own gap when its input
    moves by one ulp, where larger) / INT8_CPU_MEAN of its largest
    magnitude, with the share of values that moved beyond fp32 rounding
    (1e-6 of the largest)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model

    q = YOLO(cfg, device="cuda", dtype=torch.float32, param_dtype=torch.float32, seed=SEED)
    ready(q.model)
    quantize_model(q.fuse().model, calib)
    cpu = copy.deepcopy(q.model).to("cpu")
    x = letterboxed(frames[:2], 640, dev, torch.float32)
    with torch.inference_mode():
        got = [t.float().cpu() for t in int8_outputs(q.model, no_tf32(q.model, x))]
        t0 = time.perf_counter()
        ref = [t.float() for t in int8_outputs(cpu, cpu(x.cpu()))]
        cpu_s = time.perf_counter() - t0
        own = [t.float() for t in int8_outputs(cpu, cpu(x.cpu() * (1 + 2.0 ** -23)))]
    rows = []
    for g, r, o in zip(got, ref, own):
        d, top = (g - r).abs(), r.abs().max().clamp(min=1e-12)
        rows.append({"shape": list(r.shape), "max_rel": float(d.max() / top), "mean_rel": float(d.mean() / top),
                     "share_moved": float((d > 1e-6 * top).float().mean()),
                     "cpu_one_ulp_max_rel": float((o - r).abs().max() / top)})
    ok = all(torch.isfinite(g).all() for g in got) and all(
        r["max_rel"] <= max(INT8_CPU_MAX, INT8_CPU_SLACK * r["cpu_one_ulp_max_rel"]) and r["mean_rel"] <= INT8_CPU_MEAN
        for r in rows)
    del q, cpu
    torch.cuda.empty_cache()
    return {"ok": bool(ok), "batch": 2, "outputs": rows, "cpu_forward_s": cpu_s, "max_rtol": INT8_CPU_MAX,
            "mean_rtol": INT8_CPU_MEAN, "slack": INT8_CPU_SLACK}


def int8_full(cfg, calib, frames, dev) -> tuple:
    """One of INT8_FULL at 640 px: quantized (bf16 compute over fp32
    weights) on `calib` with the calibration's launches; its int8 forward's
    ms at INT8_GRAPH_BATCH beside the bf16 model's (bf16 weights,
    BN-folded: the families, v10 and segment phases' forward), CUDA events;
    the int8 forward's device time by kernel (torch.profiler); the int8
    predict of the 8 frames with its launches (no kernel: these graphs hold
    no SwinBlock); the card against the CPU (int8_card_vs_cpu). Each model
    is readied first (ready)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import Conv

    yolo, float_model, calib_launches, calib_s = quantized(cfg, calib)
    del float_model
    convs = [m for m in yolo.model.modules() if isinstance(m, Conv)]
    results, launches = counted(lambda: yolo.predict(frames, imgsz=640, conf=0.001, batch=8, verbose=False))
    bf = YOLO(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
    ready(bf.model)
    bf.fuse()
    xb = torch.rand(INT8_GRAPH_BATCH, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        int8_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
        bf16_ms = cuda_ms(lambda: bf.model(xb), iters=10)
        int8_again = cuda_ms(lambda: yolo.model(xb), iters=10)
        x8 = letterboxed(frames, 640, dev, torch.bfloat16)
        gaps = [(a.float() - b.float()).abs() / b.float().abs().max().clamp(min=1e-12)
                for a, b in zip(raw_maps(yolo.model, yolo.model(x8)), raw_maps(bf.model, bf.model(x8)))]
    by_kernel = forward_profile(yolo.model, xb, min(int8_ms, int8_again), "s8", "i8", "imma", key="int8_gemm_share")
    del bf, xb
    torch.cuda.empty_cache()
    cpu = int8_card_vs_cpu(cfg, calib, frames, dev)
    ok = (launches == FAMILY_PREDICT_LAUNCHES and calib_launches == FAMILY_PREDICT_LAUNCHES and len(results) == 8
          and (obb_ok(results) if yolo.task == "obb" else boxes_ok(results, 480, 640)) and cpu["ok"])
    info = {"model": cfg, "ok": bool(ok), "int8_convs": sum(m.runs_int8 for m in convs),
            "float_convs": sum(m.w_int8 is None or not m.runs_int8 for m in convs), "calibrate_s": calib_s,
            "calibration_launches": calib_launches, "predict_launches": launches,
            "detections_per_frame": [len(r) for r in results], "batch": INT8_GRAPH_BATCH,
            "int8_forward_ms": [int8_ms, int8_again], "bf16_forward_ms": bf16_ms,
            "int8_over_bf16": min(int8_ms, int8_again) / bf16_ms, "int8_forward_by_kernel": by_kernel,
            "int8_vs_bf16_raw_maps": [{"max_rel": float(g.max()), "mean_rel": float(g.mean())} for g in gaps],
            "card_vs_cpu": cpu}
    del yolo
    torch.cuda.empty_cache()
    return ok, info, launches


def int8_sweep(cfg, calib, frames) -> tuple:
    """cfg at its smallest scale quantized on one calibration batch, then one
    int8 forward at batch 8 of the letterboxed frames: finite outputs."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model

    y = YOLO(cfg, device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32, seed=SEED).fuse()
    reset_counts()
    quantize_model(y.model, calib[:1])
    x = letterboxed(frames, 640, y.model.device, torch.bfloat16)
    with torch.inference_mode():
        out = int8_outputs(y.model, y.model(x))
        torch.cuda.synchronize()
    launches = counts()
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    ok = finite and launches == FAMILY_PREDICT_LAUNCHES
    info = {"model": cfg, "ok": bool(ok), "finite": finite, "shapes": [list(t.shape) for t in out],
            "int8_convs": sum(bool(getattr(m, "runs_int8", False)) for m in y.model.modules())}
    del y
    torch.cuda.empty_cache()
    return ok, info, launches


def rtdetr_int8(calib, frames, dev) -> tuple:
    """rtdetr-l with fp32 weights and bf16 compute, the query paths drawn
    (draw_query_paths) and the score heads' priors zeroed, BN-folded, and
    its copy quantized on `calib` (its input projections and backbone convs
    int8, AIFI and the decoder float): the int8 and bf16 forwards' ms at
    INT8_GRAPH_BATCH (CUDA events); the int8 queries against the bf16 ones
    at RTDETR_CHECK_BATCH, matched by anchor (rtdetr_queries: the card's
    top-k orders near-equal scores by their rounding): the share of the
    bf16 queries' anchors int8 also selects (RTDETR_INT8_SHARED), and of the
    kept bf16 queries (score over 0.25) whose anchor both select, the share
    with the same top-1 class (RTDETR_INT8_TOP1), the boxes' and scores'
    largest gaps; an int8 predict of the 8 frames with no kernel launched."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import Conv

    bf = YOLO(RTDETR_FULL, device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32, seed=SEED)
    draw_query_paths(bf.model)
    with torch.no_grad():
        for _, b in class_biases(bf.model):
            b.zero_()
    bf.fuse()
    yolo = copy.deepcopy(bf)
    reset_counts()
    t0 = time.perf_counter()
    quantize_model(yolo.model, calib)
    torch.cuda.synchronize()
    calib_s, calib_launches = time.perf_counter() - t0, counts()
    x = torch.rand(RTDETR_CHECK_BATCH, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    (y8, a8), (yb, ab) = rtdetr_queries(yolo.model, x), rtdetr_queries(bf.model, x)
    shared, kept, same, box_err, score_err = 0, 0, 0, 0.0, 0.0
    for b in range(x.shape[0]):
        pos8 = {int(a): i for i, a in enumerate(a8[b].tolist())}
        for i, a in enumerate(ab[b].tolist()):
            j = pos8.get(int(a))
            if j is None:
                continue
            shared += 1
            box_err = max(box_err, (y8[b, j, :4] - yb[b, i, :4]).abs().max().item())
            score_err = max(score_err, (y8[b, j, 4:] - yb[b, i, 4:]).abs().max().item())
            if yb[b, i, 4:].max() > 0.25:
                kept += 1
                same += int(y8[b, j, 4:].argmax() == yb[b, i, 4:].argmax())
    xb = torch.rand(INT8_GRAPH_BATCH, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        int8_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
        bf16_ms = cuda_ms(lambda: bf.model(xb), iters=10)
    results, launches = counted(lambda: yolo.predict(frames, imgsz=640, conf=0.25, batch=8, verbose=False))
    convs = [m for m in yolo.model.modules() if isinstance(m, Conv)]
    n = ab.numel()
    info = {"model": RTDETR_FULL, "int8_convs": sum(m.runs_int8 for m in convs),
            "input_proj_int8": all(m.runs_int8 for m in yolo.model.model[-1].input_proj),
            "calibrate_s": calib_s, "calibration_launches": calib_launches, "queries": n,
            "shared_anchor_share": shared / n, "kept_bf16": kept, "same_top1_share": same / max(kept, 1),
            "box_abs_err": box_err, "score_abs_err": score_err, "batch": INT8_GRAPH_BATCH, "int8_forward_ms": int8_ms,
            "bf16_forward_ms": bf16_ms, "int8_over_bf16": int8_ms / bf16_ms, "predict_launches": launches,
            "detections_per_frame": [len(r) for r in results]}
    info["ok"] = bool(torch.isfinite(y8).all() and shared / n >= RTDETR_INT8_SHARED and kept > 0
                      and same / kept >= RTDETR_INT8_TOP1 and info["input_proj_int8"]
                      and launches == FAMILY_PREDICT_LAUNCHES == calib_launches
                      and all(np.isfinite(r.boxes.data).all() for r in results) and sum(map(len, results)) > 0)
    del yolo, bf, xb
    torch.cuda.empty_cache()
    return info["ok"], info, add_counts(calib_launches, launches)


def phase_int8_graphs(dev):
    """int8 of the graphs added since the fork's (the module docstring's int8_graphs phase)."""
    rng = np.random.default_rng(SEED)  # the int8 phase's calibration frames, and the exporter's synthetic ones
    calib = [rng.integers(0, 255, (8, 640, 640, 3), dtype=np.uint8) for _ in range(2)]
    frames = slice_frames()
    full, sweep, path = {}, [], []
    for cfg in INT8_FULL:
        _, info, launches = int8_full(cfg, calib, frames, dev)
        full[cfg] = info
        path.append(launches)
    _, full[RTDETR_FULL], launches = rtdetr_int8(calib, frames, dev)
    path.append(launches)
    for cfg in INT8_SWEEP:
        _, info, launches = int8_sweep(cfg, calib, frames)
        sweep.append(info)
        path.append(launches)
    ok = all(v["ok"] for v in full.values()) and all(r["ok"] for r in sweep)
    return ok, {"full_width": full, "smallest_scale": sweep}, {"int8_graphs": add_counts(*path)}


def same_extras(g, r) -> bool:
    """Two Results' masks, keypoints and oriented boxes both absent, or equal bit for bit."""
    return all((a is None) == (b is None) and (a is None or np.array_equal(a.data, b.data))
               for a, b in ((g.masks, r.masks), (g.keypoints, r.keypoints), (g.obb, r.obb)))


def program_check(live, path: str, frames, batches=PROGRAM_BATCHES) -> dict:
    """YOLO(path) (the program, on the card) against the live YOLO: predict
    of the frames at conf 0.25 at each of `batches`, boxes (and masks, and
    keypoints) bit for bit, and the launches of the program's predict; an
    RT-DETR program through the predictor's NMS-free path, a World
    program with the live model's names."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    t0 = time.perf_counter()
    served = YOLO(path)
    row = {"load_s": time.perf_counter() - t0, "task": served.task, "by_batch": {}}
    ok = (served.task == live.task and served.model.is_rtdetr == live.model.is_rtdetr
          and served.names == live.names)
    for b in batches:
        got, launches = counted(lambda: served.predict(frames, conf=0.25, batch=b, verbose=False))
        ref = live.predict(frames, imgsz=640, conf=0.25, batch=b, verbose=False)
        same = len(got) == len(ref) and all(np.array_equal(g.boxes.data, r.boxes.data) and same_extras(g, r)
                                            for g, r in zip(got, ref))
        row["by_batch"][b] = {"bit_for_bit": bool(same), "detections": [len(r) for r in ref], "launches": launches}
        ok &= same and sum(len(r) for r in ref) > 0 and launches == FAMILY_PREDICT_LAUNCHES
    row["ok"] = bool(ok)
    return row


def program_specs() -> list:
    """(cfg, kind, dynamic) of every program the programs process holds."""
    return ([(cfg, "bf16", True) for cfg in FLOAT_PROGRAMS] + [(cfg, "int8", True) for cfg in INT8_PROGRAMS]
            + list(QUERY_WORLD_PROGRAMS))


def ready(model) -> None:
    """A DetectionModel, before fuse, as the checks take it: an RT-DETR
    head's query paths drawn (draw_query_paths); a World graph at the COCO
    prompts and at unit gain (unit_gain); another graph as it is."""
    if model.is_rtdetr:
        draw_query_paths(model)
    if model.is_world:
        model.set_classes(coco_names())
        unit_gain(model)


@torch.no_grad()
def unit_gain(model) -> None:
    """Rescale the kernel of every Conv of `model` (before fuse) so that its
    conv's output has unit RMS, layer after layer, on a seeded batch of 2
    at UNIT_GAIN_SIZE px, measured in fp32 on the CPU on a copy. The seeded
    init (variance 1/(3 fan_in)) shrinks the features about threefold a
    layer, to 1e-9 at P5, where a check would hold constants; rescaled, they
    stay near unit RMS down to the head. The gains come from the model's own
    weights (bf16 ones widened), so two models of one graph and seed get the
    same gains to within a bf16 rounding."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import Conv

    ref = copy.deepcopy(model).to("cpu", torch.float32).eval()
    ref.dtype = torch.float32
    convs = [(m.conv, r.conv) for m, r in zip(model.modules(), ref.modules()) if isinstance(m, Conv)]
    gains = {}

    def hook(mod, inp, out):
        if mod in gains:
            raise RuntimeError("unit_gain: a conv ran twice in one forward")
        gains[mod] = out.pow(2).mean().rsqrt()
        return out * gains[mod]

    hooks = [r.register_forward_hook(hook) for _, r in convs]
    ref(torch.rand(2, 3, UNIT_GAIN_SIZE, UNIT_GAIN_SIZE, generator=torch.Generator().manual_seed(SEED)))
    for h in hooks:
        h.remove()
    if len(gains) != len(convs) or any(c.bias is not None for c, _ in convs):
        raise RuntimeError(f"unit_gain: {len(gains)} of {len(convs)} convs ran, or the model is fused")
    for c, r in convs:
        c.weight.mul_(gains[r].to(c.weight))


def programs_run(out: Path) -> int:
    """The programs process (--programs DIR, started by main beside the
    other phases): the dynamic programs of FLOAT_PROGRAMS (bf16, BN-folded,
    yolov8s-seg's and yolov8s-pose's among them) and of INT8_PROGRAMS (int8:
    the exporter's calibration on its synthetic frames, the int8 phase's),
    and QUERY_WORLD_PROGRAMS (rtdetr-l static at STATIC_PROGRAM_BATCH, held
    at that batch, and dynamic; yolov8s-worldv2 int8 at the COCO prompts:
    ready), exported on the card at 640 px with the class priors zeroed;
    each held to its live model (program_check) on the slice phase's first
    three frames. Writes DIR/programs.json (the programs themselves go to a
    temporary directory, removed as each is checked)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    torch.set_num_threads(1)  # beside the main process: tracing is host work on one core
    rng = np.random.default_rng(SEED)
    calib = [rng.integers(0, 255, (8, 640, 640, 3), dtype=np.uint8) for _ in range(2)]
    frames = slice_frames()[:3]
    rows = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_program_files_"))  # the .pt2 files, each removed once checked
    for cfg, kind, dynamic in program_specs():
        t0 = time.perf_counter()
        name = f"{Path(cfg).stem}_{kind}" + ("" if dynamic else f"_static{STATIC_PROGRAM_BATCH}")
        try:
            src = YOLO(cfg, device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32 if kind == "int8" else None,
                       seed=SEED)
            ready(src.model)
            if kind == "int8":
                live = quantized(cfg, calib)[0]
            else:
                live = src.fuse()
            with zero_class_priors(src.model), zero_class_priors(live.model):
                path = src.export(format="pt2", imgsz=640, dynamic=dynamic, batch=STATIC_PROGRAM_BATCH,
                                  int8=kind == "int8", half=kind == "bf16", project=str(tmp / name))
                export_s = time.perf_counter() - t0
                row = program_check(live, path, frames, PROGRAM_BATCHES if dynamic else (STATIC_PROGRAM_BATCH,))
            row.update(export_s=export_s, path=Path(path).name)
        except Exception as e:  # noqa: BLE001  a failed program is a failed row, and the others still run
            row = {"ok": False, "error": f"{type(e).__name__}: {e}"[:400]}
        row["seconds"] = time.perf_counter() - t0
        rows[name] = row
        shutil.rmtree(tmp / name, ignore_errors=True)
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    (out / "programs.json").write_text(json.dumps(rows, default=str))
    return 0 if all(r["ok"] for r in rows.values()) else 1


def start_programs() -> tuple:
    """Start the programs process (programs_run) on the card: (process, its directory)."""
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_programs_"))
    log = open(d / "log.txt", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--programs", str(d)], stdout=log,
                            stderr=subprocess.STDOUT, cwd=str(Path(__file__).resolve().parent))
    log.close()
    return proc, d


def phase_programs(proc, d: Path, timeout: float):
    """Wait for the programs process and read its rows (killed at the timeout)."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    try:
        rows = json.loads((d / "programs.json").read_text())
    except (OSError, ValueError):
        rows = {}
    tail = (d / "log.txt").read_text()[-1500:] if (d / "log.txt").exists() else ""
    shutil.rmtree(d, ignore_errors=True)
    ok = rc == 0 and len(rows) == len(program_specs()) and all(r["ok"] for r in rows.values())
    info = {"rc": rc, "programs": rows}
    if not ok:
        info["log_tail"] = tail
    return ok, info


def phase_yolo11(dev):
    """The fork's YOLO11 graph at scale m (the module docstring's yolo11 phase)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    frames = slice_frames()
    yolo = YOLO(YOLO11, device="cuda", dtype=torch.bfloat16, seed=SEED)
    widths = sorted({m.norm1.weight.numel() for m in swin_modules(yolo.model)})
    reset_counts()
    t0 = time.perf_counter()
    results = yolo.predict(frames, imgsz=640, conf=0.001, batch=8, verbose=False)
    predict_s = time.perf_counter() - t0
    predict_launches = counts()
    boxes_good = boxes_ok(results, 480, 640)
    x = letterboxed(frames, 640, dev, torch.bfloat16)
    bf16_ok, bf16_err, out_shape = compare_forward(yolo.model, x, 3e-2)
    fp32 = YOLO(YOLO11, device="cuda", dtype=torch.float32, seed=SEED).fuse()
    fp32_ok, fp32_err, _ = no_tf32(compare_forward, fp32.model, letterboxed(frames, 640, dev, torch.float32), 2e-3)
    del fp32
    predict_ok = (predict_launches == PREDICT_LAUNCHES and len(results) == 8 and boxes_good and bf16_ok and fp32_ok
                  and out_shape == (8, 5, 8400) and widths == [512])

    train_ok, train_info, (tr, step), train_launches = train_run(dev, {"model": YOLO11}, YOLO11_STEPS)

    # one epoch of YOLO.train with validation, then YOLO(best.pt).val, on the fit phase's dataset
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_yolo11_"))
    steps, vals = [], []
    try:
        data = write_fit_dataset(tmp / "data")
        fy = YOLO(YOLO11, device="cuda", seed=SEED)
        reset_counts()
        with counted_fit(steps, vals):
            t0 = time.perf_counter()
            metrics = fy.train(data=str(data), project=str(tmp / "runs"), **{**FIT, "epochs": 1, "save_period": -1})
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            fit_launches = counts()
            best = YOLO(str(fy.trainer.wdir / "best.pt"), device="cuda")
            vm = best.val(data=str(data), batch=FIT["batch"], imgsz=FIT["imgsz"], workers=FIT["workers"],
                          verbose=False)
        e = fy.trainer.epoch_stats[0]
        fit_ok = (len(steps) == 4 and all(st["launches"] == STEP_LAUNCHES for st in steps) and len(vals) == 4
                  and all(v == PREDICT_LAUNCHES for v in vals)
                  and all(np.isfinite(list(metrics.values()))) and all(np.isfinite(list(vm.values())))
                  and all(np.isfinite([r[k] for r in fy.trainer.metrics_rows for k in r if k.startswith("train/")])))
        fit = {"train_call_s": fit_s, "launches": fit_launches, "launches_per_step": steps,
               "launches_per_val_batch": vals, "final_metrics": metrics, "val_best_pt": dict(vm),
               "train_img_per_s_with_loader": e["batches"] * FIT["batch"] / e["train_s"],
               "val_img_per_s": e["val_seen"] / e["val_s"], "ok": fit_ok}
        del fy, best
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # speed: forward at batch 32 (BN-folded, as predict runs it), train micro-step at batch 16
    bs = 32
    xb = torch.rand(bs, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
    profile = forward_profile(yolo.model, xb, fwd_ms, "swin_block_fwd")
    cycle = itertools.cycle(train_batches(4, dev))
    step_ms = cuda_ms(lambda: step(next(cycle)), iters=8, warmup=4)
    del tr, step, yolo
    torch.cuda.empty_cache()
    return predict_ok and train_ok and fit["ok"], {
        "model": YOLO11, "swin_widths": widths, "predict_launches": predict_launches,
        "detections_per_frame": [len(r) for r in results], "boxes_ok": bool(boxes_good),
        "predict_s_first_call": predict_s, "decoded_shape": list(out_shape),
        "bf16_kernel_vs_plain_rel_err": bf16_err, "fp32_kernel_vs_plain_rel_err": fp32_err, "predict_ok": predict_ok,
        "train": train_info, "fit": fit,
        "forward_ms_batch32": fwd_ms, "forward_img_per_s": bs * 1e3 / fwd_ms, "forward_profile": profile,
        "train_ms_per_step_batch16": step_ms, "train_img_per_s": TRAIN["batch"] * 1e3 / step_ms,
    }, {"yolo11_predict": predict_launches, "yolo11_train": train_launches, "yolo11_fit": fit_launches}


def phase_flagship_l(dev):
    """The flagship at scale l (Swin at C=512): one predict batch of the
    slice phase's frames and its forward against the plain Swin version
    (3e-2 of each output's largest magnitude, bf16), and one train
    micro-step at batch 16 with finite losses, each with its launches
    counted."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionTrainer

    frames = slice_frames()
    yolo = YOLO(FLAGSHIP_L, device="cuda", dtype=torch.bfloat16, seed=SEED)
    widths = sorted({m.norm1.weight.numel() for m in swin_modules(yolo.model)})
    reset_counts()
    results = yolo.predict(frames, imgsz=640, conf=0.001, batch=8, verbose=False)
    predict_launches = counts()
    fwd_ok, fwd_err, out_shape = compare_forward(yolo.model, letterboxed(frames, 640, dev, torch.bfloat16), 3e-2)
    del yolo
    tr = DetectionTrainer(overrides={**TRAIN, "model": FLAGSHIP_L}).setup()
    step, _ = tr._make_train_step(nb=TRAIN_NB)
    batch = train_batches(1, dev)[0]
    reset_counts()
    items = step(batch)
    torch.cuda.synchronize()
    step_launches = counts()
    del tr, step
    torch.cuda.empty_cache()
    ok = (predict_launches == PREDICT_LAUNCHES and step_launches == STEP_LAUNCHES and widths == [512]
          and len(results) == 8 and boxes_ok(results, 480, 640) and fwd_ok and out_shape == (8, 5, 8400)
          and bool(torch.isfinite(items).all()))
    return ok, {"model": FLAGSHIP_L, "swin_widths": widths, "predict_launches": predict_launches,
                "kernel_vs_plain_rel_err": fwd_err, "step_launches": step_launches, "loss_items": items.tolist()}, \
        {"flagship_l_predict": predict_launches, "flagship_l_train": step_launches}


def int8_swin_layers(model, x):
    """Each int8 SwinBlock of `model` on the input it receives there in one
    forward on x: K4 against its plain version on the same int8 input
    (int8_compare: INT8_LEVELS, INT8_SHARE)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin_int8 import q8, swin_block_int8

    outs, rows = swin_outputs(model, x), {}
    with torch.inference_mode():
        for m in swin_modules(model):
            xq = q8(outs[m.i][0].permute(0, 2, 3, 1).float(), m.x_in_scale).to(torch.int8)
            q, p = {k: getattr(m, k) for k in m.QNAMES}, m.kernel_params()
            got = swin_block_int8(xq, p, q, m.num_heads, m.window_size, in8=True, out8=True)
            ref = swin_block_int8(xq, p, q, m.num_heads, m.window_size, in8=True, out8=True, impl="plain")
            rows[m.i] = {"shape": list(xq.shape), **int8_compare(got, ref)}
    return bool(rows) and all(r["ok"] for r in rows.values()), rows


def quantized(cfg, calib):
    """YOLO(cfg) with fp32 weights, bf16 compute, readied (ready), BN-folded,
    quantized by quantize_model on
    `calib`: (the YOLO, a float copy taken before, the launches and seconds
    of the calibration)."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, quantize_model

    yolo = YOLO(cfg, device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32, seed=SEED)
    ready(yolo.model)
    yolo.fuse()
    float_model = copy.deepcopy(yolo.model)
    reset_counts()
    t0 = time.perf_counter()
    quantize_model(yolo.model, calib)
    torch.cuda.synchronize()
    return yolo, float_model, counts(), time.perf_counter() - t0


def phase_yolo11_int8(dev):
    """int8 PTQ of the fork's YOLO11 graph: yolo11m quantized on the int8
    phase's two seeded batches of 8 (K1 2 launches a calibration batch),
    then YOLO.predict on the slice phase's 8 frames (K4 2 launches, no K1);
    every grouped conv keeps its float path; each SwinBlock's K4 against its
    plain version on the input it receives (INT8_LEVELS, INT8_SHARE) and
    the whole int8 model with K4 against it with the plain version (the
    decoded output within INT8_RTOL; the Swin layers and raw Detect maps
    reported); the int8 forward's ms at batch 32 beside the float
    forward's (the same fp32 weights, bf16 compute), device time by kernel
    of both, and int8 predict img/s at batch 32; the int8 yolo11m exported
    with dynamic=True (the exporter calibrates on the same synthetic
    frames), loaded by Backend and held bit for bit to the live int8 model
    at YOLO11_INT8_PROGRAM_BATCHES, K4 2 launches a call; then one int8
    predict batch of yolo11x (Swin C=768, K4 2 launches) with its layers
    held the same way."""
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO
    from improving_yolov8_cbam_swinblock_tpu_torch.engine.exporter import ExportForward
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import Conv

    rng = np.random.default_rng(SEED)  # the int8 phase's calibration frames, and the exporter's synthetic ones
    calib = [rng.integers(0, 255, (8, 640, 640, 3), dtype=np.uint8) for _ in range(2)]
    frames = slice_frames()
    x = letterboxed(frames, 640, dev, torch.bfloat16)
    yolo, float_model, calib_launches, calib_s = quantized(YOLO11, calib)
    convs = [m for m in yolo.model.modules() if isinstance(m, Conv)]
    grouped = [m for m in convs if m.conv.groups > 1]
    grouped_float = bool(grouped) and all(m.w_int8 is not None and not m.runs_int8 for m in grouped)
    widths = sorted({m.norm1.weight.numel() for m in swin_modules(yolo.model)})
    results, launches = counted(lambda: yolo.predict(frames, imgsz=640, conf=0.001, batch=8, verbose=False))
    layers_ok, layers = int8_swin_layers(yolo.model, x)
    # the whole int8 model with K4 vs with the plain version: the decoded (B, 5, A) that predict reads is held
    # to INT8_RTOL of each channel's largest magnitude; the Swin layers and raw Detect maps are reported, since
    # every int8 conv after a block quantizes its input again, and a block output's move of a level (held
    # above, on the same input) moves such an input across a boundary, which the convs after it carry
    _, k_err, out_shape = compare_forward(yolo.model, x, INT8_MODEL_RTOL)
    k_ok = max(k_err["decoded_channels"]) <= INT8_RTOL
    predict_ok = (launches == INT8_PREDICT_LAUNCHES and calib_launches["swin_block_fwd"] == 2 * len(calib)
                  and calib_launches["swin_block_int8"] == 0 and len(results) == 8
                  and boxes_ok(results, 480, 640) and out_shape == (8, 5, 8400) and grouped_float
                  and widths == [512] and layers_ok and k_ok)

    bs = 32
    xb = torch.rand(bs, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    xb = xb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        int8_ms = cuda_ms(lambda: yolo.model(xb), iters=10)
        float_ms = cuda_ms(lambda: float_model(xb), iters=10)
    by_kernel = {"int8": forward_profile(yolo.model, xb, int8_ms, "swin_block_int8"),
                 "float": forward_profile(float_model, xb, float_ms, "swin_block_fwd")}
    del float_model
    frames32 = [np.random.default_rng(SEED + 1).integers(0, 256, (480, 640, 3), dtype=np.uint8)] * bs
    yolo.predict(frames32, imgsz=640, batch=bs, verbose=False)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        yolo.predict(frames32, imgsz=640, batch=bs, verbose=False)
    predict_img_s = 2 * bs / (time.perf_counter() - t0)

    # the int8 program with a dynamic batch, against the live int8 model
    yq = YOLO(YOLO11, device="cuda", dtype=torch.bfloat16, param_dtype=torch.float32, seed=SEED)
    x8 = served_frames(dev)
    program, program_launches = {}, {k: 0 for k in counts()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_yolo11_int8_") as d:
        t0 = time.perf_counter()
        path = yq.export(format="pt2", imgsz=640, int8=True, dynamic=True, project=d)
        program["export_s"] = time.perf_counter() - t0
        del yq
        t0 = time.perf_counter()
        be = Backend(path)
        program["load_s"] = time.perf_counter() - t0
        program["ops"] = [str(n.target) for n in be._fn.graph.nodes if "yolov8_cbam_swin" in str(n.target)]
        program_ok = program["ops"] == ["yolov8_cbam_swin.swin_block_int8.default"] * 2
        live = ExportForward(yolo.model)
        for b in YOLO11_INT8_PROGRAM_BATCHES:
            xs = repeat_frames(x8, b)
            out, la = counted(lambda: torch.from_numpy(be(xs)))
            with torch.inference_mode():
                ref = live(xs).float().cpu()
            program[b] = {**held(out, ref, 0.0), "launches": la}
            program_ok &= program[b]["bit_for_bit"] and la == INT8_PREDICT_LAUNCHES
            for k, v in la.items():
                program_launches[k] += v
        del be
    del yolo
    torch.cuda.empty_cache()

    # yolo11x: Swin at C=768, K4's wide layout with the residual stream in global memory
    yx, _, x_calib_launches, x_calib_s = quantized(YOLO11X, calib)
    x_widths = sorted({m.norm1.weight.numel() for m in swin_modules(yx.model)})
    x_results, x_launches = counted(lambda: yx.predict(frames, imgsz=640, conf=0.001, batch=8, verbose=False))
    x_layers_ok, x_layers = int8_swin_layers(yx.model, x)
    del yx, _
    torch.cuda.empty_cache()
    x_ok = (x_launches == INT8_PREDICT_LAUNCHES and x_widths == [768] and len(x_results) == 8
            and boxes_ok(x_results, 480, 640) and x_layers_ok and x_calib_launches["swin_block_int8"] == 0)
    return predict_ok and program_ok and x_ok, {
        "model": YOLO11, "swin_widths": widths, "calibration_launches": calib_launches, "calibrate_s": calib_s,
        "int8_convs": sum(m.runs_int8 for m in convs), "grouped_convs_float": len(grouped) if grouped_float else 0,
        "predict_launches": launches, "detections_per_frame": [len(r) for r in results],
        "k4_vs_plain_at_swin_layers": layers, "kernel_vs_plain_rel_err": k_err, "kernel_vs_plain_ok": k_ok,
        "decoded_rtol": INT8_RTOL, "int8_levels": INT8_LEVELS, "int8_share": INT8_SHARE,
        "batch": bs, "int8_forward_ms": int8_ms, "float_fp32_weights_forward_ms": float_ms,
        "int8_forward_img_per_s": bs * 1e3 / int8_ms, "int8_predict_img_per_s_conf0.25": predict_img_s,
        "forward_by_kernel": by_kernel, "dynamic_program": program, "dynamic_program_ok": bool(program_ok),
        "yolo11x": {"model": YOLO11X, "swin_widths": x_widths, "calibration_launches": x_calib_launches,
                    "calibrate_s": x_calib_s, "predict_launches": x_launches,
                    "detections_per_frame": [len(r) for r in x_results], "k4_vs_plain_at_swin_layers": x_layers},
    }, {"yolo11_int8": launches, "yolo11_int8_program": program_launches, "yolo11x_int8": x_launches}


def phase_profile_models(dev):
    """ProfileModels' rows (params, GFLOPs, sigma-clipped ms of a bf16
    forward at batch 1, 640 px, CUDA events) for PROFILE_MODELS; then the
    flagship's trainer with batch=-1 (autobatch: each power of two's train
    micro-step peak against 60 % of the card's memory) and one micro-step
    at the batch it picked, its launches counted and its peak memory read."""
    from improving_yolov8_cbam_swinblock_tpu_torch import DetectionTrainer
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.benchmarks import ProfileModels

    t0 = time.perf_counter()
    rows = ProfileModels(list(PROFILE_MODELS), imgsz=640).profile()
    profile_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = DetectionTrainer(overrides={**TRAIN, "batch": -1}).setup()
    autobatch_s = time.perf_counter() - t0
    b = int(tr.args.batch)
    step, acc = tr._make_train_step(nb=TRAIN_NB)
    batch = train_batches(1, dev, b=b)[0]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        items = step(batch)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:  # the phase fails and says so; later phases still run
        del tr, step, batch
        torch.cuda.empty_cache()
        return False, {"profile_models": rows, "autobatch_batch": b, "step_error": str(e)[:300]}, {}
    step_s = time.perf_counter() - t0
    launches = counts()
    total = torch.cuda.get_device_properties(dev).total_memory
    peak = torch.cuda.max_memory_allocated()
    del tr, step, batch
    torch.cuda.empty_cache()
    ok = (len(rows) == len(PROFILE_MODELS) and all(r["ms_mean"] > 0 and r["GFLOPs"] > 0 for r in rows)
          and b >= 2 and b & (b - 1) == 0 and launches == STEP_LAUNCHES and bool(torch.isfinite(items).all()))
    return ok, {"profile_models": rows, "profile_models_s": profile_s, "autobatch_batch": b,
                "autobatch_s": autobatch_s, "accumulate": acc, "step_launches": launches,
                "step_s_first": step_s, "step_peak_mem_gib": peak / 2**30,
                "step_peak_share_of_card": peak / total, "loss_items": items.tolist()}, \
        {"autobatch_step": launches}


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
        yolo.predict(frames, imgsz=640, conf=conf, batch=bs, verbose=False)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 2
        for _ in range(reps):
            yolo.predict(frames, imgsz=640, conf=conf, batch=bs, verbose=False)
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


def forward_profile(model, x, forward_ms, *kernels, key="swin_share", more=None):
    """Device time by kernel over 3 forwards of model on x (torch.profiler),
    with the share (under `key`) of the kernels whose names hold one of
    `kernels`, and under each key of `more` the share of its names'."""
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
            key: share(*kernels), **{k: share(*names) for k, names in (more or {}).items()},
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
        "swin_bwd_parts_share": {part: share(f"swin_bwd_{part}") for part in ("window", "wgrad", "sum")},
        "tal_share": share("tal_assign_kernel"),
        "top": [{"name": e.key[:90], "us_per_step": e.device_time_total / 4, "calls": e.count / 4} for e in top],
    }
    return True, out


def width_rows(rows):
    """The kernel phase's width cases as the kernels line lists them (ms)."""
    keep = ("shape", "heads", "dtype", "fast", "mode", "wide", "stream_in_global", "max_abs_err", "max_abs_err_dx",
            "max_rel_err", "share_off", "smem_bytes", "scratch_bytes", "tops", "bound_by")
    return [{**{k: r[k] for k in keep if k in r}, "ms": r["kernel_us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
             "bound_ms": r["bound_us"] / 1e3, **({"device_ms": r["device_us"] / 1e3} if "device_us" in r else {})}
            for r in rows]


def kernels_line(yolo, tr, int8_yolo, dev, launches, build, wide, k2_levels):
    """Each kernel at the shapes its path hands it, vs its plain version,
    timed, beside its bound. No single PyTorch call computes any of the
    functions (the whole SwinBlock, its backward, its int8 form, the
    task-aligned assignment), so library_ms is null for each. K1, K3 and K4
    add their achieved TFLOP/s (K4: TOP/s, int8 operations and the
    attention's bf16 FLOP), time over bound, shared memory per block (as
    the built library reports it) and the registers and spills of their
    tensor-core kernels (-Xptxas -v); K3 its workspace's bytes and their
    traffic's time at the HBM peak; K4 its library's IMMA, HMMA and IDP4A
    instruction counts; K1 and K4 their device time alone (device_ms, a
    CUDA graph's replay) and their wrappers' host time per call
    (host_ms_per_call), since ms times back-to-back calls, which the host
    paces once it takes longer than the card. K1, K3 and K4 also list their width cases from the
    kernel phase (`widths`: C 384 to 768), and their launches by path
    include the track phase's paths (track, embed, visualize) and the
    YOLO11 and flagship-l phases, whose Swin blocks are 512 wide. K2 lists
    its rows at the four-level grids of the families phase (`four_levels`)
    and its row at topk=1 (`topk1`, YOLOv10's one-to-one assignment, on the
    same inputs) and at 80 classes (`world_nc80`, the World path's prompts);
    its launches by path include the v10, segment, pose, obb and world phases'."""
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin as S
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin import swin_block, swin_block_bwd
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.swin_int8 import q8, swin_block_int8
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    rng = np.random.default_rng(SEED)
    # K1: predict at 640 px with batch 8 hands it (8, 40, 40, 256) bf16, fast
    swin = swin_modules(yolo.model)[0]
    p = swin.kernel_params()
    x = torch.tensor(rng.normal(0, 1, (8, 40, 40, 256)).astype(np.float32), device=dev).to(torch.bfloat16)
    bound_ms, bound_by = swin_bound(tuple(x.shape), x.dtype)
    ms = cuda_ms(lambda: swin_block(x, p, 2))
    fwd = {"name": "swin_block_fwd", "launches": sum(v["swin_block_fwd"] for v in launches.values()),
           "launches_by_path": {k: v["swin_block_fwd"] for k, v in launches.items()},
           "max_abs_err": (swin_block(x, p, 2).float() - swin_block(x, p, 2, impl="plain").float()).abs().max().item(),
           "ms": ms, "device_ms": graph_ms(lambda: swin_block(x, p, 2)),
           "host_ms_per_call": host_ms(lambda: swin_block(x, p, 2)),
           "plain_ms": cuda_ms(lambda: swin_block(x, p, 2, impl="plain"), iters=5),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "tflops": swin_flops(tuple(x.shape)) / ms / 1e9, "ms_over_bound": ms / bound_ms,
           "smem_bytes": S._lib().swin_block_fwd_smem_bytes(S._DTYPES[x.dtype], 256, 2),
           "ptxas": {k: v for k, v in build["ptxas"]["swin_block_fwd"].items() if "mma" in k or "wide" in k},
           "widths": width_rows(wide["swin_block_fwd"])}
    # K1 at the P4 grids that only test-time augmentation hands it (34x34, padded to 35x35, and 28x28), batch 32
    trng = np.random.default_rng(SEED + 7)
    fwd["tta"] = []
    for shape in TTA_K1_SHAPES:
        xs = torch.tensor(trng.normal(0, 1, shape).astype(np.float32), device=dev).to(torch.bfloat16)
        got, ref = swin_block(xs, p, 2), swin_block(xs, p, 2, impl="plain")
        ms = cuda_ms(lambda: swin_block(xs, p, 2))
        bound_ms, bound_by = swin_bound(shape, xs.dtype)
        fwd["tta"].append({"shape": list(shape), "ms": ms,
                           "plain_ms": cuda_ms(lambda: swin_block(xs, p, 2, impl="plain"), iters=5),
                           "bound_ms": bound_ms, "bound_by": bound_by, "tflops": swin_flops(shape) / ms / 1e9,
                           "ms_over_bound": ms / bound_ms, "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                           "max_rel_err": rel_err(got, ref)})
    # K1 exact and K3: train at 640 px with batch 16 hands them (16, 40, 40, 256) bf16, fp32 masters
    tswin = swin_modules(tr.model)[0]
    tp = {k: v.detach() for k, v in tswin.kernel_params().items()}
    xt = torch.tensor(rng.normal(0, 1, (16, 40, 40, 256)).astype(np.float32), device=dev).to(torch.bfloat16)
    gt = torch.tensor(rng.normal(0, 1, (16, 40, 40, 256)).astype(np.float32), device=dev).to(torch.bfloat16)
    ms = cuda_ms(lambda: swin_block(xt, tp, 2, fast=False))
    bound_ms = swin_bound(tuple(xt.shape), xt.dtype)[0]
    fwd["train_exact"] = {
        "shape": list(xt.shape), "ms": ms,
        "plain_ms": cuda_ms(lambda: swin_block(xt, tp, 2, fast=False, impl="plain"), iters=5),
        "bound_ms": bound_ms, "tflops": swin_flops(tuple(xt.shape)) / ms / 1e9, "ms_over_bound": ms / bound_ms}
    got, ref = swin_block_bwd(xt, gt, tp, 2), swin_block_bwd(xt, gt, tp, 2, impl="plain")
    bound_ms, bound_by = swin_bwd_bound(tuple(xt.shape), xt.dtype)
    ms = cuda_ms(lambda: swin_block_bwd(xt, gt, tp, 2), iters=10)
    ws_bytes = bwd_workspace_bytes(tuple(xt.shape), 2, xt.dtype)
    bwd = {"name": "swin_block_bwd", "launches": sum(v["swin_block_bwd"] for v in launches.values()),
           "launches_by_path": {k: v["swin_block_bwd"] for k, v in launches.items()},
           "max_abs_err": (got[0].float() - ref[0].float()).abs().max().item(),
           "max_rel_err": max(bwd_errors(got, ref).values()),
           "ms": ms, "plain_ms": cuda_ms(lambda: swin_block_bwd(xt, gt, tp, 2, impl="plain"), iters=3),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "tflops": swin_bwd_flops(tuple(xt.shape)) / ms / 1e9, "ms_over_bound": ms / bound_ms,
           # the workspace is written once and read back: its traffic at the HBM peak
           "workspace_bytes": ws_bytes, "workspace_ms_at_peak": 2e3 * ws_bytes / PEAK_BYTES,
           "smem_bytes": S._bwd_lib().swin_block_bwd_smem_bytes(S._DTYPES[xt.dtype], 256, 2),
           "ptxas": {k: v for k, v in build["ptxas"]["swin_block_bwd"].items() if "bf16" in k or "mma" in k},
           "widths": width_rows(wide["swin_block_bwd"])}
    # K2: the train path hands it B=16, A=8400, G=4*max_gt=128 after mosaic, nc=1
    # (ms: events over back-to-back calls, host work included; device_ms: CUDA-graph replay)
    args, grid = tal_inputs(16, 4 * MAX_GT, 1, 640, dev, SEED)
    got = task_aligned_assign(*args, num_classes=1, grid=grid)
    ref = task_aligned_assign(*args, num_classes=1, impl="plain")
    bound_ms, bound_by = tal_bound(args, 1)
    device_ms = graph_ms(lambda: task_aligned_assign(*args, num_classes=1, grid=grid))
    tal = {"name": "tal_assign", "launches": sum(v["tal_assign"] for v in launches.values()),
           "launches_by_path": {k: v["tal_assign"] for k, v in launches.items()},
           "max_abs_err": max((got.target_scores - ref.target_scores).abs().max().item(),
                              (got.target_bboxes - ref.target_bboxes).abs().max().item()),
           "exact_fg_idx_labels": tal_compare(got, ref)["exact_fg_idx_labels"],
           "ms": cuda_ms(lambda: task_aligned_assign(*args, num_classes=1, grid=grid)), "device_ms": device_ms,
           "plain_ms": cuda_ms(lambda: task_aligned_assign(*args, num_classes=1, impl="plain"), iters=5),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "device_ms_over_bound": device_ms / bound_ms, "candidate_pairs": tal_candidate_pairs(args),
           "dense_bound_ms": tal_bound(args, 1, dense=True)[0],
           "ptxas": build["ptxas"]["tal_assign"], "four_levels": list(k2_levels)}
    # K2 at topk=1 on the same inputs: YOLOv10's one-to-one assignment
    got1 = task_aligned_assign(*args, topk=1, num_classes=1, grid=grid)
    device_ms1 = graph_ms(lambda: task_aligned_assign(*args, topk=1, num_classes=1, grid=grid))
    tal["topk1"] = {**tal_compare(got1, task_aligned_assign(*args, topk=1, num_classes=1, impl="plain")),
                    "ms": cuda_ms(lambda: task_aligned_assign(*args, topk=1, num_classes=1, grid=grid)),
                    "device_ms": device_ms1,
                    "plain_ms": cuda_ms(lambda: task_aligned_assign(*args, topk=1, num_classes=1, impl="plain"),
                                        iters=5),
                    "bound_ms": bound_ms, "bound_by": bound_by, "device_ms_over_bound": device_ms1 / bound_ms,
                    "fg_anchors": int(got1.fg_mask.sum())}
    # K2 at the World path's class width: 80 prompts (the COCO names), B=16, A=8400, G=128
    args80, grid80 = tal_inputs(16, 4 * MAX_GT, 80, 640, dev, SEED + 80)
    got80 = task_aligned_assign(*args80, num_classes=80, grid=grid80)
    bound80, by80 = tal_bound(args80, 80)
    device_ms80 = graph_ms(lambda: task_aligned_assign(*args80, num_classes=80, grid=grid80))
    tal["world_nc80"] = {**tal_compare(got80, task_aligned_assign(*args80, num_classes=80, impl="plain")),
                         "ms": cuda_ms(lambda: task_aligned_assign(*args80, num_classes=80, grid=grid80)),
                         "device_ms": device_ms80,
                         "plain_ms": cuda_ms(lambda: task_aligned_assign(*args80, num_classes=80, impl="plain"),
                                             iters=5),
                         "bound_ms": bound80, "bound_by": by80, "device_ms_over_bound": device_ms80 / bound80,
                         "launches": launches.get("world", {}).get("tal_assign", 0)}
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
        ms = cuda_ms(lambda: swin_block_int8(x8, p8, q, 2, in8=True, out8=True, sm16=sm16))
        int8_rows.append({
            "name": name, "launches": launches["int8"][name],
            "launches_by_path": {k: v[name] for k, v in launches.items()},
            "max_abs_err": cmp["max_abs_err"], "share_off": cmp["share_off"],
            "ms": ms, "device_ms": graph_ms(lambda: swin_block_int8(x8, p8, q, 2, in8=True, out8=True, sm16=sm16)),
            "host_ms_per_call": host_ms(lambda: swin_block_int8(x8, p8, q, 2, in8=True, out8=True, sm16=sm16)),
            "plain_ms": cuda_ms(lambda: swin_block_int8(x8, p8, q, 2, in8=True, out8=True, sm16=sm16, impl="plain"),
                                iters=5),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "tops": swin_int8_tops(tuple(x8.shape), ms), "ms_over_bound": ms / bound_ms,
            "smem_bytes": S8._lib().swin_block_int8_smem_bytes(256, 2, 1),
            "ptxas": build["ptxas"]["swin_block_int8"], "sass": build["sass"]["swin_block_int8"],
            **({"widths": width_rows(wide["swin_block_int8"])} if name == "swin_block_int8" else {})})
    rows = [fwd, bwd, tal, *int8_rows]
    for r in rows:
        r.update(route="cuda", source=SOURCES[r["name"]], replaces=REPLACES[r["name"]])
    return rows


def k2_run(root: Path, ablate: bool) -> dict:
    """K2 of the port under `root`, imported from there by this process:
    its device time per call (graph_ms) and its time per call by events
    over back-to-back calls (cuda_ms), the kernels one call launches (from
    torch.profiler), and whether fg, GT index and labels equal the plain
    version's. With `ablate`, also its device time on inputs that take one
    cost away at a time from the same kernel, same launch: scores 0 (align 0
    everywhere: no top-k insertions and no claims but the zero fill's, while
    the scan of the candidate rectangles, its loads and its CIoU stay), and
    every GT masked out (no slots: what is left is the GT table, the grid
    check, the barriers and the stores)."""
    import inspect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(root))
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign

    mod = sys.modules["improving_yolov8_cbam_swinblock_tpu_torch"].__file__
    if not Path(mod).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {mod}, not the port under {root}")
    args, grid = tal_inputs(16, 4 * MAX_GT, 1, 640, torch.device("cuda"), SEED)
    kw = {"grid": grid} if "grid" in inspect.signature(task_aligned_assign).parameters else {}

    def call(a=args):
        return task_aligned_assign(*a, topk=10, num_classes=1, **kw)

    got, ref = call(), task_aligned_assign(*args, topk=10, num_classes=1, impl="plain")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    row = {"root": str(root), "exact_fg_idx_labels": tal_compare(got, ref)["exact_fg_idx_labels"],
           "kernels_of_one_call": {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA},
           "device_us": 1e3 * graph_ms(call), "event_us": 1e3 * cuda_ms(call)}
    if ablate:
        for name, a in (("scores_0", (torch.zeros_like(args[0]), *args[1:])),
                        ("no_gt", (*args[:5], torch.zeros_like(args[5])))):
            row[f"device_us_{name}"] = 1e3 * graph_ms(lambda: call(a))
            row[f"exact_{name}"] = tal_compare(call(a), task_aligned_assign(
                *a, topk=10, num_classes=1, impl="plain"))["exact_fg_idx_labels"]
    return row


def k2_compare(parent: Path) -> int:
    """k2_run for parent, this checkout, this checkout, parent, each in its
    own process; the card's name and power limit first."""
    here = Path(__file__).resolve().parent
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    rc = 0
    for root, ablate in ((parent, False), (here, True), (here, True), (parent, False)):
        code = (f"import sys, json; from pathlib import Path; sys.path.insert(0, {str(here)!r}); import chip_smoke; "
                f"print(json.dumps(chip_smoke.k2_run(Path({str(root)!r}), {ablate})))")
        rc |= subprocess.run([sys.executable, "-c", code], cwd=root, timeout=600).returncode
    return rc


def predict_run(root: Path, disk: bool) -> dict:
    """YOLO.predict of the port under `root`, imported from there by this
    process, at batch 32, 640 px, bf16, BN-folded, seeded weights, on the
    speed phase's frames: the img/s of each of 8 calls after a warm-up (host
    clock, what a caller waits), in memory and, with `disk`, from the frames
    written as PNGs; and the forward's ms (CUDA events)."""
    import inspect
    import statistics

    sys.path.insert(0, str(root))
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    mod = sys.modules["improving_yolov8_cbam_swinblock_tpu_torch"].__file__
    if not Path(mod).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {mod}, not the port under {root}")
    dev, bs = torch.device("cuda"), 32
    yolo = YOLO("yolov8s-cbam-swin.yaml", device="cuda", dtype=torch.bfloat16, seed=SEED).fuse()
    rng = np.random.default_rng(SEED + 1)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(bs)]
    kw = dict(imgsz=640, batch=bs)
    if any(p.kind is p.VAR_KEYWORD for p in inspect.signature(yolo.predict).parameters.values()):
        kw["verbose"] = False  # the serving facade's keys (a checkout that has them prints a line per image)
    out = {"root": str(root)}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_predict_"))
    try:
        sources = [("in_memory", frames)]
        if disk:
            write_pngs(frames, tmp / "png32")
            sources.append(("disk_png", str(tmp / "png32")))
        for label, src in sources:
            yolo.predict(src, **kw)  # warm-up
            torch.cuda.synchronize()
            rates = []
            for _ in range(8):
                t0 = time.perf_counter()
                yolo.predict(src, **kw)
                rates.append(bs / (time.perf_counter() - t0))
            out[f"predict_img_per_s_{label}"] = rates
            out[f"predict_img_per_s_{label}_median"] = statistics.median(rates)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    x = torch.rand(bs, 3, 640, 640, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        out["forward_ms"] = cuda_ms(lambda: yolo.model(x), iters=10)
    return out


def predict_compare(parent: Path) -> int:
    """predict_run for parent, this checkout, this checkout, parent, ... (5
    runs of each), each in its own process; the card's name and power limit first."""
    here = Path(__file__).resolve().parent
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    rc = 0
    for root, disk in [(parent, False), (here, True), (here, True), (parent, False)] * 2 + [(parent, False), (here, True)]:
        code = (f"import sys, json; from pathlib import Path; sys.path.insert(0, {str(here)!r}); import chip_smoke; "
                f"print(json.dumps(chip_smoke.predict_run(Path({str(root)!r}), {disk})))")
        rc |= subprocess.run([sys.executable, "-c", code], cwd=root, timeout=600).returncode
    return rc


def fit_run(root: Path, tensorboard: bool) -> dict:
    """YOLO.train of the port under `root`, imported from there by this
    process, on the fit phase's dataset and settings with the device
    augmentation: one warm-up epoch (the kernels' first use, cuDNN's
    algorithm search), then 4 epochs timed by the trainer's epoch_stats.
    `tensorboard` sets the port's SETTINGS["tensorboard"] where it has
    the setting; the seconds that registering the loggers took in each run."""
    import statistics

    sys.path.insert(0, str(root))
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO

    mod = sys.modules["improving_yolov8_cbam_swinblock_tpu_torch"].__file__
    if not Path(mod).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {mod}, not the port under {root}")
    out = {"root": str(root), "tensorboard": None, "integrations_s": []}
    try:
        from improving_yolov8_cbam_swinblock_tpu_torch.utils import integrations, settings
    except ImportError:  # a port without the logger integrations
        integrations = None
    if integrations is not None:
        settings.SETTINGS["tensorboard"] = out["tensorboard"] = tensorboard
        add = integrations.add_integration_callbacks

        def timed_add(trainer):
            t0 = time.perf_counter()
            got = add(trainer)
            out["integrations_s"].append(time.perf_counter() - t0)  # the warm-up's, then the timed run's
            out["integrations"] = got
            return got

        integrations.add_integration_callbacks = timed_add
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_run_"))
    try:
        data = str(write_fit_dataset(tmp / "data"))
        YOLO("yolov8s-cbam-swin.yaml", device="cuda", seed=SEED).train(
            data=data, project=str(tmp / "runs"), name="warmup", **{**FIT, "epochs": 1, "close_mosaic": 0})
        yolo = YOLO("yolov8s-cbam-swin.yaml", device="cuda", seed=SEED)
        t0 = time.perf_counter()
        yolo.train(data=data, project=str(tmp / "runs"), name="timed", **{**FIT, "epochs": 4, "close_mosaic": 2})
        torch.cuda.synchronize()
        out["train_call_s"] = time.perf_counter() - t0
        bs = FIT["batch"]
        out["epochs"] = [{"epoch": e["epoch"] + 1, "train_img_per_s_with_loader": e["batches"] * bs / e["train_s"],
                          "loader_wait_ms_per_train_batch": 1e3 * e["loader_wait_s"] / e["batches"],
                          "micro_step_ms": 1e3 * (e["train_s"] - e["loader_wait_s"]) / e["batches"],
                          "val_s": e["val_s"]} for e in yolo.trainer.epoch_stats]
        out["median_train_img_per_s"] = statistics.median(e["train_img_per_s_with_loader"] for e in out["epochs"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def fit_compare(parent: Path) -> int:
    """fit_run for parent, this checkout with TensorBoard on, this checkout
    with it off, in five rounds, the order turned each round, each run in
    its own process (the first of each checkout builds its kernels first);
    the card's name and power limit first, the medians of each variant last."""
    import statistics

    here = Path(__file__).resolve().parent
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    variants = [("parent", parent, True), ("tensorboard_on", here, True), ("tensorboard_off", here, False)]
    rows = {name: [] for name, _, _ in variants}
    rc = 0
    for r in range(5):
        for name, root, tb in variants[r % 3:] + variants[:r % 3]:
            code = (f"import sys, json; from pathlib import Path; sys.path.insert(0, {str(here)!r}); import chip_smoke; "
                    f"print('FIT_RUN ' + json.dumps({{'variant': {name!r}, "
                    f"**chip_smoke.fit_run(Path({str(root)!r}), {tb})}}), flush=True)")
            if r == 0:
                code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
                        "from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin, tal; "
                        "[f() for f in (swin._lib, swin._bwd_lib, tal._lib)]; " + code)
            child = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=600, capture_output=True, text=True)
            rc |= child.returncode
            for line in child.stdout.splitlines():
                if line.startswith("FIT_RUN "):
                    print(line[len("FIT_RUN "):], flush=True)
                    rows[name].append(json.loads(line[len("FIT_RUN "):]))
            if child.returncode:
                print(child.stderr[-3000:], file=sys.stderr, flush=True)
    summary = {}
    for name, runs in rows.items():
        eps = [e for run in runs for e in run["epochs"]]
        summary[name] = {"runs": len(runs), "epochs": len(eps),
                         "run_medians": [run["median_train_img_per_s"] for run in runs]} | ({
            k: statistics.median(e[k] for e in eps)
            for k in ("train_img_per_s_with_loader", "loader_wait_ms_per_train_batch", "micro_step_ms", "val_s")}
            if eps else {})
    print(json.dumps({"fit_compare_medians": summary}), flush=True)
    return rc


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--k2":
        return k2_compare(Path(sys.argv[2]).resolve())
    if len(sys.argv) == 3 and sys.argv[1] == "--predict":
        return predict_compare(Path(sys.argv[2]).resolve())
    if len(sys.argv) == 3 and sys.argv[1] == "--fit":
        return fit_compare(Path(sys.argv[2]).resolve())
    if len(sys.argv) == 3 and sys.argv[1] == "--programs":
        return programs_run(Path(sys.argv[2]).resolve())
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
    (wide,) = run("kernel", phase_kernel, dev)
    programs = start_programs()  # beside the phases below (the kernels timed alone before); joined before the end
    try:
        return run_phases(dev, name, smi, build, wide, programs, failed, run)
    finally:
        if programs[0].poll() is None:
            programs[0].kill()
            programs[0].wait()


def run_phases(dev, name, smi, build, wide, programs, failed, run) -> int:
    """The phases after the kernel phase, the kernels line and the last line (main)."""
    yolo, predict_launches = run("slice", phase_slice, dev)
    (serve_launches,) = run("serve", phase_serve, dev)
    (track_launches,) = run("track", phase_track, yolo, dev)
    train, train_launches = run("train", phase_train, dev)
    int8_yolo, int8_launches, int8_ms = run("int8", phase_int8, dev)
    (export_launches,) = run("export", phase_export, dev)
    fit_launches, fit_loader_ms = run("fit", phase_fit, dev)
    (fit_host_launches,) = run("fit_host", phase_fit_host, dev, fit_loader_ms)
    families_launches, k2_levels = run("families", phase_families, dev)
    (v10_launches,) = run("v10", phase_v10, dev)
    (segment_launches,) = run("segment", phase_segment, dev)
    (pose_launches,) = run("pose", phase_pose, dev)
    (obb_launches,) = run("obb", phase_obb, dev)
    (classify_launches,) = run("classify", phase_classify, dev)
    (rtdetr_launches,) = run("rtdetr", phase_rtdetr, dev)
    (world_launches,) = run("world", phase_world, dev)
    (int8_graphs_launches,) = run("int8_graphs", phase_int8_graphs, dev)
    (yolo11_launches,) = run("yolo11", phase_yolo11, dev)
    (large_launches,) = run("flagship_l", phase_flagship_l, dev)
    (yolo11_int8_launches,) = run("yolo11_int8", phase_yolo11_int8, dev)
    (autobatch_launches,) = run("profile_models", phase_profile_models, dev)
    (forward_ms,) = run("speed", phase_speed, yolo, train, dev)
    run("profile", phase_profile, yolo, train, dev, forward_ms, int8_yolo, int8_ms)
    run("programs", phase_programs, *programs, 600.0)
    kernels = kernels_line(yolo, train[0], int8_yolo, dev,
                           {"predict": predict_launches, "serve": serve_launches, **track_launches,
                            "train": train_launches,
                            "int8": int8_launches, "export": export_launches, "fit": fit_launches, **fit_host_launches,
                            **families_launches, **v10_launches, **segment_launches, **pose_launches, **obb_launches,
                            **classify_launches, **rtdetr_launches, **world_launches,
                            **int8_graphs_launches,
                            **yolo11_launches,
                            **large_launches,
                            **yolo11_int8_launches, **autobatch_launches},
                           build, wide, k2_levels)
    print(smi, flush=True)
    emit({"kernels": kernels})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
