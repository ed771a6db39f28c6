"""YOLO facade of the PyTorch port: build, load weights, fuse, predict, train, val, save.

`YOLO("yolov8s-cbam-swin.yaml")` builds the graph with a seeded random init
on the card; `device="cpu"` is the only way to the CPU. Weights come from
a file: the port's own `.pt` (`save`), or a `.ckpt` / `.msgpack` of the JAX
package (its YOLO.save, fused or not, and its trainer's last.ckpt,
best.ckpt, epochN.ckpt), whose EMA weights it serves; `YOLO([a, b])`
serves several checkpoints as one ensemble. `load` overlays weights by
name and shape; `load_jax_variables` takes the JAX package's variables in
memory. For int8 serving, build with fp32 weights
(`param_dtype=torch.float32`), `fuse()`, then quantize the model in place
with `ops.quant.quantize_model(yolo.model, batches)`; `predict` and `val`
then run it. `train(data=...)` trains on the model's device (a model loaded
from a file warm-starts the trainer) and adopts best.pt's EMA weights;
`val(data=...)` returns ValMetrics. A segmentation graph (task "segment")
predicts masks, validates box and mask mAP, trains with the seg loss and
exports (a program with the prototypes beside the prediction) through the
same verbs; a pose graph (task "pose") predicts and tracks keypoints,
validates box and OKS keypoint mAP, trains with the pose loss and exports
(a program whose prediction carries the keypoints); an oriented-box graph
(task "obb") predicts rotated boxes (rotated NMS, `Results.obb`), tracks
their enclosing boxes, validates the probiou box mAP, trains with the OBB
loss and exports (a program whose prediction carries the angle); a
classification graph (task "classify") predicts class probabilities
(`Results.probs`), validates top-1 and top-5 accuracy on an image folder,
trains with the cross-entropy on one, quantizes and exports (a program of
the softmax); an RT-DETR graph (`RTDETR(...)` or `YOLO(...)` of a graph
that ends in RTDETRDecoder) predicts without NMS, validates and trains on
the Hungarian-matched loss, quantizes and exports (a program of the
(B, nq, 4 + nc) queries, served without NMS); a YOLO-World graph
(`YOLOWorld(...)` or `YOLO(...)` of a graph that ends in WorldDetect)
scores against the text features of its prompts, which `set_classes`
sets (utils/text_model.py), and otherwise takes the detect verbs; served
from a `.ckpt` or `.pt` its text features are those of its saved names
(a `.pt` of the port also carries the features themselves, so that
embeddings set by hand survive), and a program of it holds the features
it was exported with. `YOLO("model.pt2")` serves a program that `export` wrote
(nn/autobackend.py ProgramModel): predict and track, with the masks of a
segmentation program, the keypoints of a pose program and the rotated
boxes of an OBB program; the other verbs need the model itself. `track` runs
predict with ByteTrack or BoT-SORT on its events (trackers/), `embed`
returns pooled layer embeddings, and predict's visualize writes feature
maps.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..cfg import get_cfg
from ..data.build import build_dataloader, build_yolo_dataset
from ..data.dataset import check_det_dataset
from ..data.loaders import VID_EXTS
from ..nn.autobackend import ProgramModel
from ..nn.tasks import DetectionModel, EnsembleModel
from ..ops.quant import is_quantized
from ..trackers.track import on_predict_postprocess_end, on_predict_start
from ..utils import serialization
from ..utils.callbacks import EVENTS, NEVER_FIRED, default_callbacks
from ..utils.jax_import import (ema_state, fused_state_from_jax, jax_variables_from_state, overlay_state,
                                read_checkpoint, state_dict_from_jax)
from ..utils.metrics import ValMetrics
from .predictor import DetectionPredictor
from .results import Results
from .trainer import DetectionTrainer, checkpoint_state
from .validator import TASK_VALIDATORS

JAX_SUFFIXES = (".ckpt", ".msgpack")


class YOLO:
    def __init__(self, model="yolov8s-cbam-swin.yaml", device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, param_dtype: Optional[torch.dtype] = None):
        """A YAML name or file, a dict, a `.pt` or `.ckpt`/`.msgpack` file, or
        a list of checkpoints (an ensemble). `dtype` and `param_dtype` set
        the model built for a YAML or a JAX checkpoint (a `.pt` file carries
        its own)."""
        self.task = "detect"
        self.ckpt_path = None
        self.trainer = None
        self.validator = None
        self.predictor: Optional[DetectionPredictor] = None
        self.overrides: Dict[str, Any] = {}
        self.callbacks = default_callbacks()
        self._trackers = None  # YOLO.track's, kept for persist=True
        self._build = {"device": device, "dtype": dtype, "seed": seed, "param_dtype": param_dtype}
        if isinstance(model, (list, tuple)):
            self.model = EnsembleModel([YOLO(m, **self._build).model for m in model])
            self.ckpt_path = str(model[0])
        elif str(model).endswith(".pt"):
            self._load_pt(str(model))
        elif str(model).endswith(JAX_SUFFIXES):
            self._load_ckpt(str(model))
        elif str(model).endswith(".pt2"):
            self.model = ProgramModel(str(model), device=device)
            self.ckpt_path = str(model)
            if self.model.backend.imgsz:
                self.overrides = {"imgsz": int(self.model.backend.imgsz[0])}
        else:
            self.model = DetectionModel(model, **self._build)
        self.task = self.model.task  # "detect", "segment", "pose", "obb" or "classify", from the graph's head

    def _load_pt(self, path: str) -> None:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        dtype = getattr(torch, payload["dtype"])
        param_dtype = getattr(torch, payload["param_dtype"]) if "param_dtype" in payload else None
        self.model = DetectionModel(payload["yaml"], dtype=dtype, device=self._build["device"],
                                    seed=self._build["seed"], param_dtype=param_dtype)
        if payload["fused"]:
            self.model.fuse()
        self.model.load_state_dict(payload["state_dict"], strict=True)
        if "names" in payload:
            self.model.names = dict(payload["names"])
            if self.model.is_world:  # the features saved beside the names, else the names' own
                self.model.set_classes(list(self.model.names.values()), embeddings=payload.get("txt_feats"))
        self.ckpt_path = path

    def _load_ckpt(self, path: str) -> None:
        """The deploy weights of a JAX-format checkpoint, as the JAX package's
        YOLO._load reads them: the graph (model_yaml with nc), the EMA
        weights, a fused collection onto a fused model, names, and args.imgsz."""
        payload = read_checkpoint(path)
        cfg = dict(payload["model_yaml"])
        cfg["nc"] = int(payload["nc"])
        self.model = DetectionModel(cfg, **self._build)
        if payload.get("fused"):
            self.model.fuse()
            state = fused_state_from_jax({"params": payload["ema_params"], "batch_stats": payload.get("ema_stats") or {},
                                          "fused": payload["fused"]})
        else:
            state = ema_state(payload)
        self.model.load_state_dict(state, strict=True)
        names = payload.get("names") or {}
        if names:
            self.model.names = {int(k): str(v) for k, v in names.items()}
            if self.model.is_world:  # the saved names' text features (the JAX package keeps the placeholders)
                self.model.set_classes([self.model.names[i] for i in sorted(self.model.names)])
        self.ckpt_path = path
        self.overrides = {k: v for k, v in (payload.get("args") or {}).items() if k == "imgsz"}

    @property
    def names(self) -> Dict[int, str]:
        return self.model.names

    def set_classes(self, names) -> "YOLO":
        """The open-vocabulary class swap of a World model (the JAX package's
        YOLO.set_classes): the prompts' text features replace the model's,
        and nc and names follow; the weights stay. A program holds the
        features it was exported with and refuses."""
        self._single("setting the classes of", program=True)
        self.model.set_classes(list(names))
        self.predictor = None
        return self

    @property
    def is_fused(self) -> bool:
        return self.model.is_fused

    def fuse(self) -> "YOLO":
        """Fold every Conv's BatchNorm into its kernel."""
        self.model.fuse()
        return self

    def info(self) -> Dict[str, Any]:
        return {"params": sum(p.numel() for p in self.model.parameters()), "strides": tuple(self.model.strides),
                "nc": self.model.nc, "task": self.task, "fused": self.is_fused}

    def _single(self, what: str, program: bool = False) -> None:
        """Refuse `what` on an ensemble, and on a program unless `program`."""
        if isinstance(self.model, EnsembleModel):
            raise NotImplementedError(f"{what} an ensemble is not supported: use one member")
        if isinstance(self.model, ProgramModel) and not program:
            raise NotImplementedError(f"{what} a .pt2 program is not supported: a program predicts and tracks; "
                                      "use the model it was exported from")

    def load_jax_variables(self, variables) -> "YOLO":
        """Load the JAX package's {"params", "batch_stats"} (numpy leaves) into an unfused model."""
        if self.is_fused:
            raise ValueError("load JAX variables before fuse(): the fused model has no BatchNorm to fill")
        self.model.load_state_dict(state_dict_from_jax(variables), strict=True)
        return self

    def load(self, weights) -> "YOLO":
        """Overlay weights onto this graph by name and shape, keeping this
        model's tensor where a name is missing or its shape differs: the EMA
        of a `.ckpt`/`.msgpack`, the state of a `.pt`, or an `.npz` of the
        reference's torch state (tools/export_ref_state.py), whose names are
        the port's. `transfer_stats` counts the leaves matched and skipped."""
        self._single("loading weights into")
        if self.is_fused:
            raise ValueError("load weights before fuse(): the fused model has no BatchNorm to fill")
        w = str(weights)
        if w.endswith(".npz"):
            with np.load(w) as npz:
                src = {k: torch.from_numpy(np.array(npz[k])) for k in npz.files}
        else:
            src = checkpoint_state(w)
        self.transfer_stats = overlay_state(DetectionTrainer._named_state(self.model), src)
        return self

    def reset_weights(self) -> "YOLO":
        """A fresh seeded init of the same graph, dtypes and device."""
        self._single("resetting")
        names = self.model.names
        self.model = DetectionModel(self.model.yaml, **{**self._build, "device": self.model.device})
        self.model.names = names
        self.ckpt_path = None
        return self

    # -- callbacks: the trainer, the validator, the predictor and the exporter fire the JAX package's events
    def add_callback(self, event: str, func) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown callback event {event!r} (see utils.callbacks.EVENTS)")
        if event in NEVER_FIRED:
            raise NotImplementedError(f"callback event {event!r} is never fired, by the port or the JAX package "
                                      f"(never fired: {NEVER_FIRED})")
        self.callbacks[event].append(func)

    def clear_callback(self, event: str) -> None:
        self.callbacks[event] = []

    def reset_callbacks(self) -> None:
        self.callbacks = default_callbacks()

    def predict(self, source=None, stream: bool = False, **kwargs):
        """Detections for `source` (frames, PIL images, tensors, image or video
        paths, directories, globs, lists of these; None: the two sample
        images), with the predict settings of cfg/default.yaml in kwargs.
        BN-folds a float model first (a quantized one keeps its BatchNorms
        after the int8 convs). stream=True returns a generator of Results
        (videos, webcams and stream URLs frame by frame). save, save_txt
        and save_crop write under <project>/<name> (runs/detect/predict),
        and so does visualize (feature maps, predictor.save_feature_maps).
        embed=[layers] returns what `embed` returns in place of Results."""
        return self._predict(source, stream, self.callbacks, kwargs)

    def _predict(self, source, stream: bool, callbacks, kwargs):
        if source is None:
            from .. import ASSETS

            source = str(ASSETS)
            print(f"WARNING: 'source' is missing. Using default 'source={source}'.")
        args = get_cfg({**self.overrides, **kwargs})
        if isinstance(self.model, EnsembleModel):
            for key, what in (("augment", "test-time augmentation"), ("visualize", "feature maps"),
                              ("embed", "embeddings")):
                if getattr(args, key):
                    raise NotImplementedError(f"{key} on an ensemble: {what} of one model; use one member")
        stride = max(self.model.strides, default=1)  # a classify model's imgsz is not rounded
        args.imgsz = math.ceil(int(args.imgsz) / stride) * stride
        if not self.is_fused and not is_quantized(self.model):
            self.fuse()
        self.predictor = DetectionPredictor(self.model, args, callbacks=callbacks)
        if args.embed:
            layers = args.embed if isinstance(args.embed, (list, tuple)) else [args.embed]
            return self.predictor.embed(source, layers, args.imgsz)
        if stream:
            return self.predictor.stream(source, imgsz=args.imgsz)
        results = self.predictor(source, imgsz=args.imgsz)
        if kwargs.get("save") or kwargs.get("save_txt") or kwargs.get("save_crop"):
            self._save_results(results, args, kwargs)
        if args.show:
            self._show_results(results)
        return results

    def embed(self, source, layers=None, imgsz: int = 640) -> np.ndarray:
        """Pooled embeddings (B, sum of C) float32 of `source`'s frames, all in
        one batch, preprocessed as predict preprocesses them: each of `layers`
        mean-pooled over H and W (DetectionModel.embed). layers=None takes the
        layer before Detect; an index that names Detect raises ValueError."""
        self._single("embedding")
        layers = [len(self.model.model) - 2] if layers is None else list(layers)
        return self.predict(source, embed=layers, imgsz=imgsz)

    def track(self, source=None, tracker: Optional[str] = None, persist: bool = False, stream: bool = False,
              **kwargs):
        """predict with the frames associated across time by a tracker
        (trackers/): each Results gets 7-column boxes [x1, y1, x2, y2, id,
        conf, cls] and `track_ids`. The tracker YAML is `tracker`, else the
        overrides', else cfg/default.yaml's (botsort.yaml). The sources are
        predict's; all but streams feed one tracker frame by frame in order,
        a stream one per stream; stream=True yields as predict does. A new
        call builds new trackers, which restart the ids at 1 (the id counter
        is shared and reset by every new tracker, as in the JAX package);
        persist=True keeps this YOLO's trackers from the last call, so
        their ids go on."""
        self._single("tracking", program=True)
        tracker = tracker or get_cfg(self.overrides).tracker
        if not persist:
            self._trackers = None

        def start(p):
            if self._trackers:  # kept only with persist
                p.trackers = self._trackers
            else:
                on_predict_start(p)
                self._trackers = p.trackers

        callbacks = {event: list(fns) for event, fns in self.callbacks.items()}
        callbacks["on_predict_start"].append(start)
        callbacks["on_predict_postprocess_end"].append(lambda p: on_predict_postprocess_end(p, persist))
        return self._predict(source, stream, callbacks, {**kwargs, "tracker": tracker})

    def __call__(self, source=None, stream: bool = False, **kwargs):
        return self.predict(source, stream=stream, **kwargs)

    @staticmethod
    def _save_results(results: List[Results], args, kwargs) -> None:
        """Under <project>/<name>: annotated images (save); the frames of a
        video (paths `video.ext#i`) muxed into <stem>.mp4 (mp4v, 30 fps), and
        with save_frames also each frame as <stem>_frames/<stem>_<i>.jpg;
        labels/<stem>.txt (save_txt, save_conf); crops/<class>/<stem>_<i>.jpg (save_crop)."""
        import cv2

        out = Path(args.project or "runs/detect") / (args.name or "predict")
        out.mkdir(parents=True, exist_ok=True)
        writers: Dict[str, Any] = {}
        try:
            for i, r in enumerate(results):
                pstr = str(r.path)
                vid = pstr.split("#")[0] if "#" in pstr else None
                is_frame = vid is not None and Path(vid).suffix.lower() in VID_EXTS
                stem = Path(pstr).stem or f"img{i}"
                if kwargs.get("save"):
                    if is_frame:
                        w = writers.get(vid)
                        if w is None:
                            h0, w0 = r.orig_img.shape[:2]
                            w = cv2.VideoWriter(str(out / f"{Path(vid).stem}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                                                30, (w0, h0))
                            writers[vid] = w
                        w.write(r.plot())
                        if args.save_frames:
                            fd = out / f"{Path(vid).stem}_frames"
                            fd.mkdir(exist_ok=True)
                            r.save(str(fd / f"{Path(vid).stem}_{pstr.split('#', 1)[1]}.jpg"))
                    else:
                        r.save(str(out / f"{stem}.jpg"))
                if kwargs.get("save_txt"):
                    r.save_txt(str(out / "labels" / f"{stem}.txt"), save_conf=bool(kwargs.get("save_conf")))
                if kwargs.get("save_crop"):
                    r.save_crop(str(out / "crops"), file_name=stem)
        finally:
            for w in writers.values():
                w.release()

    @staticmethod
    def _show_results(results: List[Results]) -> None:
        """show=True: the annotated frames where a display is available; headless, a warning."""
        if not os.environ.get("DISPLAY") and os.name != "nt":
            print("WARNING: show=True requires a GUI environment; skipping display")
            return
        import cv2

        for r in results:
            cv2.imshow("improving_yolov8_cbam_swinblock_tpu_torch", r.plot())
            cv2.waitKey(1)

    def train(self, data: str, **kwargs) -> Dict[str, float]:
        """Train on `data` (a data YAML or dict) with the trainer's settings in
        kwargs, on this model's device unless `device` is given. A model
        loaded from a file hands its weights to the trainer's warm start
        (same-shape overlay). Afterwards this YOLO holds best.pt's EMA
        weights, or the final EMA when no best.pt was written."""
        self._single("training")
        if self.is_fused:
            raise ValueError("a BN-folded model cannot warm-start training: train from the unfused checkpoint")
        overrides = {**self.overrides, **kwargs, "data": data, "model": self.model.yaml}
        trainer = DetectionTrainer(overrides=overrides, device=kwargs.get("device") or self.model.device)
        if self.ckpt_path is not None:
            trainer.pretrained_state = self.model.state_dict()
        self.trainer = trainer
        for event, fns in self.callbacks.items():  # the user's hooks ride the trainer's bus
            trainer.callbacks[event].extend(fns)
        metrics = trainer.train()
        best = trainer.wdir / "best.pt"
        if best.exists():
            self.model = YOLO(str(best), device=trainer.device).model
        else:
            self.model = trainer.eval_model()
        return metrics

    def val(self, data: Optional[str] = None, **kwargs) -> ValMetrics:
        """Detection metrics of this model (float or quantized, as it is) on
        the `split` (default val) of `data`, with `batch`, `imgsz`, `rect`,
        `max_det`, `workers`, `verbose`, `plots` and `save_json` from kwargs;
        fires the val batch events of this YOLO's callbacks. A segmentation
        model (task "segment") returns its box and mask metrics ("(B)" and
        "(M)" keys, `.box` and `.seg`; fitness the sum of both; `mAP50-95`
        the mask's), and a pose model (task "pose") its box and OKS keypoint
        metrics ("(B)" and "(P)" keys, `.box` and `.pose`; `mAP50-95` the
        keypoints'), each key also as metrics/<key>, without rect, plots or
        JSON; an oriented-box model (task "obb") its probiou box metrics (the
        plain keys and their metrics/...(B) aliases, `.box`), without rect,
        plots or JSON; a classify model its top1, top5 and fitness
        ((top1 + top5) / 2) on the image folder `data` (its `split`
        subfolder, default val), each also under the reference's
        metrics/accuracy_top1 and metrics/accuracy_top5 (the JAX package's
        YOLO.val reads the folder as a data YAML and fails)."""
        self._single("validating")
        args = get_cfg({**self.overrides, **kwargs})
        if self.task == "classify":
            from ..data.classify import ClassificationDataset, ClassificationLoader

            root = Path(data or args.data)
            folder = root / args.split if (root / args.split).is_dir() else root / "val"
            loader = ClassificationLoader(ClassificationDataset(folder, imgsz=int(args.imgsz)), int(args.batch),
                                          train=False, workers=args.workers)
            self.validator = TASK_VALIDATORS["classify"](self.model, loader, args, callbacks=self.callbacks)
            out = ValMetrics(self.validator())
            out["metrics/accuracy_top1"], out["metrics/accuracy_top5"] = out["top1"], out["top5"]
            return out
        stride = max(self.model.strides)
        args.imgsz = math.ceil(int(args.imgsz) / stride) * stride
        info = check_det_dataset(data or args.data)
        split = args.split if info.get(args.split) else "val"
        ds = build_yolo_dataset(args, info[split], info, mode="val", kpt_shape=getattr(self.model, "kpt_shape", None))
        rect_shape = ds.rect_shape(stride=int(stride)) if args.rect and self.task == "detect" else None
        loader = build_dataloader(ds, int(args.batch), workers=args.workers, train=False, rect_shape=rect_shape,
                                  task=self.task)
        self.validator = TASK_VALIDATORS[self.task](self.model, loader, args, callbacks=self.callbacks)
        out = ValMetrics(self.validator())
        if self.task in ("segment", "pose"):  # the box and mask (or keypoint) keys, each also as metrics/<key>
            for k in [k for k in out if k.endswith(("(B)", "(M)", "(P)"))]:
                out[f"metrics/{k}"] = out[k]
            out.box = self.validator.box_m.box
            if self.task == "segment":
                out.seg = self.validator.mask_m.box
            else:
                out.pose = self.validator.pose_m.box
            return out
        for k in ("precision", "recall", "mAP50", "mAP50-95"):
            out[f"metrics/{k}(B)"] = out[k]
        out.box = self.validator.metrics.box
        return out

    def export(self, **kwargs) -> str:
        """Write this model as a torch.export program (format="pt2") with the
        export settings of cfg/default.yaml in kwargs (batch, dynamic, half,
        int8, nms, imgsz, project, data, max_det); returns its path
        (engine/exporter.py). The model itself is not altered."""
        from .exporter import Exporter

        self._single("exporting")
        return Exporter(self.model, get_cfg({**self.overrides, **kwargs}), callbacks=self.callbacks)()

    def benchmark(self, **kwargs):
        """The format sweep of utils/benchmarks.py: one row of latency (and
        mAP with data=) for the live model and for its pt2 program."""
        from ..utils.benchmarks import benchmark

        return benchmark(self, **kwargs)

    def save(self, path: str = "model.pt") -> str:
        """Write this model. A `.ckpt` or `.msgpack` path gets the JAX
        package's format (what its YOLO.save writes: model_yaml, nc, names,
        ema_params, ema_stats, the fused collection of a fused model, args),
        which the JAX package and this port load. Any other path gets the
        port's `.pt`: the graph, the compute dtype, the dtype of the Conv
        and Swin weight matrices (param_dtype, so fp32 masters reload as
        fp32) and the state. A quantized model is refused: save the float
        model and quantize after loading."""
        self._single("saving")
        if is_quantized(self.model):
            raise ValueError("YOLO.save does not write a quantized model: save the float model, then run "
                             "quantize_model after loading it")
        m = self.model
        if str(path).endswith(JAX_SUFFIXES):
            variables = jax_variables_from_state(m)
            payload = {"model_yaml": m.yaml, "nc": m.nc, "names": {str(k): str(v) for k, v in m.names.items()},
                       "ema_params": variables["params"], "ema_stats": variables["batch_stats"],
                       "fused": variables.get("fused", {}), "args": {}}
            Path(path).write_bytes(serialization.dumps(payload))
            return str(path)
        world = {"names": dict(m.names), "txt_feats": m.txt_feats.cpu()} if m.is_world else {}
        torch.save({"yaml": m.yaml, "fused": self.is_fused, "dtype": str(m.dtype).removeprefix("torch."),
                    "param_dtype": str(m.param_dtype).removeprefix("torch."), "state_dict": m.state_dict(), **world},
                   Path(path))
        return str(path)


class RTDETR(YOLO):
    """The RT-DETR facade: the YOLO verbs on a graph that ends in RTDETRDecoder
    (`rtdetr-l.yaml` by default): NMS-free predict and val, training on the
    Hungarian-matched DETR loss. Any other graph raises ValueError, as the
    JAX package's RTDETR does."""

    def __init__(self, model="rtdetr-l.yaml", device=None, dtype: torch.dtype = torch.float32, seed: int = 0,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(model, device=device, dtype=dtype, seed=seed, param_dtype=param_dtype)
        if not self.model.is_rtdetr:
            raise ValueError("RTDETR only supports RTDETRDecoder-headed graphs (rtdetr-*.yaml)")


class YOLOWorld(YOLO):
    """The open-vocabulary YOLO-World facade (`yolov8s-worldv2.yaml` by
    default): the YOLO verbs on a graph that ends in WorldDetect, whose
    classes are set by text prompts (`set_classes`). Any other graph raises
    ValueError, as the JAX package's YOLOWorld does."""

    def __init__(self, model="yolov8s-worldv2.yaml", device=None, dtype: torch.dtype = torch.float32, seed: int = 0,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(model, device=device, dtype=dtype, seed=seed, param_dtype=param_dtype)
        if not getattr(self.model, "is_world", False):
            raise ValueError("YOLOWorld only supports WorldDetect-headed graphs (yolov8*-world*.yaml)")
