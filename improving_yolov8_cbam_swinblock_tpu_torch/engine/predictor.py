"""Detection predictor: sources -> letterbox on the device -> batched forward + NMS -> rescale.

Counterpart of the JAX package's engine/predictor.py. Sources: an (H, W, 3)
BGR uint8 array or a (B, H, W, 3) stack, a PIL image, an object with
__array__ (a torch tensor), the path of an image or a video, a directory
(its images), a glob, and lists of any of these (`_load_sources`); and,
through `stream`, webcams, URLs and files frame by frame. Frames go
through the model `batch` at a time; a short last batch is padded with
zero frames to the same shape. Options, from the configuration:
`conf`, `iou`, `max_det`, `agnostic_nms`, `augment` (the model's
predict_augment: three scales, one flipped), `vid_stride`,
`stream_buffer`, `verbose` (one line per image), `visualize` (a
per-channel grid of every rank-4 layer output per image, written as PNGs).
A YOLOv10 model (`end2end`) gives its head's top-k detections with the rows
at or below `conf` zeroed, as the JAX predictor does: no NMS, and
`augment`, `iou`, `max_det` and `agnostic_nms` do not apply. A segmentation
model's NMS carries each kept anchor's mask coefficients, and each image's
masks (`Results.masks`, (n, H0, W0) bool) are made on the model's device
(`native_masks`); `retina_masks` crops them by the boxes at the original
resolution instead of at the prototypes'; `augment` does not apply, as in
the JAX predictor. A pose model's NMS carries each kept anchor's nk * nd
decoded keypoint columns, which are scaled back through the letterbox
(ops/boxes.py scale_coords with the letterbox's own gain and integer pad,
clipped to the image, as the JAX predictor does) on the model's device,
then copied to the host once a batch (`Results.keypoints`, (n, nk, nd));
`augment` does not apply to a pose model either (the JAX predictor runs
TTA for detect models only). A `.pt2` program (YOLO("model.pt2"),
nn/autobackend.py ProgramModel) gives the same outputs: a segmentation
program's prototypes are its second output, a pose program's keypoints sit
in its prediction.
The predict events of utils/callbacks.py fire around each batch, in
`__call__` and in `stream`; the trackers of YOLO.track ride on them. `embed`
returns pooled layer embeddings of the same preprocessed frames.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.augment import letterbox, letterbox_geometry
from ..data.build import SourceTypes, check_source, load_inference_source
from ..data.loaders import IMG_EXTS, LoadImagesAndVideos
from ..ops.boxes import process_mask, scale_boxes, scale_coords
from ..ops.nms import non_max_suppression
from ..ops.segments import resize_bilinear
from ..utils.callbacks import default_callbacks, run_callbacks
from .results import Results


def native_masks(proto: torch.Tensor, det: torch.Tensor, imgsz: int, pad: Tuple[int, int], orig_shape,
                 boxes0: torch.Tensor, retina: bool = False) -> torch.Tensor:
    """One image's (n, H0, W0) bool masks, on proto's device, as the JAX
    predictor makes them on the host with cv2: proto (nm, h, w); det (n,
    6 + nm) kept NMS rows in letterboxed pixels (the coefficients after the
    class); pad the letterbox's (padw, padh); boxes0 (n, 4) the rows' boxes
    in original pixels. The soft masks (process_mask's, cropped by the
    boxes at the prototypes' resolution; with `retina`, the uncropped
    sigmoids) are resized to imgsz x imgsz, the pad is cut (JAX's rows
    padh to imgsz - padh, where there is a pad), they are resized to the
    original (h, w) and thresholded at 0.5; with `retina` each is then
    cropped by its box at the original resolution (columns int(x1) to
    ceil(x2), rows likewise). Both resizes are bilinear with half-pixel
    centres (segments.resize_bilinear)."""
    padw, padh = pad
    coeffs = det[:, 6:]
    if retina:
        nm, h, w = proto.shape
        soft = torch.sigmoid(coeffs.float() @ proto.float().reshape(nm, -1)).reshape(-1, h, w)
    else:
        soft = process_mask(proto, coeffs, det[:, :4], (imgsz, imgsz))
    up = resize_bilinear(soft, (imgsz, imgsz))
    y0, x0 = int(round(padh)), int(round(padw))
    y1 = imgsz - y0 if padh > 0 else imgsz
    x1 = imgsz - x0 if padw > 0 else imgsz
    masks = resize_bilinear(up[:, y0:y1, x0:x1], orig_shape[:2]) > 0.5
    if retina:
        b = boxes0.to(masks.device)
        h0, w0 = orig_shape[:2]
        rows = torch.arange(h0, device=masks.device)[None, :, None]
        cols = torch.arange(w0, device=masks.device)[None, None, :]
        bx1, by1 = b[:, 0].floor().clamp(min=0), b[:, 1].floor().clamp(min=0)  # int() of a box clipped at 0
        bx2, by2 = b[:, 2].ceil(), b[:, 3].ceil()
        masks &= ((cols >= bx1[:, None, None]) & (cols < bx2[:, None, None]) & (rows >= by1[:, None, None])
                  & (rows < by2[:, None, None]))
    return masks


class DetectionPredictor:
    def __init__(self, model, args, callbacks=None):
        self.model = model
        self.args = args
        self.callbacks = callbacks if callbacks is not None else default_callbacks()
        self.results: List[Results] = []
        self._seen = 0
        self.source_type = SourceTypes()  # what stream() serves; __call__'s sources are never streams
        self.bs = 1  # frames a batch of a stream source: one per stream

    def _load_sources(self, source) -> List[Tuple[np.ndarray, str]]:
        """(BGR frame, path) of each image of `source`; a video yields every
        vid_stride-th frame, tagged `path#i`."""
        if isinstance(source, (list, tuple)):
            return [s for item in source for s in self._load_sources(item)]
        if hasattr(source, "convert") and hasattr(source, "size"):  # PIL
            return [(np.asarray(source.convert("RGB"))[..., ::-1].copy(), "pil")]
        if isinstance(source, torch.Tensor):
            source = source.detach().cpu().numpy()
        elif hasattr(source, "__array__") and not isinstance(source, np.ndarray):
            source = np.asarray(source)
        if isinstance(source, np.ndarray):
            if source.ndim == 4:
                return [(source[i], f"array[{i}]") for i in range(source.shape[0])]
            return [(source, "array")]
        if not isinstance(source, (str, Path)):
            raise TypeError(f"unsupported predict source type: {type(source).__name__}")
        # a directory or a glob gives its images only, as in the JAX predictor; a video every vid_stride-th frame
        return list(LoadImagesAndVideos(source, vid_stride=int(self.args.vid_stride or 1), exts=IMG_EXTS))

    def preprocess(self, frames: Sequence[Tuple[np.ndarray, str]], imgsz: int, bs: int = 0) -> torch.Tensor:
        """The frames letterboxed on the model's device, BGR -> RGB, in [0, 1]
        in the model's dtype: (max(n, bs), 3, imgsz, imgsz), an NCHW view of
        NHWC memory (channels_last), padded with zero frames to bs."""
        batch = torch.stack([letterbox(img0, imgsz, device=self.model.device)[0].flip(-1) for img0, _ in frames])
        if len(frames) < bs:
            batch = torch.cat([batch, batch.new_zeros((bs - len(frames), *batch.shape[1:]))])
        return batch.permute(0, 3, 1, 2).to(self.model.dtype) / 255.0

    @torch.inference_mode()
    def run_batch(self, frames: Sequence[Tuple[np.ndarray, str]], imgsz: int, bs: int) -> List[Results]:
        t0 = time.perf_counter()
        a = self.args
        x = self.preprocess(frames, imgsz, bs)
        n = len(frames)
        t1 = time.perf_counter()
        conf = 0.25 if a.conf is None else float(a.conf)
        segment = self.model.task == "segment"
        proto = None
        if self.model.end2end:  # YOLOv10: the head's top-k detections, gated by conf; no TTA, no NMS
            dets = self.model(x)[0]
            dets = dets * (dets[..., 4:5] > conf)
        else:
            if segment:  # (B, 4 + nc + nm, A) and the prototypes; no TTA
                pred, (_, _, proto) = self.model(x)
            else:  # a pose model's keypoints ride in pred; TTA for detect models only
                pred = self.model.predict_augment(x) if a.augment and self.model.task == "detect" else self.model(x)[0]
            dets = non_max_suppression(pred, conf_thres=conf, iou_thres=float(a.iou), max_det=int(a.max_det),
                                       nc=self.model.nc, agnostic=bool(a.agnostic_nms))
        dets_dev = dets[:n]
        kpts = self.keypoints(dets_dev, frames, imgsz) if self.model.task == "pose" else None
        dets = dets_dev[..., :6].cpu().numpy()
        t2 = time.perf_counter()
        if a.visualize:
            self.save_feature_maps(x[:n], [path for _, path in frames])
        out = []
        for i, (det, (img0, path)) in enumerate(zip(dets, frames)):
            keep = det[:, 4] > 0
            det = det[keep].copy()
            if len(det):
                det[:, :4] = scale_boxes((imgsz, imgsz), torch.from_numpy(det[:, :4]), img0.shape[:2]).numpy()
            res = Results(img0, path, self.model.names, det)
            if kpts is not None and len(det):  # no detections: keypoints None, as in the JAX predictor
                res.update(keypoints=kpts[i])
            if segment and len(det):
                _, _, (padw, _, padh, _) = letterbox_geometry(img0.shape[:2], imgsz)
                rows = dets_dev[i][torch.from_numpy(keep).to(dets_dev.device)]
                res.update(masks=native_masks(proto[i], rows, imgsz, (padw, padh), img0.shape[:2],
                                              torch.from_numpy(det[:, :4]), bool(a.retina_masks)).cpu().numpy())
            res.speed = {"preprocess": (t1 - t0) * 1000 / n, "inference": (t2 - t1) * 1000 / n,
                         "postprocess": 0.0}
            out.append(res)
        self._log_results(out)
        return out

    def keypoints(self, dets: torch.Tensor, frames, imgsz: int) -> List[np.ndarray]:
        """Each image's (n, nk, nd) keypoints of its n kept NMS rows (the
        columns after the class, in letterboxed pixels) in original pixels:
        scale_coords with the letterbox's gain and (padw, padh), clipped to
        the image, on the rows' device; one copy to the host for the batch."""
        nk, nd = self.model.kpt_shape
        kept = []
        for det, (img0, _) in zip(dets, frames):
            r, _, (padw, _, padh, _) = letterbox_geometry(img0.shape[:2], imgsz)
            k = det[det[:, 4] > 0, 6:6 + nk * nd].reshape(-1, nk, nd)
            kept.append(scale_coords((imgsz, imgsz), k, img0.shape[:2], ratio_pad=((r, r), (padw, padh))))
        host = torch.cat(kept).cpu().numpy()
        return np.split(host, np.cumsum([len(k) for k in kept])[:-1])

    def save_feature_maps(self, x: torch.Tensor, paths: Sequence[str]) -> None:
        """visualize: for each image, a grid of every rank-4 layer output of
        the model on x as <project>/<name>/<stem>/stage{i}_{module}_features.png,
        the JAX package's names (project runs/detect, name predict by default)."""
        from ..utils.plotting import feature_visualization

        feats = self.model.features(x)
        root = Path(self.args.project or "runs/detect") / (self.args.name or "predict")
        for bi, p in enumerate(paths):
            d = root / (Path(str(p)).stem or f"img{bi}")
            d.mkdir(parents=True, exist_ok=True)
            for i, name, f in feats:
                feature_visualization(f[bi:bi + 1], f"stage{i}_{name}", save_dir=str(d))

    @torch.inference_mode()
    def embed(self, source, layers: Sequence[int], imgsz: int) -> np.ndarray:
        """(B, sum of C) float32: each listed layer's output mean-pooled over H
        and W (DetectionModel.embed), on all frames of source in one batch,
        preprocessed as predict preprocesses them."""
        x = self.preprocess(self._load_sources(source), imgsz)
        return self.model.embed(x, layers).float().cpu().numpy()

    def _log_results(self, results: Sequence[Results]) -> None:
        """With verbose, one line per image: 'image i path: HxW 2 persons, 12.3ms'."""
        if not self.args.verbose:
            return
        for res in results:
            self._seen += 1
            h, w = res.orig_img.shape[:2]
            print(f"image {self._seen} {res.path}: {h}x{w} {res.verbose()}{res.speed['inference']:.1f}ms")

    def __call__(self, source, imgsz: Optional[int] = None) -> List[Results]:
        imgsz = int(imgsz or self.args.imgsz)
        run_callbacks(self.callbacks, "on_predict_start", self)
        sources = self._load_sources(source)
        bs = max(1, min(len(sources), int(self.args.batch or 1)))
        results: List[Results] = []
        for lo in range(0, len(sources), bs):
            run_callbacks(self.callbacks, "on_predict_batch_start", self)
            self.results = self.run_batch(sources[lo:lo + bs], imgsz, bs)  # the current batch while its hooks fire
            run_callbacks(self.callbacks, "on_predict_postprocess_end", self)
            results.extend(self.results)
            run_callbacks(self.callbacks, "on_predict_batch_end", self)
        self.results = results
        run_callbacks(self.callbacks, "on_predict_end", self)
        return results

    def stream(self, source, imgsz: Optional[int] = None):
        """Results one batch at a time from a lazy source: a webcam index or
        stream URL (one frame per stream a batch), or an image, video or
        directory read frame by frame. The predict events fire as in
        __call__, self.results holding the current batch (at
        on_predict_end, the last)."""
        imgsz = int(imgsz or self.args.imgsz)
        _, self.source_type = check_source(source)
        loader = load_inference_source(source, vid_stride=int(self.args.vid_stride or 1),
                                       stream_buffer=bool(self.args.stream_buffer))
        self.bs = len(loader.sources) if self.source_type.stream else 1
        run_callbacks(self.callbacks, "on_predict_start", self)
        if self.source_type.stream:
            batches = (list(zip(frames, paths)) for frames, paths in loader)
        else:
            batches = ([item] for item in loader)
        try:
            for frames in batches:
                run_callbacks(self.callbacks, "on_predict_batch_start", self)
                self.results = self.run_batch(frames, imgsz, len(frames))
                run_callbacks(self.callbacks, "on_predict_postprocess_end", self)
                yield from self.results
                run_callbacks(self.callbacks, "on_predict_batch_end", self)
        finally:
            if self.source_type.stream:
                loader.close()
        run_callbacks(self.callbacks, "on_predict_end", self)
