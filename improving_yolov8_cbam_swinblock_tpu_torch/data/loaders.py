"""Inference sources of the predict path: the port's copy of the JAX package's data/loaders.py.

LoadImagesAndVideos: a lazy iterator over image and video files (a
directory, a glob, or one file): an image yields once, a video frame by frame
(every `vid_stride`-th frame), so `predict(stream=True)` never holds a
video in memory. LoadStreams: one reader thread per webcam index or
rtsp / rtmp / http / tcp URL, keeping the newest frame (or a FIFO of 30
with `buffer=True`). LoadPilAndNumpy, LoadTensor and autocast_list:
in-memory images, the JAX module's API; nothing in the port calls them
(predict reads in-memory sources in engine/predictor.py's _load_sources,
whose tags and pixel values are the JAX predictor's, not these loaders').
Images are read with the port's `utils.patches.imread` (cv2, else PIL, else
its own PNG decoder); videos and streams need cv2, as in the JAX package.
Screen capture needs the `mss` package, which the port does not use: it
raises.
"""

from __future__ import annotations

import glob
import threading
import time
from pathlib import Path
from typing import List

import numpy as np

from ..utils.patches import imread

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
VID_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v"}


def is_stream_source(source) -> bool:
    if isinstance(source, int):
        return True
    s = str(source)
    return s.isnumeric() or s.lower().startswith(("rtsp://", "rtmp://", "http://", "https://", "tcp://"))


def read_image(path) -> np.ndarray:
    """BGR uint8 of an image file; a missing or undecodable file raises."""
    img = imread(str(path))
    if img is None:
        raise FileNotFoundError(f"cannot read image source: {path}")
    return img


class LoadStreams:
    """Threaded multi-stream reader. Each source gets a daemon thread that
    keeps only the newest frame (buffer=False) or a FIFO of at most 30
    (buffer=True). Iteration yields (frames, paths) with one frame per
    source, until a stream ends."""

    def __init__(self, sources, vid_stride: int = 1, buffer: bool = False):
        import cv2

        self.sources = sources if isinstance(sources, (list, tuple)) else [sources]
        self.vid_stride = vid_stride
        self.buffer = buffer
        self.caps, self.frames, self.threads, self.running = [], [], [], True
        self._lock = threading.Lock()
        for i, s in enumerate(self.sources):
            src = int(s) if str(s).isnumeric() else str(s)
            cap = cv2.VideoCapture(src)
            if not cap.isOpened():
                raise ConnectionError(f"failed to open stream {s!r}")
            ok, frame = cap.read()
            if not ok:
                raise ConnectionError(f"failed to read from stream {s!r}")
            self.caps.append(cap)
            self.frames.append([frame])
            t = threading.Thread(target=self._reader, args=(i,), daemon=True)
            self.threads.append(t)
            t.start()

    def _reader(self, i: int):
        n = 0
        cap = self.caps[i]
        while self.running and cap.isOpened():
            n += 1
            cap.grab()
            if n % self.vid_stride == 0:
                ok, frame = cap.retrieve()
                if not ok:
                    break
                with self._lock:
                    if self.buffer:
                        self.frames[i].append(frame)
                        del self.frames[i][:-30]  # bound the FIFO
                    else:
                        self.frames[i][:] = [frame]
            time.sleep(0.0)
        self.running = False

    def __iter__(self):
        return self

    def __next__(self):
        if not self.running and all(len(f) == 0 for f in self.frames):
            raise StopIteration
        out: List[np.ndarray] = []
        with self._lock:
            for buf in self.frames:
                if self.buffer and len(buf) > 1:
                    out.append(buf.pop(0))
                elif buf:
                    out.append(buf[-1].copy())
                else:
                    raise StopIteration
        if not self.running:
            raise StopIteration
        return out, [str(s) for s in self.sources]

    def close(self):
        self.running = False
        for t in self.threads:
            t.join(timeout=1.0)
        for cap in self.caps:
            cap.release()

    def __len__(self):
        return len(self.sources)


class LoadScreenshots:
    """Screen capture ("screen", "screen 1", "screen 1 100 200 640 480"):
    the JAX package grabs it with `mss`, which the port does not use."""

    def __init__(self, source: str):
        raise NotImplementedError(f"screen capture ({source!r}) needs the 'mss' package, which the port does "
                                  "not use: pass frames, files or a stream instead")


class LoadImagesAndVideos:
    """Lazy file iterator over a directory's files, a glob pattern's matches
    (both sorted, those with a suffix in `exts`), or one file: images yield
    once, videos frame by frame (every vid_stride-th, tagged `path#i`).
    Yields (bgr_frame, path_tag)."""

    def __init__(self, source, vid_stride: int = 1, exts=IMG_EXTS | VID_EXTS):
        self.vid_stride = vid_stride
        s = str(source)
        p = Path(s)
        if p.is_dir():
            self.files = [str(f) for f in sorted(p.iterdir()) if f.suffix.lower() in exts]
        elif any(ch in s for ch in "*?[") and not p.exists():
            self.files = [f for f in sorted(glob.glob(s)) if Path(f).suffix.lower() in exts]
        else:
            self.files = [str(p)]

    def __iter__(self):
        for f in self.files:
            if Path(f).suffix.lower() in VID_EXTS:
                import cv2

                cap = cv2.VideoCapture(f)
                i = 0
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    if i % self.vid_stride == 0:
                        yield frame, f"{f}#{i}"
                    i += 1
                cap.release()
            else:
                yield read_image(f), f


def autocast_list(source) -> list:
    """A list of PIL images, arrays and paths -> BGR numpy frames."""
    out = []
    for im in source:
        if hasattr(im, "mode"):  # PIL
            arr = np.asarray(im.convert("RGB"))[..., ::-1]
        elif isinstance(im, np.ndarray):
            arr = im
        elif isinstance(im, (str, bytes)) or hasattr(im, "__fspath__"):
            arr = read_image(im.decode() if isinstance(im, bytes) else im)
        else:
            raise TypeError(f"unsupported inference source element: {type(im)}")
        out.append(np.ascontiguousarray(arr))
    return out


class LoadPilAndNumpy:
    """In-memory PIL images and arrays: one pass of (frame, tag) pairs."""

    def __init__(self, im0):
        if not isinstance(im0, (list, tuple)):
            im0 = [im0]
        self.im0 = autocast_list(im0)
        self.paths = [getattr(im, "filename", "") or f"image{i}.jpg" for i, im in enumerate(im0)]
        self.mode = "image"
        self.bs = len(self.im0)

    def __len__(self):
        return len(self.im0)

    def __iter__(self):
        for img, p in zip(self.im0, self.paths):
            yield img, p


class LoadTensor:
    """A (B, 3, H, W) or (B, H, W, 3) batch (a torch tensor or an array):
    each frame as HWC BGR uint8; floats in [0, 1] are scaled to 0-255."""

    def __init__(self, im0):
        arr = np.asarray(im0.detach().cpu() if hasattr(im0, "detach") else im0)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):  # BCHW -> BHWC
            arr = arr.transpose(0, 2, 3, 1)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        self.im0 = arr
        self.mode = "image"
        self.bs = len(arr)

    def __len__(self):
        return len(self.im0)

    def __iter__(self):
        for i, img in enumerate(self.im0):
            yield img, f"tensor{i}.jpg"
