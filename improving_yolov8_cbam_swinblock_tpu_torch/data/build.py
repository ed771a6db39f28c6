"""Dataset and loader builders (counterpart of the JAX package's data/build.py:25-121):
the one construction path that the trainer and YOLO.val share, and the
predictor's source sniffing and streamed sources."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .dataset import DataLoader, YOLODataset
from .loaders import LoadImagesAndVideos, LoadScreenshots, LoadStreams, is_stream_source

# augmentation keys forwarded from the configuration into the loader
HYP_KEYS = (
    "mosaic", "mosaic9", "mosaic3", "mixup", "copy_paste", "copy_paste_mode", "degrees",
    "translate", "scale", "shear", "perspective", "hsv_h", "hsv_s", "hsv_v", "flipud",
    "fliplr", "pixel_augment", "mask_ratio", "overlap_mask",
)


def build_yolo_dataset(cfg, img_path, data: Dict, mode: str = "train", kpt_shape=None) -> YOLODataset:
    """The dataset of one split: train mode honours `fraction`, val and test
    read the whole split. A pose model's kpt_shape makes it a keypoint
    dataset, with the data descriptor's `flip_idx`."""
    return YOLODataset(
        img_path,
        imgsz=cfg.imgsz,
        max_gt=cfg.max_gt,
        nc=1 if getattr(cfg, "single_cls", False) else int(data["nc"]),
        single_cls=getattr(cfg, "single_cls", False),
        fraction=float(getattr(cfg, "fraction", 1.0) or 1.0) if mode == "train" else 1.0,
        cache=getattr(cfg, "cache", False) or False,
        kpt_shape=kpt_shape,
        flip_idx=data.get("flip_idx") if kpt_shape else None,
    )


def build_dataloader(dataset: YOLODataset, batch: int, workers: int = 8, train: bool = True,
                     hyp: Optional[Dict] = None, seed: int = 0, device_augment: bool = True,
                     rect_shape=None, task: str = "detect") -> DataLoader:
    """The fixed-shape prefetch loader; task "segment" adds the instances' masks, "pose" their keypoints."""
    return DataLoader(dataset, batch, train=train, hyp=hyp, seed=seed, workers=workers,
                      device_augment=device_augment, rect_shape=rect_shape, task=task)


@dataclass
class SourceTypes:
    """What kind of predict source check_source found."""

    stream: bool = False
    screenshot: bool = False
    from_img: bool = False
    tensor: bool = False


def check_source(source):
    """(source, SourceTypes): webcam indices ('0' or 0) and rtsp / rtmp /
    http / tcp URLs are streams, 'screen...' a screen grab, arrays, PIL
    images and lists in-memory images, other objects with __array__
    (torch tensors) tensors; any other type raises TypeError."""
    st = SourceTypes()
    if isinstance(source, (str, Path, int)):
        if str(source).split()[:1] == ["screen"]:
            st.screenshot = True
        elif is_stream_source(source):
            st.stream = True
    elif hasattr(source, "convert") and hasattr(source, "size"):  # PIL
        st.from_img = True
    elif hasattr(source, "__array__"):
        st.from_img = isinstance(source, np.ndarray)
        st.tensor = not st.from_img
    elif isinstance(source, (list, tuple)):
        st.from_img = True
    else:
        raise TypeError(f"unsupported predict source type: {type(source)}")
    return source, st


def load_inference_source(source, vid_stride: int = 1, stream_buffer: bool = False):
    """The iterator of a streamed source: LoadStreams for streams (a FIFO of
    frames with stream_buffer, else the newest), LoadScreenshots for a
    screen grab, LoadImagesAndVideos for files and directories. In-memory
    sources go through the batched predict path, not a stream loader."""
    source, st = check_source(source)
    if st.screenshot:
        return LoadScreenshots(source)
    if st.stream:
        return LoadStreams(source, vid_stride=vid_stride, buffer=stream_buffer)
    if st.from_img or st.tensor:
        raise TypeError("in-memory sources are served by the batched predict path, not a stream loader")
    return LoadImagesAndVideos(source, vid_stride=vid_stride)
