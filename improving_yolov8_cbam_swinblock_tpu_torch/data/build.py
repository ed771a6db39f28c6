"""Dataset and loader builders (counterpart of the JAX package's data/build.py:25-61):
the one construction path that the trainer and YOLO.val share."""

from __future__ import annotations

from typing import Dict, Optional

from .dataset import DataLoader, YOLODataset

# augmentation keys forwarded from the configuration into the loader
HYP_KEYS = (
    "mosaic", "mosaic9", "mosaic3", "mixup", "copy_paste", "copy_paste_mode", "degrees",
    "translate", "scale", "shear", "perspective", "hsv_h", "hsv_s", "hsv_v", "flipud",
    "fliplr", "pixel_augment", "mask_ratio", "overlap_mask",
)


def build_yolo_dataset(cfg, img_path, data: Dict, mode: str = "train") -> YOLODataset:
    """The dataset of one split: train mode honours `fraction`, val and test
    read the whole split."""
    return YOLODataset(
        img_path,
        imgsz=cfg.imgsz,
        max_gt=cfg.max_gt,
        nc=1 if getattr(cfg, "single_cls", False) else int(data["nc"]),
        single_cls=getattr(cfg, "single_cls", False),
        fraction=float(getattr(cfg, "fraction", 1.0) or 1.0) if mode == "train" else 1.0,
        cache=getattr(cfg, "cache", False) or False,
    )


def build_dataloader(dataset: YOLODataset, batch: int, workers: int = 8, train: bool = True,
                     hyp: Optional[Dict] = None, seed: int = 0, device_augment: bool = True,
                     rect_shape=None) -> DataLoader:
    """The fixed-shape prefetch loader."""
    return DataLoader(dataset, batch, train=train, hyp=hyp, seed=seed, workers=workers,
                      device_augment=device_augment, rect_shape=rect_shape)
