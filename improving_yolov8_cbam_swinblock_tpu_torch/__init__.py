"""PyTorch/CUDA port of improving_yolov8_cbam_swinblock_tpu.

Builds the fork's YAML graphs as torch modules, serves `YOLO(cfg).predict`,
quantizes a model to int8 in place (`quantize_model`, post-training), runs
the detect train step (`DetectionTrainer`), and trains and validates from a
YOLO-format dataset on disk (`YOLO.train`, `YOLO.val`), and serves a model
trained by the JAX package from its `.ckpt` files: predict from image,
video, directory, glob and stream sources, with test-time augmentation,
ensembles (`YOLO([a, b])`) and the predictor's outputs (`save`,
`save_txt`, `save_crop`), and exports a model as a torch.export program
(`YOLO.export(format="pt2")`, served by nn/autobackend.py `Backend`).
Hand-written CUDA kernels
for Hopper: the SwinBlock forward (csrc/swin_block_fwd.cu), its backward
(csrc/swin_block_bwd.cu) and its int8 form (csrc/swin_block_int8.cu), and
the task-aligned assigner (csrc/tal_assign.cu). `RTDETR` serves and
trains the RT-DETR graphs, `YOLOWorld` the open-vocabulary YOLO-World
graphs. Entry points run on the card unless the caller passes device="cpu".
"""

from pathlib import Path as _Path

from .engine.model import YOLO
from .engine.results import Results
from .engine.trainer import DetectionTrainer
from .nn.tasks import DetectionModel, EnsembleModel
from .ops.quant import quantize_model

# the sample images that YOLO.predict serves without a source (copies of the JAX package's assets)
ASSETS = _Path(__file__).parent / "assets"

__all__ = ["ASSETS", "YOLO", "RTDETR", "YOLOWorld", "DetectionModel", "DetectionTrainer", "EnsembleModel",
           "Results", "quantize_model"]


def __getattr__(name):
    # RTDETR and YOLOWorld load on first use, as the JAX package exports them
    if name in ("RTDETR", "YOLOWorld"):
        from .engine import model

        return getattr(model, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
