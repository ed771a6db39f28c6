"""PyTorch/CUDA port of improving_yolov8_cbam_swinblock_tpu.

Builds the fork's YAML graphs as torch modules, serves `YOLO(cfg).predict`,
quantizes a model to int8 in place (`quantize_model`, post-training), runs
the detect train step (`DetectionTrainer`), and trains and validates from a
YOLO-format dataset on disk (`YOLO.train`, `YOLO.val`). Hand-written CUDA kernels
for Hopper: the SwinBlock forward (csrc/swin_block_fwd.cu), its backward
(csrc/swin_block_bwd.cu) and its int8 form (csrc/swin_block_int8.cu), and
the task-aligned assigner (csrc/tal_assign.cu). Entry points run on the
card unless the caller passes device="cpu".
"""

from .engine.model import YOLO
from .engine.trainer import DetectionTrainer
from .nn.tasks import DetectionModel
from .ops.quant import quantize_model

__all__ = ["YOLO", "DetectionModel", "DetectionTrainer", "quantize_model"]
