"""PyTorch/CUDA port of improving_yolov8_cbam_swinblock_tpu.

Builds the fork's YAML graphs as torch modules, serves `YOLO(cfg).predict`
and runs the detect train step (`DetectionTrainer`). Hand-written CUDA
kernels for Hopper: the SwinBlock forward (csrc/swin_block_fwd.cu) and
backward (csrc/swin_block_bwd.cu) and the task-aligned assigner
(csrc/tal_assign.cu). Entry points run on the card unless the caller passes
device="cpu".
"""

from .engine.model import YOLO
from .engine.trainer import DetectionTrainer
from .nn.tasks import DetectionModel

__all__ = ["YOLO", "DetectionModel", "DetectionTrainer"]
