"""COCO-format predictions (the port's copy of the JAX package's
utils/coco_json.py): per-image detections -> predictions.json, the same
bytes as the JAX package writes for the same detections."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


def detections_to_coco_json(per_image: List[Dict], out_path: str) -> str:
    """per_image: [{"image_id": int or str, "boxes": (n, 6) xyxy, conf, cls}];
    writes [{image_id, category_id, bbox (x, y, w, h), score}, ...] to out_path."""
    records = []
    for item in per_image:
        for row in item["boxes"]:
            x1, y1, x2, y2, conf, cls = [float(v) for v in row[:6]]
            records.append({"image_id": item["image_id"], "category_id": int(cls),
                            "bbox": [round(x1, 3), round(y1, 3), round(x2 - x1, 3), round(y2 - y1, 3)],
                            "score": round(conf, 5)})
    Path(out_path).write_text(json.dumps(records))
    return out_path
