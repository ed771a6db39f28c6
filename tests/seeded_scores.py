"""Seeded models at full load for the tests of what consumes detections.

A seeded model's Detect class biases start at the prior of 5 objects per
640 px image (log(5 / nc / (640 / s)^2), about -7 to -10), so its class
scores sit near 1e-4 and few anchors pass a predict threshold. The tests
that measure a tracker, a predictor or a writer at full load, not the
model, zero those biases first: every score is then near 0.5.
"""

import torch


def zero_class_priors(model) -> None:
    """Set the last class conv's bias of every Detect-family head in `model`
    to 0, and a WorldDetect's contrastive heads' bias (-10 at init, its
    class prior)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import Detect
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules_world import WorldDetect

    with torch.no_grad():
        for head in (m for m in model.modules() if isinstance(m, Detect)):
            for _, cv3 in head.branches():
                for seq in cv3:
                    seq[-1].bias.zero_()
            for contrastive in head.cv4 if isinstance(head, WorldDetect) else ():
                contrastive.bias.zero_()
