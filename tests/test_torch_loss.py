"""The port's detection loss vs the JAX package's, in fp32 on the CPU.

Seeded numpy raw maps and padded targets go through JAX `detection_loss`
(its assigner on the XLA path) and the port's (its assigner's plain
version): the total, the three gained items and the gradient with respect to
every raw map. Tolerance rtol 1e-4 / atol 1e-5 (atol 1e-6 on the grads):
the same fp32 math, summed in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.utils.loss import detection_loss as jax_detection_loss
from improving_yolov8_cbam_swinblock_tpu_torch.ops.boxes import ciou_xyxy
from improving_yolov8_cbam_swinblock_tpu_torch.utils.loss import detection_loss

jax.config.update("jax_platforms", "cpu")


def make_case(b, g, nc, imgsz, seed):
    rng = np.random.default_rng(seed)
    no = 64 + nc
    feats = [rng.normal(0, 1.5, (b, imgsz // s, imgsz // s, no)).astype(np.float32) for s in (8, 16, 32)]
    cls = rng.integers(0, nc, (b, g)).astype(np.int32)
    xy = rng.uniform(0.2, 0.8, (b, g, 2))
    wh = rng.uniform(0.1, 0.5, (b, g, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = (rng.random((b, g)) < 0.7).astype(np.float32)
    mask[0, 0] = 1.0
    mask[-1] = 0.0  # an image without targets
    return feats, cls, boxes, mask


@pytest.mark.parametrize("b,g,nc,imgsz,seed", [(2, 6, 1, 64, 0), (3, 8, 3, 96, 1), (2, 12, 80, 64, 2)])
def test_loss_and_grad_match_jax(b, g, nc, imgsz, seed):
    feats, cls, boxes, mask = make_case(b, g, nc, imgsz, seed)

    def jloss(fs):
        return jax_detection_loss(fs, jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), nc=nc)

    (jtotal, jitems), jgrads = jax.value_and_grad(jloss, has_aux=True)([jnp.asarray(f) for f in feats])

    tfeats = [torch.tensor(f).permute(0, 3, 1, 2).contiguous().requires_grad_() for f in feats]
    total, items = detection_loss(tfeats, torch.tensor(cls), torch.tensor(boxes), torch.tensor(mask), nc=nc)
    total.backward()

    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-4, atol=1e-5)
    for name in ("box", "cls", "dfl"):
        np.testing.assert_allclose(getattr(items, name).item(), float(getattr(jitems, name)), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(jitems.box) > 0  # the case has foreground anchors
    for tf, jg in zip(tfeats, jgrads):
        np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_ciou_matches_jax_bbox_iou():
    from improving_yolov8_cbam_swinblock_tpu.ops.boxes import bbox_iou

    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 50, (2, 64, 2))
    wh = rng.uniform(0, 20, (2, 64, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    ref = np.asarray(bbox_iou(jnp.asarray(boxes[0]), jnp.asarray(boxes[1]), xywh=False, CIoU=True))[..., 0]
    got = ciou_xyxy(torch.tensor(boxes[0]), torch.tensor(boxes[1])).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
