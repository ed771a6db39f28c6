"""The port's device augmentation vs the JAX package's, with injected parameters.

HSV, mosaic placement, the affine crop and the flip take the same numpy
images, boxes and parameters (gains, centres, scales, translations, flips)
in both packages. HSV, mosaic and flip are exact. The affine crop resamples
with jax.image.scale_and_translate's positions and edge rule: its uint8
pixels differ by at most 1 (a float sum taken in another order can round
the other way at .5) on at most 0.1 % of the pixels, and its boxes and
candidate mask agree to 1e-4. The random draws are each package's own and
are not compared; device_augment is checked for its contract.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.ops import augment_device as JA
from improving_yolov8_cbam_swinblock_tpu_torch.ops import augment_device as TA

jax.config.update("jax_platforms", "cpu")


def test_hsv_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, 16, 20, 3), dtype=np.uint8)
    img[0, :4] = 128  # grey: zero chroma
    img[1, :2] = 0
    gains = rng.uniform(-1, 1, (3, 3)) * np.array([0.015, 0.7, 0.4]) + 1
    gains[2] = [1.4, 1.9, 0.3]  # hue wraps, saturation and value clip
    gains = gains.astype(np.float32)
    ref = np.asarray(JA.hsv_device(jnp.asarray(img), jnp.asarray(gains)))
    got = TA.hsv_device(torch.tensor(img), torch.tensor(gains)).numpy()
    np.testing.assert_array_equal(got, ref)


def mosaic_inputs(s, g, seed):
    rng = np.random.default_rng(seed)
    srcs = rng.integers(0, 256, (4, s, s, 3), dtype=np.uint8)
    xy = rng.uniform(0, s, (4, g, 2))
    wh = rng.uniform(1, s / 2, (4, g, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    cls = rng.integers(0, 3, (4, g)).astype(np.float32)
    mask = (rng.random((4, g)) < 0.7).astype(np.float32)
    return srcs, boxes, cls, mask


@pytest.mark.parametrize("center", [(16.0, 16.0), (8.3, 23.9), (23.99, 8.0), (19.5, 12.25)])
def test_mosaic_placement_matches_jax(center):
    srcs, boxes, cls, mask = mosaic_inputs(16, 5, 1)
    c = np.asarray(center, np.float32)
    ref = [np.asarray(r) for r in JA._mosaic_one(*(jnp.asarray(a) for a in (srcs, boxes, cls, mask, c)))]
    got = [r.numpy() for r in TA.mosaic_one(*(torch.tensor(a) for a in (srcs, boxes, cls, mask, c)))]
    np.testing.assert_array_equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,t", [(1.0, (16.0, 16.0)), (0.55, (13.0, 19.0)), (1.5, (17.7, 14.2)), (1.23, (19.2, 12.9))])
def test_affine_crop_matches_jax(k, t):
    rng = np.random.default_rng(2)
    s = 32
    canvas = rng.integers(0, 256, (2 * s, 2 * s, 3), dtype=np.uint8)
    xy = rng.uniform(0, 2 * s, (12, 2))
    wh = rng.uniform(1, s, (12, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    kk, tt = np.float32(k), np.asarray(t, np.float32)
    rimg, rbox, rcand = (np.asarray(v) for v in JA._affine_crop(jnp.asarray(canvas), jnp.asarray(boxes),
                                                                jnp.asarray(kk), jnp.asarray(tt), s))
    gimg, gbox, gcand = TA.affine_crop(torch.tensor(canvas)[None], torch.tensor(boxes)[None],
                                       torch.tensor([kk]), torch.tensor(tt)[None], s)
    diff = np.abs(gimg[0].numpy().astype(int) - rimg.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    if k < 1:  # the edge: samples outside the canvas are 114
        assert (rimg == 114).any()
    np.testing.assert_allclose(gbox[0].numpy(), rbox, atol=1e-4)
    np.testing.assert_array_equal(gcand[0].numpy(), rcand)


def test_flip_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (3, 8, 10, 3), dtype=np.uint8)
    boxes = rng.uniform(0, 1, (3, 4, 4)).astype(np.float32)
    cls = rng.integers(0, 3, (3, 4)).astype(np.float32)
    mask = (rng.random((3, 4)) < 0.6).astype(np.float32)
    flip = np.array([True, False, True])
    ref = JA.flip_lr_device(JA.AugBatch(*(jnp.asarray(a) for a in (img, boxes, cls, mask))), jnp.asarray(flip))
    got = TA.flip_lr_device(TA.AugBatch(*(torch.tensor(a) for a in (img, boxes, cls, mask))), torch.tensor(flip))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mosaic_affine_matches_jax_with_injected_draws():
    """The batched pipeline (mosaic on some images, plain on others) with the
    same donors, centres, scales and translations."""
    rng = np.random.default_rng(4)
    b, s, g = 3, 32, 4
    imgs = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    xy, wh = rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.1, 0.4, (b, g, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    cls = rng.integers(0, 2, (b, g)).astype(np.float32)
    mask = (rng.random((b, g)) < 0.8).astype(np.float32)
    donors = rng.integers(0, b, (b, 3)).astype(np.int32)
    centers = rng.uniform(s / 2, 3 * s / 2, (b, 2)).astype(np.float32)
    scales = rng.uniform(0.6, 1.4, b).astype(np.float32)
    trans = rng.uniform(0.4 * s, 0.6 * s, (b, 2)).astype(np.float32)
    use = np.array([True, False, True])
    args = (imgs, bboxes, cls, mask, donors, centers, scales, trans, use)
    ref = JA.mosaic_affine_device(*(jnp.asarray(a) for a in args))
    got = TA.mosaic_affine_device(*(torch.tensor(a) for a in args))
    diff = np.abs(got.img.numpy().astype(int) - np.asarray(ref.img).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(ref.bboxes), atol=1e-5)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.cls.numpy(), np.asarray(ref.cls))


def test_device_augment_contract():
    rng = np.random.default_rng(5)
    b, s, g = 4, 32, 3
    img = torch.tensor(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8))
    bboxes = torch.tensor(np.concatenate([rng.uniform(0.3, 0.7, (b, g, 2)), rng.uniform(0.2, 0.4, (b, g, 2))],
                                         -1).astype(np.float32))
    cls = torch.ones(b, g)
    mask = torch.ones(b, g)
    hyp = {"mosaic": 1.0, "scale": 0.5, "translate": 0.1, "fliplr": 0.5, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4}
    out = TA.device_augment(torch.Generator().manual_seed(0), img, bboxes, cls, mask, hyp)
    assert out.img.shape == (b, s, s, 3) and out.img.dtype == torch.uint8
    assert out.bboxes.shape == (b, 4 * g, 4) and out.mask.shape == (b, 4 * g) and out.cls.shape == (b, 4 * g)
    live = out.mask > 0
    assert live.any()
    assert ((out.bboxes[live] >= 0) & (out.bboxes[live] <= 1)).all()
    assert (out.bboxes[~live] == 0).all()
    again = TA.device_augment(torch.Generator().manual_seed(0), img, bboxes, cls, mask, hyp)
    assert torch.equal(again.img, out.img)  # the generator alone decides the draws
    # with every probability and magnitude at 0 the pipeline is the identity
    zero = {k: 0.0 for k in hyp}
    same = TA.device_augment(torch.Generator().manual_seed(0), img, bboxes, cls, mask, zero)
    assert torch.equal(same.img, img)
    torch.testing.assert_close(same.bboxes[:, :g], bboxes, atol=1e-5, rtol=0)
