"""RT-DETR training in the port vs the JAX package: the denoising group, the train dict, the loss and its grads.

On the JAX package's tiny graph (tests/test_rtdetr.py) at 64 px with seeded
numpy variables carried in by the weight bridge, in fp32, under one jax.jit
(the forward with its denoising group and the loss's value and grads):

  * the denoising group's four draws are JAX's, taken from its own key
    inside the jit (a spy around get_cdn_group that draws them as it does)
    and handed to the port with the targets; the group's embeddings, box
    logits and the attention mask equal JAX's (MOD_TOL);
  * the train dict (every decoder layer's boxes and logits, the denoising
    queries first, and the encoder's top-k) and the moved BatchNorm
    statistics within GRAPH_TOL;
  * the Hungarian assignment of the seven supervised layers equals JAX's
    (costs built in fp32 on both; where one differs, its costs must be a
    near tie, and JAX's assignment is injected to hold the loss), then the
    total and the (giou, cls, l1) items within GRAPH_TOL and every
    parameter's gradient within GRAD_TOL of its largest magnitude (or of
    GRAD_FLOOR of the largest of all, where a gradient is zero but for
    rounding: AIFI's last LayerNorm bias, which a train-mode BatchNorm
    follows);
  * detr_layers_loss against the golden file of the reference's DETRLoss
    (tests/golden/detr_loss.npz) within the JAX test's rtol 2e-4.

The trainer: twelve SGD steps on one batch lower the loss (the JAX test's
overfit check); YOLO.train for one epoch on a synthetic dataset logs
train/giou_loss, train/cls_loss and train/l1_loss and validates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.nn import transformer as JT
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.utils import detr_loss as JL
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, DetectionTrainer
from improving_yolov8_cbam_swinblock_tpu_torch.nn import transformer as T
from improving_yolov8_cbam_swinblock_tpu_torch.utils import detr_loss as L
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import state_dict_from_jax
from tests.test_torch_model import seeded_variables
from tests.test_torch_rtdetr import TINY_RTDETR
from tests.test_torch_yolo11 import close, to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
MOD_TOL = 1e-5
GRAPH_TOL = 2e-3
GRAD_TOL = 2e-3
GRAD_FLOOR = 1e-4  # of the largest gradient: the scale of a gradient that is zero but for rounding
NEAR_TIE = 1e-4  # a differing assignment's total cost against JAX's, relative to it, for a near tie
B, G = 2, 8
TARGETS = {
    "cls": np.array([[0, 1, 2, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0, 0, 0]], np.int32),
    "bboxes": np.concatenate([np.random.default_rng(4).uniform(0.2, 0.6, (B, G, 2)),
                              np.random.default_rng(5).uniform(0.1, 0.4, (B, G, 2))], -1).astype(np.float32),
    "mask": np.array([[1, 1, 1, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0, 0, 0]], np.float32),
}
TARGETS["bboxes"] *= TARGETS["mask"][..., None]
IMG = np.random.default_rng(2).uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX side under one jax.jit: the train dict with its denoising draws
    (the spy's), the moved statistics, the Hungarian assignment of the seven
    matched layers, and the loss's value, items and grads."""
    jm = JaxDetectionModel(dict(TINY_RTDETR))
    v = seeded_variables(jm, 64, np.random.default_rng(6))
    captured = {}
    orig = JT.get_cdn_group

    def spy(gt_cls, gt_bbox, gt_mask, class_embed, rng, num_classes, num_dn=100, cls_noise_ratio=0.5,
            box_noise_scale=1.0):
        b, g = gt_cls.shape
        total = 2 * max(1, num_dn // g) * g
        k_flip, k_cls, k_sign, k_part = jax.random.split(rng, 4)  # get_cdn_group's own draws
        captured.update(flip=jax.random.uniform(k_flip, (b, total)),
                        cls=jax.random.randint(k_cls, (b, total), 0, num_classes),
                        sign=jax.random.randint(k_sign, (b, total, 4), 0, 2),
                        part=jax.random.uniform(k_part, (b, total, 4)))
        out = orig(gt_cls, gt_bbox, gt_mask, class_embed, rng, num_classes, num_dn, cls_noise_ratio, box_noise_scale)
        captured.update(dn_embed=out[0], dn_bbox=out[1])
        return out

    tg = {k: jnp.asarray(a) for k, a in TARGETS.items()}

    def run(params, stats, x):
        def loss_fn(p):
            preds, mut = jm.net.apply({"params": p, "batch_stats": stats}, x, train=True, targets=tg,
                                      rngs={"dn": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
            num_dn = preds["dec_bboxes"].shape[2] - preds["enc_bboxes"].shape[1]
            total, items = JL.rtdetr_loss(preds, tg["cls"], tg["bboxes"], tg["mask"], 3, num_dn=num_dn)
            draws = {k: jax.lax.stop_gradient(captured[k]) for k in ("flip", "cls", "sign", "part", "dn_embed", "dn_bbox")}
            return total, (items, preds, mut["batch_stats"], num_dn, draws)

        (total, (items, preds, moved, num_dn, draws)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        mask = (tg["mask"] > 0) & (tg["bboxes"].sum(-1) > 0)
        main_b = jnp.concatenate([preds["enc_bboxes"][None], preds["dec_bboxes"][:, :, num_dn:]], 0)
        main_s = jnp.concatenate([preds["enc_scores"][None], preds["dec_scores"][:, :, num_dn:]], 0)
        rep = lambda t: jnp.broadcast_to(t[None], (main_b.shape[0],) + t.shape)
        q_idx = JL.hungarian_assign(main_b, main_s, rep(tg["bboxes"]), rep(tg["cls"]), rep(mask))
        return {"total": total, "items": jnp.stack(items), "preds": preds, "moved": moved, "grads": grads,
                "q_idx": q_idx, "draws": draws}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "get_cdn_group", spy)
        out = jax.jit(run)(v["params"], v["batch_stats"], jnp.asarray(IMG))
    return {"vars": v, "out": jax.tree.map(np.asarray, out)}


def port_train(jax_side):
    """The port's tiny graph on JAX's weights, in training, and its train dict
    on the same image, targets and denoising draws."""
    pm = DetectionModel(dict(TINY_RTDETR), device="cpu")
    pm.load_state_dict(state_dict_from_jax(jax_side["vars"]), strict=True)
    pm.train()
    d = jax_side["out"]["draws"]
    tg = {"cls": torch.from_numpy(TARGETS["cls"]).long(), "bboxes": torch.from_numpy(TARGETS["bboxes"]),
          "mask": torch.from_numpy(TARGETS["mask"]),
          "dn_draws": {k: torch.from_numpy(np.asarray(d[k])) for k in ("flip", "cls", "sign", "part")}}
    return pm, pm(to_torch(IMG), targets=tg)


def test_cdn_group_and_mask_match_jax(jax_side):
    """get_cdn_group on JAX's draws: 2 x 12 groups of the 8 GT slots (192
    denoising queries), embeddings and box logits equal JAX's; the attention
    mask equals JAX's, True where blocked."""
    pm = DetectionModel(dict(TINY_RTDETR), device="cpu")
    pm.load_state_dict(state_dict_from_jax(jax_side["vars"]), strict=True)
    d = jax_side["out"]["draws"]
    emb, box, mask2, ng = T.get_cdn_group(
        torch.from_numpy(TARGETS["cls"]), torch.from_numpy(TARGETS["bboxes"]), torch.from_numpy(TARGETS["mask"]),
        pm.model[-1].denoising_class_embed.weight.detach(), 3,
        {k: torch.from_numpy(np.asarray(d[k])) for k in ("flip", "cls", "sign", "part")})
    assert ng == 12 and emb.shape == (B, 192, 32) and mask2.shape == (B, 192)
    close(emb.numpy(), d["dn_embed"], MOD_TOL)
    close(box.numpy(), d["dn_bbox"], MOD_TOL)
    np.testing.assert_array_equal(T.build_cdn_attn_mask(192, 8, 12, 16), JT.build_cdn_attn_mask(192, 8, 12, 16))
    g = torch.Generator().manual_seed(0)
    draws = T.cdn_draws(B, 192, 3, g, "cpu")
    assert draws["flip"].shape == (B, 192) and int(draws["cls"].max()) < 3 and set(draws["sign"].unique().tolist()) <= {0, 1}


def test_train_dict_and_moved_stats_match_jax(jax_side):
    """The train dict within GRAPH_TOL of JAX's: (2 layers, B, 192 + 16, .)
    decoder boxes and logits, (B, 16, .) encoder top-k; every moved BatchNorm
    statistic too."""
    pm, out = port_train(jax_side)
    ref = jax_side["out"]["preds"]
    assert out["dec_bboxes"].shape == ref["dec_bboxes"].shape == (2, B, 208, 4)
    for k in ("dec_bboxes", "dec_scores", "enc_bboxes", "enc_scores"):
        close(out[k].detach().numpy(), ref[k], GRAPH_TOL)
    want = state_dict_from_jax({"batch_stats": jax_side["out"]["moved"]})
    got = pm.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) >= 8
    for k in stats:
        close(got[k].numpy(), want[k].numpy(), GRAPH_TOL)


def test_loss_and_grads_match_jax(jax_side):
    """The Hungarian assignment equals JAX's, or differs only at a near tie
    (then JAX's is injected); the total loss and the (giou, cls, l1) items
    within GRAPH_TOL, each parameter's gradient within GRAD_TOL of its
    largest magnitude (the module docstring)."""
    pm, out = port_train(jax_side)
    num_dn = out["dec_bboxes"].shape[2] - out["enc_bboxes"].shape[1]
    cls, box, mask = (torch.from_numpy(TARGETS[k]) for k in ("cls", "bboxes", "mask"))
    gt_mask = (mask > 0) & (box.sum(-1) > 0)
    main_b = torch.cat([out["enc_bboxes"][None], out["dec_bboxes"][:, :, num_dn:]], 0)
    main_s = torch.cat([out["enc_scores"][None], out["dec_scores"][:, :, num_dn:]], 0)
    q_port = L.hungarian_assign(main_b, main_s, box, cls, gt_mask)
    q_jax = torch.from_numpy(jax_side["out"]["q_idx"]).long()
    assert q_port.shape == q_jax.shape == (3, B, G)
    differ = (q_port != q_jax) & gt_mask
    if bool(differ.any()):  # a near tie: the two assignments cost the same to NEAR_TIE under the port's costs
        cost = L.match_costs(main_b, main_s, box, cls, gt_mask)
        for li, bi in {(int(a), int(b)) for a, b, _ in differ.nonzero()}:
            c = cost[li, bi]
            cols = torch.arange(G)[gt_mask[bi]]
            mine, theirs = c[q_port[li, bi, cols], cols].sum(), c[q_jax[li, bi, cols], cols].sum()
            assert abs(float(mine - theirs)) <= NEAR_TIE * abs(float(theirs))
    total, items = L.rtdetr_loss(out, cls, box, mask, 3, num_dn=num_dn, q_idx=q_jax)
    assert float(total) > 0
    close(np.array([float(total)]), np.array([jax_side["out"]["total"]]), GRAPH_TOL)
    close(torch.stack(items).detach().numpy(), jax_side["out"]["items"], GRAPH_TOL)
    total.backward()
    want = state_dict_from_jax({"params": jax_side["out"]["grads"]})
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert want.keys() == grads.keys()
    assert all(g is not None for g in grads.values())
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    for n, g in grads.items():
        w = want[n].numpy()
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * max(np.abs(w).max(), floor), n


def test_detr_layers_loss_golden():
    """The dense fixed-shape Hungarian loss against the reference's ragged
    DETRLoss on its golden inputs (the JAX test's rtol 2e-4): the last layer's
    class, L1 and GIoU, and the sums over the auxiliary layers."""
    from pathlib import Path

    f = np.load(Path(__file__).parent / "golden" / "detr_loss.npz")
    t = lambda k: torch.from_numpy(np.asarray(f[k]))
    cls_l, l1_l, giou_l = L.detr_layers_loss(t("pred_bboxes"), t("pred_scores"), t("gt_cls"), t("gt_box"),
                                             t("gt_mask"), nc=5)
    for got, key in ((cls_l[-1], "loss_class"), (l1_l[-1], "loss_bbox"), (giou_l[-1], "loss_giou"),
                     (cls_l[:-1].sum(), "loss_class_aux"), (l1_l[:-1].sum(), "loss_bbox_aux"),
                     (giou_l[:-1].sum(), "loss_giou_aux")):
        np.testing.assert_allclose(float(got), f[key], rtol=2e-4)


def test_trainer_overfits_one_batch_and_fits(tmp_path, monkeypatch):
    """Twelve SGD steps of the trainer on one batch lower the loss, the
    denoising draws coming from the trainer's seeded generator; YOLO.train
    for one epoch on a synthetic dataset writes the RT-DETR loss columns
    and validates the EMA weights."""
    import yaml

    from improving_yolov8_cbam_swinblock_tpu_torch.utils import settings as PS
    from tests.synth_data import make_synth_dataset

    monkeypatch.setitem(PS.SETTINGS, "tensorboard", False)  # its import (TensorFlow here) takes seconds

    tr = DetectionTrainer(overrides={"model": dict(TINY_RTDETR), "batch": 2, "nbs": 2, "imgsz": 64, "amp": False,
                                     "optimizer": "SGD", "lr0": 0.05, "warmup_epochs": 0.0}, device="cpu").setup()
    assert tr.model.model[-1].dn_generator is tr.dn_gen
    step, _ = tr._make_train_step(nb=100)
    batch = {"img": (IMG * 255).astype(np.uint8), **TARGETS}
    losses = [float(step(batch).sum()) for _ in range(12)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]

    cfg = tmp_path / "rtdetr-tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_RTDETR))
    data = make_synth_dataset(tmp_path / "data", n_train=4, n_val=2, imgsz=64, nc=3, seed=0)
    y = YOLO(str(cfg), device="cpu")
    metrics = y.train(data=str(data), epochs=1, batch=2, nbs=2, imgsz=64, max_gt=8, amp=False, device="cpu", workers=0,
                      project=str(tmp_path / "runs"), plots=False, val=True)
    rows = y.trainer.metrics_rows
    assert {"train/giou_loss", "train/cls_loss", "train/l1_loss"} <= set(rows[0])
    assert np.isfinite([rows[0][k] for k in ("train/giou_loss", "train/cls_loss", "train/l1_loss")]).all()
    assert "mAP50-95" in metrics and y.model.is_rtdetr


def test_train_forward_with_fewer_anchors_than_queries():
    """nq (100) above the tiny graph's 84 anchors at 64 px: the queries are
    the 84 anchors and the denoising mask spans 192 + 84 queries (the JAX
    package builds it over nq and raises: ROADMAP Queue 3); the train dict
    and the loss are finite."""
    cfg = {**TINY_RTDETR, "head": [TINY_RTDETR["head"][0], [[2, 3, 5], 1, "RTDETRDecoder", ["nc", 32, 100, 2, 4, 2, 64]]]}
    pm = DetectionModel(cfg, device="cpu").train()
    tg = {k: torch.from_numpy(a) for k, a in TARGETS.items()}
    out = pm(to_torch(IMG), targets={**tg, "cls": tg["cls"].long()})
    assert out["dec_bboxes"].shape == (2, B, 192 + 84, 4) and out["enc_scores"].shape == (B, 84, 3)
    total, items = L.rtdetr_loss(out, tg["cls"], tg["bboxes"], tg["mask"], 3, num_dn=192)
    assert np.isfinite(float(total)) and all(np.isfinite(float(i)) for i in items)
