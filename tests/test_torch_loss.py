"""The port's losses and assigner against the JAX package, on the CPU in f32.

Inputs come from a numpy seed and go through both. Head maps are made NHWC
`(B, H, W, 64 + nc)` for the JAX loss and split at channel 64 into NCHW
`(box, cls)` pairs for the port. Values: rtol 1e-5 / atol 1e-6; assignment
masks and indices: equal; gradients with respect to the head maps: 1e-4 of each
map's largest gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.losses import detection as jdet
from lpc_yolo_tpu.losses.tal import task_aligned_assigner as jax_tal
from lpc_yolo_tpu.ops import anchors as janchors
from lpc_yolo_tpu.ops.boxes import bbox_iou as jax_bbox_iou

from lpc_yolo_tpu_torch.losses import detection as tdet
from lpc_yolo_tpu_torch.losses.tal import task_aligned_assigner
from lpc_yolo_tpu_torch.ops.anchors import bbox2dist, make_anchors
from lpc_yolo_tpu_torch.ops.boxes import bbox_iou

RTOL, ATOL = 1e-5, 1e-6
NC, STRIDES, SHAPES = 5, (8.0, 16.0, 32.0), ((8, 8), (4, 4), (2, 2))  # a 64x64 image


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.asarray(ref),
                               rtol=rtol, atol=atol)


def _boxes(rng, shape, size=64.0):
    xy = rng.uniform(0, size * 0.7, shape + (2,))
    wh = rng.uniform(2.0, size * 0.5, shape + (2,))
    return np.concatenate([xy, np.minimum(xy + wh, size)], -1).astype(np.float32)


def test_bbox_iou_ciou_value_and_gradient():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, (3, 7)), _boxes(rng, (3, 7))
    b[0, 0] = 0.0  # a padded gt row
    for ciou in (False, True):
        ref = jax_bbox_iou(jnp.asarray(a), jnp.asarray(b), xywh=False, CIoU=ciou)
        _close(bbox_iou(torch.from_numpy(a), torch.from_numpy(b), xywh=False, CIoU=ciou), ref)
    _close(bbox_iou(torch.from_numpy(a), torch.from_numpy(b), xywh=True, CIoU=True),
           jax_bbox_iou(jnp.asarray(a), jnp.asarray(b), xywh=True, CIoU=True))
    # alpha is a constant of the gradient in both
    ta = torch.from_numpy(a).requires_grad_()
    bbox_iou(ta, torch.from_numpy(b), xywh=False, CIoU=True).sum().backward()
    gref = jax.grad(lambda x: jax_bbox_iou(x, jnp.asarray(b), xywh=False, CIoU=True).sum())(jnp.asarray(a))
    _close(ta.grad, gref, rtol=1e-4, atol=1e-6)


def test_bbox2dist_and_df_loss():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 8, (20, 2)).astype(np.float32)
    box = _boxes(rng, (2, 20), size=40.0)  # some sides beyond reg_max - 1: the clamp is exercised
    ref = janchors.bbox2dist(jnp.asarray(pts), jnp.asarray(box), 15)
    got = bbox2dist(torch.from_numpy(pts), torch.from_numpy(box), 15)
    _close(got, ref)
    assert float(got.max()) == pytest.approx(15 - 0.01)
    logits = rng.standard_normal((2, 20, 4, 16)).astype(np.float32)
    _close(tdet._df_loss(torch.from_numpy(logits), got), jdet._df_loss(jnp.asarray(logits), ref))
    # a target in the last bin: the right index is clipped to reg_max - 1
    edge = np.full((1, 1, 4), 15 - 0.01, np.float32)
    _close(tdet._df_loss(torch.from_numpy(logits[:1, :1]), torch.from_numpy(edge)),
           jdet._df_loss(jnp.asarray(logits[:1, :1]), jnp.asarray(edge)))


def _assigner_case(seed=2, B=3, M=5):
    """Scores, predicted boxes and padded gts built to hit the assigner's corners: padded
    rows, an image with no gt, two gts that contest anchors (one nested in the
    other), and a gt that holds fewer than `topk` anchor centres."""
    rng = np.random.default_rng(seed)
    pts, strides = make_anchors(SHAPES, STRIDES)
    anc = (pts * strides).numpy()
    A = anc.shape[0]
    scores = rng.uniform(0.01, 0.9, (B, A, NC)).astype(np.float32)
    centre = np.concatenate([anc, anc], -1)[None] + np.array([-1, -1, 1, 1], np.float32) * \
        rng.uniform(2, 20, (B, A, 1)).astype(np.float32)
    gt = np.zeros((B, M, 4), np.float32)
    lab = np.zeros((B, M), np.int32)
    mask = np.zeros((B, M), bool)
    gt[0, 0], gt[0, 1], gt[0, 2] = (4, 4, 60, 60), (10, 10, 40, 40), (20, 20, 30, 30)  # nested: contested anchors
    lab[0, :3], mask[0, :3] = (1, 3, 1), True
    gt[1, 0], gt[1, 1] = (1, 1, 14, 14), (30, 2, 63, 50)  # the first holds one stride-8 centre and no other
    lab[1, :2], mask[1, :2] = (4, 0), True
    gt[1, 3] = (5, 5, 50, 50)  # a padded row with a box in it: must be ignored
    # anchor 1 (centre (12, 4), inside the small gt) predicts a far box: CIoU < 0, metric exactly 0, so it is
    # picked only as one of the lowest-index zeros of the later argmax rounds, and survives as foreground
    centre[1, 1] = (50, 50, 60, 60)
    # image 2: no gt at all
    return scores, centre.astype(np.float32), anc, lab, gt, mask


@pytest.mark.parametrize("topk", [10, 1])
def test_task_aligned_assigner_matches_jax(topk):
    scores, boxes, anc, lab, gt, mask = _assigner_case()
    ref = jax_tal(*map(jnp.asarray, (scores, boxes, anc, lab, gt, mask)), topk=topk, num_classes=NC)
    got = task_aligned_assigner(*map(torch.from_numpy, (scores, boxes, anc, lab, gt, mask)), topk=topk,
                                num_classes=NC)
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(ref.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(ref.target_labels))
    _close(got.target_bboxes, ref.target_bboxes)
    _close(got.target_scores, ref.target_scores)
    fg = got.fg_mask.numpy()
    assert fg[0].sum() > 0 and fg[1].sum() > 0 and fg[2].sum() == 0  # the image without gts assigns nothing
    if topk == 10:
        assert bool(got.fg_mask[1, 1]) and int(got.target_gt_idx[1, 1]) == 0 and float(got.target_scores[1, 1].sum()) == 0
        # the small gt has fewer than topk centres inside it, yet is assigned; contested anchors went to one gt
        assert ((got.target_gt_idx[1] == 0) & got.fg_mask[1]).sum() >= 1
        assert len(np.unique(got.target_gt_idx[0][got.fg_mask[0]].numpy())) >= 2


def _head_maps(seed, B=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, w, 64 + NC)).astype(np.float32) for h, w in SHAPES]


def _pairs(maps):
    """NHWC (B, H, W, 64 + nc) numpy maps -> NCHW (box, cls) leaf tensors and the pairs the port's loss takes."""
    leaves = [torch.from_numpy(m.transpose(0, 3, 1, 2).copy()).requires_grad_() for m in maps]
    return leaves, [(t[:, :64], t[:, 64:]) for t in leaves]


def _grad_close(leaves, jax_grads):
    for t, g in zip(leaves, jax_grads):
        g = np.asarray(g).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max())


@pytest.mark.parametrize("topk", [10, 1])
def test_v8_detection_loss_matches_jax(topk):
    _, _, _, lab, gt, mask = _assigner_case()
    maps = _head_maps(3)
    args = tuple(map(jnp.asarray, (lab, gt, mask)))

    def jloss(ms):
        total, items = jdet.v8_detection_loss(ms, *args, STRIDES, NC, tal_topk=topk)
        return total, items

    (ref_total, ref_items), ref_grads = jax.value_and_grad(jloss, has_aux=True)([jnp.asarray(m) for m in maps])
    leaves, pairs = _pairs(maps)
    total, items = tdet.v8_detection_loss(pairs, *map(torch.from_numpy, (lab, gt, mask)), STRIDES, NC, tal_topk=topk)
    _close(total, ref_total)
    for got, ref in zip(items, ref_items):
        assert not got.requires_grad
        _close(got, ref)
    assert float(items.box) > 0  # some anchors were assigned
    total.backward()
    _grad_close(leaves, ref_grads)


def test_v10_detect_loss_matches_jax():
    _, _, _, lab, gt, mask = _assigner_case()
    om, oo = _head_maps(4), _head_maps(5)
    args = tuple(map(jnp.asarray, (lab, gt, mask)))

    def jloss(p):
        return jdet.v10_detect_loss(p, *args, STRIDES, NC)

    jp = {"one2many": [jnp.asarray(m) for m in om], "one2one": [jnp.asarray(m) for m in oo]}
    (ref_total, ref_items), ref_grads = jax.value_and_grad(jloss, has_aux=True)(jp)
    l_om, p_om = _pairs(om)
    l_oo, p_oo = _pairs(oo)
    total, items = tdet.v10_detect_loss({"one2many": p_om, "one2one": p_oo},
                                        *map(torch.from_numpy, (lab, gt, mask)), STRIDES, NC)
    assert items.shape == (6,) and not items.requires_grad
    _close(total, ref_total)
    _close(items, ref_items)
    total.backward()
    _grad_close(l_om, ref_grads["one2many"])
    _grad_close(l_oo, ref_grads["one2one"])


def test_loss_on_a_batch_without_gts_is_finite():
    """No gt anywhere: target_scores_sum clamps at 1, box and dfl are 0, cls is the plain BCE sum."""
    maps = _head_maps(6)  # the shapes of the other tests, so JAX reuses what it compiled for them
    lab, gt, mask = np.zeros((3, 5), np.int32), np.zeros((3, 5, 4), np.float32), np.zeros((3, 5), bool)
    ref_total, ref_items = jdet.v8_detection_loss([jnp.asarray(m) for m in maps], *map(jnp.asarray, (lab, gt, mask)),
                                                  STRIDES, NC)
    _, pairs = _pairs(maps)
    total, items = tdet.v8_detection_loss(pairs, *map(torch.from_numpy, (lab, gt, mask)), STRIDES, NC)
    _close(total, ref_total)
    assert float(items.box) == 0.0 and float(items.dfl) == 0.0 and np.isfinite(float(total.detach()))
    _close(items.cls, ref_items.cls)
