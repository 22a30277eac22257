"""RT-DETR training of the port against the JAX package (`lpc_yolo_tpu/losses/detr.py`, the decoder's train branch
in `lpc_yolo_tpu/nn/transformer.py`, the "rtdetr" loss of `lpc_yolo_tpu/engine/train_step.py`), on the CPU.

Inputs are seeded numpy arrays; weights come from `random_variables` through the weight bridge. Tolerances:

* GIoU (`bbox_iou(GIoU=True)`) within 1e-6; the focal class cost and the matching cost within 1e-6 of each entry's
  magnitude (the cost is JAX's own, read where it reaches the host).
* `hungarian_match` equal to JAX's on inputs whose assignment is unique by a wide margin (six queries sit on the
  ground truths, the rest far off), -1 on padded ground truths; the (L, B) problems of several layers solved
  through one host transfer equal to one call per layer. scipy sees the port's f32 costs and JAX's, which can
  differ by an ulp, so on near-tied random costs the two may pick different assignments; the losses are
  therefore held with the match injected.
* `get_cdn_attn_mask` equal for G = 12 (M = 8) and G = 1 (M = 128); `get_cdn_group` with JAX's four draws
  injected within 1e-6 (embeddings, box logits; zeros in the padded slots).
* The decoder's train branch (the tiny decoder of `tests/test_tasks.py`: hd 64, nq 60, ndp 4, nh 4, ndl 2,
  d_ffn 256, 80 classes, over maps of a 64 px frame, 8 ground-truth slots: 192 denoising queries) on the same
  weights, draws and matches: the output tree within 1e-4, `detr_loss`, `detr_loss_fixed_match` and
  `rtdetr_loss` on the same outputs within 1e-5 relative, and the gradient of the whole loss against
  `jax.value_and_grad` of the JAX decoder and `rtdetr_loss`: within 1e-5 of each leaf's largest value of the
  port's f32 gradient, and both within 2e-3 of the port's f64 run's. The JAX side is jitted with XLA's fusion pass
  off: the decoder and the loss compile in ~13 s, where running them eagerly takes ~35 s (every primitive compiled
  on first use). No JAX train step of a whole RT-DETR graph is compiled here.
* The +inf logits of the anchors outside the valid band, selected: boxes of exactly 1, the loss and every gradient
  finite, in f32 and under bf16 autocast.
* A train step of the tiny RT-DETR YAML (yolov8n-rtdetr with that decoder, 64 px, batch 2) with SGD and with
  AdamW: loss and items of the f32 step within 2e-5 relative of the port's f64 step on the same matches, its
  first moment after the step within 2e-3 of each leaf's largest value and SGD's parameters within 2e-4 (the box
  heads calmed); the optimizer alone on that graph's tree within 2e-6 of optax's chain (the JAX `make_optimizer`)
  over three updates.
* The weight decay: the port decays exactly the JAX `_decay_mask` leaves on rtdetr-l's whole tree (from
  `jax.eval_shape`), so neither `denoising_class_embed` nor the attention projections' (nh, hd) biases decay;
  a step with zero gradients leaves them where they were while the kernels shrink.
* `YOLO(<tiny RT-DETR>).train(data=...)` on a synthetic set: results.csv with train/cls, train/l1 and
  train/giou, and a run stopped in its second epoch and resumed equal to the uninterrupted run bit for bit (the
  denoising draws are keyed by the step's count).
"""

import signal

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.losses import detr as JD
from lpc_yolo_tpu.nn import transformer as JT
from lpc_yolo_tpu.ops.boxes import bbox_iou as jax_bbox_iou

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import make_synthetic_dataset
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.losses import detr as TD
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import transformer as TT
from lpc_yolo_tpu_torch.ops.boxes import bbox_iou
from lpc_yolo_tpu_torch.utils.flax_bridge import (_flax_slot, flax_shapes, flax_to_state_dict, is_flax_kernel,
                                                  load_flax, random_variables, train_state_dict)
from test_torch_ckpt import assert_trees_equal
from test_torch_rtdetr import calm_boxes, small
from test_torch_train import XLA_OPTS, assert_named_close
from test_torch_zoo import S, jax_graph

NC = 80
LEVELS, CH = [(8, 8), (4, 4), (2, 2)], (32, 48, 64)  # a 64 px frame's P3 to P5
TINY = dict(nc=NC, ch=CH, hd=64, nq=60, ndp=4, nh=4, ndl=2, d_ffn=256)
B, M = 2, 8  # 8 ground-truth slots: G = 100 // 8 = 12 denoising groups
STEP = 3  # the train step whose key the denoising draws come from


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are small: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x, dtype=None):
    x = torch.from_numpy(np.asarray(x).copy())
    return x if dtype is None else x.to(dtype)


def cxcywh_n(boxes_px):
    return np.concatenate([(boxes_px[..., :2] + boxes_px[..., 2:]) / 2, boxes_px[..., 2:] - boxes_px[..., :2]],
                          -1) / np.float32(S)


def gts(seed: int, b: int = B, m: int = M, nc: int = NC, counts=(5, 2)):
    """(cls (b, m) int32, xyxy pixel boxes (b, m, 4) f32, mask (b, m)): the first counts[i] slots of image i."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 40, (b, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(6, 24, (b, m, 2))], -1).astype(np.float32)
    mask = np.arange(m)[None] < np.asarray(counts)[:, None]
    return rng.integers(0, nc, (b, m)).astype(np.int32), boxes * mask[..., None], mask


def jax_draws(key, b: int, g: int, m: int, nc: int):
    """The four draws of the JAX `get_cdn_group` (:123-136) from its key, as torch tensors."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    shape = (b, 2 * g, m)
    draws = {"flip": jax.random.uniform(k1, shape), "label": jax.random.randint(k2, shape, 0, nc),
             "sign": jax.random.randint(k3, shape + (4,), 0, 2) * 2.0 - 1.0,
             "part": jax.random.uniform(k4, shape + (4,))}
    return {k: t(v) for k, v in draws.items()}


def recording_lsa(monkeypatch):
    """Record every assignment the JAX package's host solver returns, in call order."""
    seen, real = [], JD._lsa_host

    def record(cost, n_valid):
        out = real(cost, n_valid)
        seen.append((np.array(cost), out))
        return out

    monkeypatch.setattr(JD, "_lsa_host", record)
    return seen


def injected_jax_matches(monkeypatch, matches):
    """The JAX `hungarian_match` replaced by the given (B, M) matches, handed out in call order."""
    it = iter(matches)
    monkeypatch.setattr(JD, "hungarian_match", lambda *a, **k: jnp.asarray(next(it)))


def jit_np(fn, *args):
    """`fn(*args)` compiled with XLA's fusion pass off, as numpy."""
    out = jax.jit(fn).lower(*args).compile(compiler_options=XLA_OPTS)(*args)
    return jax.tree.map(np.asarray, out)


# -- boxes and costs ------------------------------------------------------------------------------------------------


def random_boxes(rng, shape):
    """cxcywh boxes in (0, 1), some overlapping, some apart."""
    c = rng.uniform(0.1, 0.9, shape + (2,))
    return np.concatenate([c, rng.uniform(0.02, 0.5, shape + (2,))], -1).astype(np.float32)


@pytest.mark.parametrize("xywh", [True, False])
def test_giou_matches_jax(xywh):
    """`bbox_iou(..., GIoU=True)` of 2 x 30 box pairs broadcast against 7 (disjoint, nested and overlapping pairs)
    against the JAX `bbox_iou(GIoU=True)` within 1e-6, in cxcywh and in xyxy; disjoint pairs go below 0."""
    rng = np.random.default_rng(1)
    a, b = random_boxes(rng, (2, 30, 1)), random_boxes(rng, (1, 1, 7))
    if not xywh:
        a, b = (np.concatenate([x[..., :2] - x[..., 2:] / 2, x[..., :2] + x[..., 2:] / 2], -1) for x in (a, b))
    ref = np.asarray(jax_bbox_iou(jnp.asarray(a), jnp.asarray(b), xywh=xywh, GIoU=True))
    got = bbox_iou(t(a), t(b), xywh=xywh, GIoU=True).numpy()
    assert got.shape == ref.shape == (2, 30, 7, 1) and ref.min() < 0
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_focal_cost_and_matching_cost_match_jax(monkeypatch):
    """`_focal_class_cost` of (2, 40, 6) scores against JAX's within 1e-6, and the whole matching cost (2 * focal + 5 *
    L1 + 2 * (1 - GIoU); one prediction box non-finite, whose cost is 1e6) against the cost that the JAX
    `hungarian_match` hands its host solver, within 1e-6 of each entry's magnitude."""
    rng = np.random.default_rng(2)
    scores = rng.uniform(0.01, 0.99, (2, 40, 6)).astype(np.float32)
    cls = rng.integers(0, 6, (2, 5)).astype(np.int32)
    ref = np.asarray(JD._focal_class_cost(jnp.asarray(scores), jnp.asarray(cls)))
    got = TD._focal_class_cost(t(scores), t(cls)).numpy()
    assert got.shape == ref.shape == (2, 40, 5)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    boxes, logits = random_boxes(rng, (2, 40)), rng.standard_normal((2, 40, 6)).astype(np.float32) * 3
    boxes[1, 7] = np.inf
    gt, mask = random_boxes(rng, (2, 5)), np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    seen = recording_lsa(monkeypatch)
    JD.hungarian_match(jnp.asarray(boxes), jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(cls), jnp.asarray(mask))
    cost = TD.match_cost(t(boxes), t(logits), t(gt), t(cls)).numpy()
    assert cost.shape == seen[0][0].shape == (2, 40, 5) and np.all(cost[1, 7] == 1e6)
    np.testing.assert_allclose(cost, seen[0][0], rtol=1e-6, atol=1e-6)


def separated_layers(L: int, seed: int):
    """L layers' predictions (L, 2, 20, 4 | 5) whose assignment is unique by a wide margin: in each layer and image
    a permutation of queries sits on the valid ground truths with confident right classes, every other query is
    a tiny box in the far corner with a low score."""
    rng = np.random.default_rng(seed)
    gt, cls = random_boxes(rng, (2, 6)), rng.integers(0, 5, (2, 6)).astype(np.int32)
    mask = np.arange(6)[None] < np.array([[6], [3]])
    boxes = np.tile(np.array([0.98, 0.98, 0.01, 0.01], np.float32), (L, 2, 20, 1))
    logits = np.full((L, 2, 20, 5), -6.0, np.float32)
    for layer in range(L):
        for b in range(2):
            q = rng.permutation(20)[:6]
            boxes[layer, b, q] = gt[b] + rng.uniform(-0.01, 0.01, (6, 4)).astype(np.float32)
            logits[layer, b, q, cls[b]] = 6.0
    return boxes, logits, gt, cls, mask


def test_hungarian_match_matches_jax_and_batches_the_layers(monkeypatch):
    """On margin-separated inputs the port's `hungarian_match` equals the JAX one image by image, with -1 at the
    padded ground truths; three layers matched at once make one host solve of 3 x 2 problems (one transfer each
    way) and equal the three layers matched one by one."""
    boxes, logits, gt, cls, mask = separated_layers(3, seed=3)
    ref = [np.asarray(JD.hungarian_match(*map(jnp.asarray, (boxes[i], logits[i], gt, cls, mask)))) for i in range(3)]
    solves = []
    real = TD._lsa_host
    monkeypatch.setattr(TD, "_lsa_host", lambda c, n: solves.append(c.shape) or real(c, n))
    together = TD.hungarian_match(t(boxes), t(logits), t(gt), t(cls), t(mask))
    assert solves == [(6, 20, 6)] and together.shape == (3, 2, 6) and together.dtype == torch.int64
    for i in range(3):
        alone = TD.hungarian_match(t(boxes[i]), t(logits[i]), t(gt), t(cls), t(mask))
        np.testing.assert_array_equal(alone.numpy(), ref[i])
        np.testing.assert_array_equal(together[i].numpy(), ref[i])
    assert np.all(ref[0][1, 3:] == -1) and np.all(ref[0][0] >= 0)


# -- contrastive denoising ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("m,g", [(8, 12), (128, 1)])
def test_cdn_attn_mask_matches_jax(m, g):
    """The denoising attention mask (True = blocked) for G = 100 // M groups and 60 matching queries equals the
    JAX one: G = 12 at M = 8 (the 2M-wide group stripes), G = 1 at M = 128 (rtdetr-l's 256 denoising queries)."""
    ref = JD.get_cdn_attn_mask(m, g, 60)
    got = TD.get_cdn_attn_mask(m, g, 60).numpy()
    assert got.shape == ref.shape == (2 * g * m + 60,) * 2
    np.testing.assert_array_equal(got, ref)
    assert not got.all(-1).any()  # no query is blocked from everything


@pytest.mark.parametrize("m", [8, 50])
def test_cdn_group_matches_jax(m):
    """`get_cdn_group` with the JAX key's four draws injected equals the JAX group within 1e-6: the embeddings
    (rows of the class table), the noised boxes' logits, the mask and G; the padded slots keep zero embeddings
    and zero logits in every group. Drawn from the port's generator instead, the group has the same shapes and
    zeros, the same step gives the same draws and another step others."""
    cls, boxes, mask = gts(4, m=m, counts=(5, 2))
    table = np.random.default_rng(5).standard_normal((NC, 16)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(42), STEP)
    g = max(1, 100 // m)
    ref = JD.get_cdn_group(jnp.asarray(cls), jnp.asarray(cxcywh_n(boxes)), jnp.asarray(mask), NC, jnp.asarray(table),
                           key, num_queries=60)
    args = (t(cls), t(cxcywh_n(boxes)), t(mask), NC, t(table), 60)
    got = TD.get_cdn_group(*args, draws=jax_draws(key, B, g, m, NC))
    assert got[3] == ref[3] == g
    for a, b in zip(got[:2], ref[:2]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    padded = ~np.tile(mask, (1, 2 * g))
    assert np.all(got[0].numpy()[padded] == 0) and np.all(got[1].numpy()[padded] == 0)
    assert (np.abs(got[0].numpy()[~padded]).max(-1) > 0).all()
    draw = lambda step: TD.get_cdn_group(*args, generator=TD.dn_generator(step, "cpu"))  # noqa: E731
    a, b, c = draw(STEP), draw(STEP), draw(STEP + 1)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])) and not torch.equal(a[1], c[1])
    assert a[0].shape == got[0].shape and np.all(a[1].numpy()[padded] == 0)


# -- the decoder's train branch and the losses ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoder_run():
    """The JAX tiny decoder in train mode (dn from the key of step STEP) and `rtdetr_loss` on its outputs, with
    `jax.value_and_grad` over the parameters, jitted once; the assignments its host solver returned (the decoder's
    two layers, then the encoder head), in call order."""
    rng = np.random.default_rng(0)
    maps = [rng.standard_normal((B, h, w, c)).astype(np.float32) for (h, w), c in zip(LEVELS, CH)]
    cls, boxes, mask = gts(6)
    jm = JT.RTDETRDecoder(**TINY)
    xs = [jnp.asarray(x) for x in maps]
    variables = random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), xs, training=True)), seed=0)
    key = jax.random.fold_in(jax.random.PRNGKey(42), STEP)
    dn = {"cls": jnp.asarray(cls), "bboxes": jnp.asarray(cxcywh_n(boxes)), "mask": jnp.asarray(mask), "key": key}

    def loss(params, xs):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, xs, training=True, dn=dn,
                          mutable=["batch_stats"])
        total, items = JD.rtdetr_loss(out, jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), (S, S))
        return total, (out, items)

    seen = []
    real = JD._lsa_host
    JD._lsa_host = lambda c, n: seen.append((np.array(c), real(c, n))) or seen[-1][1]
    try:
        (total, (out, items)), grads = jit_np(jax.value_and_grad(loss, has_aux=True), variables["params"], xs)
    finally:
        JD._lsa_host = real
    # the compiled step runs its host callbacks in an order of its own: each layer's assignment is the one
    # solved on that layer's cost (the port's cost of the JAX outputs, within an ulp of JAX's)
    nd = int(out["dn_split"])
    layers = [(out["dec_bboxes"][i, :, nd:], out["dec_scores"][i, :, nd:]) for i in range(TINY["ndl"])]
    layers.append((out["enc_bboxes"], out["enc_scores"]))
    matches = []
    for b, s in layers:
        cost = TD.match_cost(t(b), t(s), t(cxcywh_n(boxes)), t(cls)).numpy()
        errs = [np.abs(c - cost).max() for c, _ in seen]
        assert min(errs) < 1e-3 < sorted(errs)[1]
        matches.append(seen[int(np.argmin(errs))][1])
    assert len(seen) == TINY["ndl"] + 1
    return {"maps": maps, "gts": (cls, boxes, mask), "variables": variables, "total": total, "items": items,
            "out": out, "grads": grads, "matches": np.stack(matches), "draws": jax_draws(key, B, 100 // M, M, NC)}


def port_decoder_run(run, dtype):
    """The port's tiny decoder in train mode on the run's maps, draws and matches, in `dtype`: (output tree, total,
    items, gradients by state_dict name)."""
    tm = TT.RTDETRDecoder(**TINY)
    tm.load_state_dict(flax_to_state_dict(run["variables"]), strict=True)
    tm = tm.to(dtype).train()
    cls, boxes, mask = run["gts"]
    dn = {"cls": t(cls), "bboxes": t(cxcywh_n(boxes), dtype), "mask": t(mask), "draws": run["draws"]}
    out = tm([t(x.transpose(0, 3, 1, 2), dtype) for x in run["maps"]], dn=dn)
    total, items = TD.rtdetr_loss(out, t(cls), t(boxes), t(mask), (S, S), matches=t(run["matches"]).long())
    total.backward()
    return out, total, items, {k: p.grad for k, p in tm.named_parameters()}


def test_decoder_train_branch_matches_jax(decoder_run):
    """The port's decoder in train mode on the JAX run's weights, draws and matches: the output tree (192
    denoising queries first, then the 60 selected) within 1e-4 of JAX's, `dn_split` and `dn_group` equal; the
    loss and its items within 1e-5 relative; the gradient of every parameter (the encoder head through the
    encoder's boxes and scores only, the denoising table through its queries): JAX's within 1e-5 of each leaf's
    largest value of the port's f32 gradient, both within 2e-3 of the port's f64 run's (the sampler's bilinear
    weights have kinks at the pixel centres, and f32 rounding moves a few sampling points across one: 1.1e-3 on
    `sampling_offsets`, alike in both packages), floor 1e-6 (the key projection's bias has a zero gradient,
    which f32 leaves at ~3e-7)."""
    run = decoder_run
    out, total, items, g32 = port_decoder_run(run, torch.float32)
    ref = run["out"]
    assert (out["dn_split"], out["dn_group"]) == (ref["dn_split"], ref["dn_group"]) == (2 * 12 * M, 12)
    for k in ("dec_bboxes", "dec_scores", "enc_bboxes", "enc_scores"):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].detach().numpy(), ref[k], atol=1e-4, rtol=0, err_msg=k)
    assert out["dec_bboxes"].shape == (2, B, 2 * 12 * M + 60, 4)
    np.testing.assert_allclose(float(total), float(run["total"]), rtol=1e-5)
    np.testing.assert_allclose(items.numpy(), run["items"], rtol=1e-5)
    _, total64, _, g64 = port_decoder_run(run, torch.float64)
    np.testing.assert_allclose(float(total64), float(run["total"]), rtol=1e-5)
    jg = flax_to_state_dict({"params": run["grads"]})
    assert jg.keys() == g64.keys() and all(g is not None for g in g64.values())
    for k in ("denoising_class_embed", "enc_score_head.weight", "enc_output.0.weight", "input_proj.0.0.weight",
              "decoder_layers.0.self_attn.query.bias", "dec_score_head.0.weight"):
        assert float(g64[k].abs().max()) > 0, k
    assert_named_close(jg, g32, 1e-5, "JAX gradient against the port's of", floor=1e-6)
    assert_named_close(g32, g64, 2e-3, "f32 gradient against f64 of", floor=1e-6)
    assert_named_close(jg, g64, 2e-3, "JAX gradient against the port's f64 of", floor=1e-6)


def test_losses_on_the_same_outputs_match_jax(decoder_run, monkeypatch):
    """`detr_loss` (the decoder's matched queries), `detr_loss_fixed_match` (the denoising group) and `rtdetr_loss`
    of the JAX decoder's own outputs, with the JAX run's matches injected into both packages: within 1e-5
    relative of the JAX functions, and the three parts sum to the total."""
    run = decoder_run
    cls, boxes, mask = run["gts"]
    out = {k: (t(v) if isinstance(v, np.ndarray) and v.ndim else int(v)) for k, v in run["out"].items()}
    gt = cxcywh_n(boxes)
    nd = out["dn_split"]
    jout = {k: jnp.asarray(v) for k, v in run["out"].items() if k not in ("dn_split", "dn_group")}
    injected_jax_matches(monkeypatch, list(run["matches"][:2]))
    dec_ref = jit_np(lambda b, s: JD.detr_loss(b, s, jnp.asarray(gt), jnp.asarray(cls), jnp.asarray(mask)),
                     jout["dec_bboxes"][:, :, nd:], jout["dec_scores"][:, :, nd:])
    dec = TD.detr_loss(out["dec_bboxes"][:, :, nd:], out["dec_scores"][:, :, nd:], t(gt), t(cls), t(mask),
                       match=t(run["matches"][:2]).long())
    np.testing.assert_allclose(float(dec[0]), float(dec_ref[0]), rtol=1e-5)
    np.testing.assert_allclose(dec[1].numpy(), dec_ref[1], rtol=1e-5)
    jgt = (jnp.asarray(gt), jnp.asarray(cls), jnp.asarray(mask))
    dn_ref = jit_np(lambda b, s: JD.detr_loss_fixed_match(b, s, *jgt, 12), jout["dec_bboxes"][:, :, :nd],
                    jout["dec_scores"][:, :, :nd])
    dn = TD.detr_loss_fixed_match(out["dec_bboxes"][:, :, :nd], out["dec_scores"][:, :, :nd], t(gt), t(cls), t(mask),
                                  12)
    np.testing.assert_allclose(float(dn), float(dn_ref), rtol=1e-5)
    enc, _ = TD.detr_loss(out["enc_bboxes"][None], out["enc_scores"][None], t(gt), t(cls), t(mask),
                          match=t(run["matches"][2:]).long())
    total, items = TD.rtdetr_loss(out, t(cls), t(boxes), t(mask), (S, S), matches=t(run["matches"]).long())
    np.testing.assert_allclose(float(total), float(run["total"]), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(dec[0] + enc + dn), rtol=1e-6)
    np.testing.assert_allclose(items.numpy(), dec[1].numpy(), rtol=0)


@pytest.mark.parametrize("autocast", [False, True])
def test_invalid_anchors_keep_the_loss_and_its_gradient_finite(autocast):
    """A decoder whose queries include the anchors outside the valid band (a 2 x 60 level: its first and last
    columns; nq 300 over 165 anchors keeps all 4): their `+inf` logits give encoder boxes of exactly 1 and first
    reference boxes of 1, and the loss (own matching, 4 ground-truth slots: 50 groups) and every gradient stay
    finite, in f32 and under bf16 autocast."""
    levels, ch = [(2, 60), (1, 30), (1, 15)], (16, 24, 32)
    torch.manual_seed(0)
    tm = TT.RTDETRDecoder(nc=5, ch=ch, hd=32, nq=300, ndp=2, nh=4, ndl=2, d_ffn=64).train()
    rng = np.random.default_rng(9)
    xs = [t(rng.standard_normal((2, c, h, w)).astype(np.float32)) for (h, w), c in zip(levels, ch)]
    cls, boxes, mask = gts(10, m=4, nc=5, counts=(3, 1))
    dn = {"cls": t(cls), "bboxes": t(cxcywh_n(boxes)), "mask": t(mask), "generator": TD.dn_generator(0, "cpu")}
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        out = tm(xs, dn=dn)
        with torch.no_grad():
            select = TT.select_topk(tm.encode(xs)[-1].amax(-1), 165)
    out = {k: v.float() if torch.is_tensor(v) else v for k, v in out.items()}
    _, valid = TT.make_anchors(levels, "cpu")
    assert out["enc_bboxes"].shape == (2, 165, 4) and int((~valid).sum()) == 4
    invalid = ~valid[:, 0][select]  # (B, 165): where the selection put the invalid anchors
    assert invalid.sum() == 8 and torch.all(out["enc_bboxes"][invalid] == 1)
    total, items = TD.rtdetr_loss(out, t(cls), t(boxes), t(mask), (S, S))
    total.backward()
    assert torch.isfinite(total) and torch.isfinite(items).all()
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters() if p.grad is not None)
    assert tm.denoising_class_embed.grad.abs().max() > 0


# -- the train step and the weight decay ----------------------------------------------------------------------------


def tiny_yaml(nc: int = 4) -> dict:
    return small("v8/yolov8-rtdetr.yaml", nc=nc)


def tiny_batch(seed: int) -> dict:
    cls, boxes, mask = gts(seed, m=4, nc=4, counts=(3, 1))
    rng = np.random.default_rng(seed + 100)
    return {"img": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8), "cls": cls, "bboxes": boxes, "mask": mask}


@pytest.fixture(scope="module")
def tiny():
    """The tiny YAML, its seeded variables and those with the box heads calmed (`calm_boxes`)."""
    d = tiny_yaml()
    tm = build_model(d, device="cpu")
    variables = random_variables(flax_shapes(tm), seed=1)
    return d, variables, calm_boxes(variables, f"model_{len(tm.model) - 1}")


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_tiny_train_step_f32_matches_f64(tiny, opt, monkeypatch):
    """One train step (loss_kind "rtdetr") of the tiny RT-DETR YAML, in f32 from uint8 frames and in f64 from the
    same frames in f64, from the same weights, the f64 step fed the f32 step's matches: loss and items within 2e-5
    relative; the first moment (the clipped gradient, with SGD's decay) within 2e-3 of each leaf's largest value, as
    `tests/test_torch_v9_train.py` holds the f32 trace, and the parameters after an SGD update (AdamW's second
    moment, the gradient squared) within 2e-4 (4e-3); BN statistics within 1e-5; every leaf finite; the step's
    denoising draws are those of its count (the same at step 0 in both runs). The box heads are calmed
    (`tests/test_torch_rtdetr.py::calm_boxes`): with the seeded deltas most boxes saturate at 0 or 1, where f32's
    sigmoid and the clamp of `inverse_sigmoid` cut gradients that f64 keeps (5e-3 of the query-position head's
    largest value)."""
    d, _, variables = tiny
    cfg = tts.OptConfig(warmup_steps=2, total_steps=10, optimizer=opt, **({"lr0": 0.002, "momentum": 0.9}
                                                                           if opt == "adamw" else {}))
    batch = tiny_batch(7)
    solved, real = [], TD._lsa_host
    runs = {}
    for dtype in (torch.float32, torch.float64):
        tm = load_flax(build_model(d, device="cpu"), variables).to(dtype)
        state = tts.init_train_state(tm, cfg, device="cpu")
        state.opt_step = 1  # past the first update, which moves nothing (lr 0 at count 0)
        step = tts.make_train_step(tm, cfg, loss_kind="rtdetr")
        if dtype == torch.float32:
            monkeypatch.setattr(TD, "_lsa_host", lambda c, n: solved.append(real(c, n)) or solved[-1])
        else:
            monkeypatch.setattr(TD, "_lsa_host", lambda c, n: solved[0])
        # f64: the same frames as f64 RGB in [0, 1], what the step makes of uint8 BGR in f32
        img = batch["img"] if dtype == torch.float32 else batch["img"][..., ::-1].astype(np.float64) / 255
        state, met = step(state, {**batch, "img": img})
        assert not met["skipped"] and met["items"].shape == (3,)
        runs[dtype] = (state, met)
    (s32, m32), (s64, m64) = runs[torch.float32], runs[torch.float64]
    np.testing.assert_allclose(float(m32["loss"]), float(m64["loss"]), rtol=2e-5)
    np.testing.assert_allclose(m32["items"].numpy(), m64["items"].numpy(), rtol=2e-5)
    assert_named_close(s32.momentum, s64.momentum, 2e-3, "first moment of", floor=1e-7)
    if opt == "sgd":  # AdamW's update is m / sqrt(v): ~lr whatever the size of a gradient entry, f32 noise too
        assert_named_close(s32.params, s64.params, 2e-4, "param after the step", floor=1e-7)
    else:
        assert_named_close(s32.nu, s64.nu, 4e-3, "second moment of", floor=1e-12)
    assert_named_close(s32.batch_stats, s64.batch_stats, 1e-5, "BN statistic", floor=1e-6)
    assert all(torch.isfinite(p).all() for p in s32.params.values())


def optax_chain(params, jcfg):
    import optax

    tx = jts.make_optimizer(params, jcfg)

    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return tx, update


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_optimizer_matches_optax_on_the_rtdetr_tree(tiny, opt):
    """The optimizer alone on the tiny RT-DETR tree (3-D attention kernels, their (nh, hd) biases, LayerNorms,
    `denoising_class_embed`): three updates of seeded gradients through the JAX `make_optimizer` chain (its
    `_decay_mask`) and through `apply_update`, params and the first moment within 2e-6 of each leaf's largest
    value. The first gradients are clipped, the last are not."""
    d, variables, _ = tiny
    kw = {"lr0": 0.002, "momentum": 0.9} if opt == "adamw" else {}
    jcfg, tcfg = (m.OptConfig(warmup_steps=2, total_steps=10, optimizer=opt, **kw) for m in (jts, tts))
    params = variables["params"]
    tx, update = optax_chain(params, jcfg)
    update = jax.jit(update).lower(params, tx.init(params), params).compile(compiler_options=XLA_OPTS)
    opt_state = tx.init(params)
    state = tts.init_train_state(load_flax(build_model(d, device="cpu"), variables), tcfg, device="cpu")
    rng = np.random.default_rng(8)
    for scale in (3.0, 1.0, 1e-3):
        grads = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), params)
        params, opt_state = update(grads, opt_state, params)
        named = flax_to_state_dict({"params": grads})
        tgrads = [named[k].clone() for k in state.params]
        tts.apply_update(state, tgrads, tts.global_norm(tgrads), tcfg)
        assert_named_close(state.params, flax_to_state_dict({"params": jax.tree.map(np.asarray, params)}), 2e-6,
                           f"scale {scale} param")
        first = opt_state[1][0].mu if opt == "adamw" else opt_state[2].inner_state.trace
        assert_named_close(state.momentum, flax_to_state_dict({"params": jax.tree.map(np.asarray, first)}), 2e-6,
                           f"scale {scale} first moment")


def test_decay_mask_matches_jax_on_rtdetr_l():
    """On rtdetr-l's whole tree (`jax.eval_shape` of the JAX graph) the port decays exactly the parameters whose
    JAX `_decay_mask` leaf is True: conv and Linear weights and the attention's 3-D kernels; not
    `denoising_class_embed` (nc, hd), not the attention's (nh, hd) query/key/value biases, not a norm's scale."""
    yolo = YOLO("rtdetr-l.yaml", device="meta", seed=None)
    jm = jax_graph(yolo.model_yaml, yolo.model.strides)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))
    mask = jts._decay_mask(shapes["params"])
    n_true = sum(bool(v) for v in jax.tree.leaves(mask))
    port = {}
    for name, p in yolo.model.named_parameters():
        node = mask
        for k in _flax_slot(name, p.dim())[1]:
            node = node[k]
        assert is_flax_kernel(name, p.dim()) == node, name
        port[name] = node
    assert len(port) == len(jax.tree.leaves(mask)) and sum(port.values()) == n_true
    head = f"model.{len(jm.specs) - 1}"
    assert not port[f"{head}.denoising_class_embed"] and not port[f"{head}.decoder_layers.0.self_attn.key.bias"]
    aifi = next(n for n, m in yolo.model.named_modules() if type(m).__name__ == "AIFI")
    assert port[f"{head}.decoder_layers.0.self_attn.key.weight"] and port[f"{aifi}.enc.ma.out.weight"]
    assert not port[f"{aifi}.enc.ma.query.bias"]
    assert any(p.dim() == 2 and not port[n] for n, p in yolo.model.named_parameters())  # the old rule would decay


def test_zero_gradient_step_decays_only_the_kernels(tiny):
    """An update with zero gradients (SGD and AdamW, past warmup's zero learning rate): the kernels shrink by
    lr * weight_decay (times 1 + momentum under SGD's Nesterov step), while `denoising_class_embed`, the
    attention's (nh, hd) biases, the other biases and the norm scales stay exactly where they were."""
    d, variables, _ = tiny
    for opt in ("sgd", "adamw"):
        cfg = tts.OptConfig(warmup_steps=2, total_steps=10, optimizer=opt, weight_decay=0.05)
        state = tts.init_train_state(load_flax(build_model(d, device="cpu"), variables), cfg, device="cpu")
        state.opt_step = 3
        lr = tts.lr_at(3, cfg)
        shrink = 1 - lr * 0.05 * (1 if opt == "adamw" else 1 + tts.momentum_at(3, cfg))  # SGD: Nesterov's 1 + mu
        before = {k: p.detach().clone() for k, p in state.params.items()}
        grads = [torch.zeros_like(p) for p in state.params.values()]
        tts.apply_update(state, grads, tts.global_norm(grads), cfg)
        head = f"model.{len(d['backbone']) + len(d['head']) - 1}"
        still = [f"{head}.denoising_class_embed", f"{head}.decoder_layers.0.self_attn.value.bias"]
        assert all(before[k].dim() == 2 for k in still)
        for k, p in state.params.items():
            if is_flax_kernel(k, p.dim()):
                torch.testing.assert_close(p, before[k] * shrink, rtol=1e-6, atol=1e-9)
            else:
                assert torch.equal(p, before[k]), (opt, k)
        assert is_flax_kernel(f"{head}.decoder_layers.0.self_attn.value.weight", 3)


# -- training from a dataset ----------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_runs(tmp_path_factory):
    """`YOLO(<tiny RT-DETR>, nc=3).train(data=...)` for 2 epochs of 2 steps (8 frames, batch 4, 64 px, AdamW by the
    "auto" rule): once straight through, and once stopped (SIGTERM) in the first step of epoch 2 and resumed."""
    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    tmp = tmp_path_factory.mktemp("rtdetr_train")
    cfg = tmp / "yolov8n-rtdetr-tiny.yaml"
    cfg.write_text(yaml.safe_dump(tiny_yaml(nc=3)))
    data = make_synthetic_dataset(tmp / "data", n_train=8, n_val=4, imgsz=S, nc=3, max_boxes=4, seed=2)
    kw = dict(data=data, imgsz=S, batch=4, epochs=2, close_mosaic=1, workers=2, device="cpu")
    out = {"tmp": tmp}
    out["straight"] = YOLO(cfg, device="cpu", seed=0, nc=3)
    out["straight_results"] = out["straight"].train(save_dir=tmp / "straight", **kw)
    real_render, calls = port_trainer.render, []

    def stopping_render(plans, sources, device):
        calls.append(1)
        if len(calls) == 3:  # epoch 2, step 1: the step finishes, then the run stops
            signal.raise_signal(signal.SIGTERM)
        return real_render(plans, sources, device)

    try:
        port_trainer.render = stopping_render
        YOLO(cfg, device="cpu", seed=0, nc=3).train(save_dir=tmp / "stopped", **kw)
    finally:
        port_trainer.render = real_render
    out["resumed"] = YOLO(cfg, device="cpu", seed=0, nc=3)
    out["resumed"].train(save_dir=tmp / "stopped", resume=True, **kw)
    return out


def test_train_from_data_writes_the_detr_columns(data_runs):
    """The straight run: 4 steps, none skipped, every loss finite; results.csv has one row an epoch with
    train/cls, train/l1 and train/giou (the JAX trainer's names) and the validator's keys; last.ckpt and
    best.ckpt; the facade then holds the EMA weights and serves (B, nq, 6) rows."""
    yolo = data_runs["straight"]
    tr = yolo.trainer
    assert len(tr.history) == 4 and not any(h["skipped"] for h in tr.history)
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["items"]).all() for h in tr.history)
    rows = (data_runs["tmp"] / "straight" / "results.csv").read_text().splitlines()
    header = rows[0].split(",")
    assert len(rows) == 3 and header[:4] == ["epoch", "train/cls", "train/l1", "train/giou"]
    assert "metrics/mAP50(B)" in header and np.isfinite(list(data_runs["straight_results"].values())).all()
    assert sorted(p.name for p in (data_runs["tmp"] / "straight" / "weights").iterdir()) == ["best.ckpt",
                                                                                             "last.ckpt"]
    for k, v in tr.state.ema_params.items():
        assert torch.equal(yolo.model.state_dict()[k], v)
    frame = np.random.default_rng(3).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    res = yolo.predict([frame], imgsz=S, conf=0.0, device="cpu")
    assert res[0].boxes.data.shape == (60, 6) and np.isfinite(res[0].boxes.data).all()


def test_resumed_run_equals_the_uninterrupted_run(data_runs):
    """Stopped in epoch 2 and resumed from last.ckpt (epoch 1), the run ends in the uninterrupted run's state bit
    for bit: parameters (the denoising table, the attention's 3-D kernels and (nh, hd) biases, the LayerNorms),
    BN statistics, AdamW's two moments and the EMA, through the `.ckpt` tree; the resumed epoch's denoising
    draws are those of its steps' counts."""
    ref, resumed = data_runs["straight"].trainer, data_runs["resumed"].trainer
    assert resumed.start_epoch == 1 and [h["epoch"] for h in resumed.history] == [1, 1]
    assert (resumed.state.step, resumed.state.opt_step) == (ref.state.step, ref.state.opt_step) == (4, 4)
    assert ref.cfg.optimizer == "adamw"
    assert_trees_equal(train_state_dict(resumed.state, resumed.cfg), train_state_dict(ref.state, ref.cfg))
    assert [h["items"] for h in resumed.history] == [h["items"] for h in ref.history[2:]]
