"""The port's pose data path, loss and training against the JAX package, on the CPU.

* `YOLODataset` with `kpt_shape`: pose rows (4 + K * ndim values), box rows
  and polygon rows (zero keypoints) equal to the JAX dataset's labels, and
  the label cache written by either package read by the other.
* `PoseTrainTransforms` (plan + CPU render) against the JAX
  `PoseTrainTransforms` on the same files and `RandomState` seeds: images,
  classes, boxes, mask and keypoints bit for bit, mosaic on and off, both
  flips, rotation and shear, K = 17 with `COCO_FLIP_IDX` and K = 4 with a
  `flip_idx` from the data YAML; points the warp pushes off the canvas come
  out invisible. The loader ships the keypoints with the batch.
* `kpt_iou_np` equals the JAX one bit for bit.
* `v8_pose_loss`: total and the five items (box, pose, kobj, cls, dfl) rtol
  1e-5 / atol 1e-6 (the v8 loss's) for kpt_shape (17, 3) and (5, 2), the
  port's f32 gradients within 1e-4 of the largest of its f64 run's; and a
  case whose 160 foreground anchors tie in runs of 16 across the budget of
  64, where the stable sort keeps `lax.top_k`'s order.
* One train step of a narrow yolov8n-pose against the JAX step (loss_kind
  "pose"), at the tolerances of `tests/test_torch_v8.py`.
* `train(data=...)` of a narrow yolov8n-pose on a keypoint-labelled set: the
  five loss items, the validator's (P) keys, results.csv in the JAX
  trainer's columns (with stub steps and validations, as
  `tests/test_torch_seg_data.py`), and its `.ckpt` files read by the JAX
  package with task "pose".
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.data import YOLODataset as JaxDataset
from lpc_yolo_tpu.data.augment import COCO_FLIP_IDX as JAX_COCO_FLIP_IDX
from lpc_yolo_tpu.data.augment import PoseTrainTransforms as JaxPoseTrainTransforms
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.losses.pose import OKS_SIGMA as JAX_OKS_SIGMA
from lpc_yolo_tpu.losses.pose import v8_pose_loss as jax_pose_loss
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.utils.metrics import kpt_iou_np as jax_kpt_iou_np

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import (DataLoader, PoseTrainTransforms, YOLODataset, check_det_dataset,
                                     make_synthetic_dataset)
from lpc_yolo_tpu_torch.data.augment import COCO_FLIP_IDX
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.losses import OKS_SIGMA, v8_pose_loss
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_to_state_dict, load_flax, random_variables
from lpc_yolo_tpu_torch.utils.metrics import kpt_iou_np

ROOT = Path(__file__).resolve().parents[1]
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v8"
SHAPES = ((120, 200), (90, 70), (64, 128), (40, 48))
IMGSZ = 64
XLA_OPTS = {"xla_disable_hlo_passes": "fusion"}
K4_FLIP = [1, 0, 3, 2]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def add_keypoints(data: str, kpt_shape, flip_idx) -> str:
    """Extend every box row of a synthetic dataset by K keypoints at fixed places inside its box, mirror images
    about the box's vertical axis (point k and flip_idx[k]; a point that is its own pair lies on the axis), with
    visibility (row + pair) % 3 when ndim is 3; write kpt_shape and flip_idx into the data YAML. Returns it."""
    K, ndim = kpt_shape
    root = Path(data).parent
    for lf in sorted((root / "labels").rglob("*.txt")):
        rows = []
        for r, line in enumerate(lf.read_text().splitlines()):
            c, cx, cy, w, h = line.split()
            cx, cy, w, h = map(float, (cx, cy, w, h))
            pts = []
            for k in range(K):
                pair = min(k, flip_idx[k])
                side = 0 if flip_idx[k] == k else (-1 if k < flip_idx[k] else 1)
                x = cx + side * w * (0.1 + 0.1 * (pair % 4))
                y = cy - 0.4 * h + 0.8 * h * pair / max(K - 1, 1)
                pts.append(f"{x:.6f} {y:.6f}" + (f" {(r + pair) % 3}" if ndim == 3 else ""))
            rows.append(f"{c} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f} " + " ".join(pts))
        lf.write_text("\n".join(rows) + "\n")
    d = yaml.safe_load(Path(data).read_text())
    d.update(kpt_shape=list(kpt_shape), flip_idx=list(flip_idx))
    Path(data).write_text(yaml.safe_dump(d))
    return data


@pytest.fixture(scope="module", params=[17, 4], ids=["k17", "k4"])
def dataset(request, tmp_path_factory):
    """Keypoint labels on the frames of `tests/test_torch_data.py` (tiles down- and upscaled at imgsz 64): K = 17
    mirrored by COCO_FLIP_IDX, or K = 4 by the YAML's flip_idx; one frame's label file also holds a box row and a
    polygon row, which get zero keypoints."""
    K = request.param
    root = tmp_path_factory.mktemp(f"pose{K}")
    data = make_synthetic_dataset(root, n_train=10, n_val=2, max_boxes=6, seed=3, shapes=SHAPES)
    info = check_det_dataset(add_keypoints(data, (K, 3), COCO_FLIP_IDX if K == 17 else K4_FLIP))
    lf = root / "labels" / "train" / "im004.txt"
    lf.write_text(lf.read_text() + "1 0.5 0.5 0.3 0.2\n2 0.1 0.1 0.6 0.15 0.55 0.8 0.05 0.7\n")
    kw = dict(cache=False, kpt_shape=info["kpt_shape"])
    return YOLODataset(info["train"], **kw), JaxDataset(info["train"], **kw), info


def test_dataset_keypoint_rows_match_jax(dataset):
    """Every image's labels equal the JAX dataset's: cls, bboxes, segments and keypoints (n, K, 3) f32, zero for
    the box and polygon rows; get_item_raw copies the keypoints."""
    port, ref, info = dataset
    K = info["kpt_shape"][0]
    assert info["flip_idx"] == (COCO_FLIP_IDX if K == 17 else K4_FLIP)
    for a, b in zip(port.labels, ref.labels):
        assert a.keys() == b.keys() and a["keypoints"].dtype == np.float32
        for k in ("cls", "bboxes", "keypoints"):
            np.testing.assert_array_equal(a[k], b[k])
        assert len(a["segments"]) == len(b["segments"]) and all(map(np.array_equal, a["segments"], b["segments"]))
    extra = port.labels[4]["keypoints"][-2:]
    assert extra.shape == (2, K, 3) and not extra.any() and port.labels[4]["keypoints"][:-2].any()
    item = port.get_item_raw(4)
    item["keypoints"][:] = -1
    assert port.labels[4]["keypoints"].min() >= 0


def test_label_cache_is_shared(tmp_path):
    """The JAX test's four-corner pose set (`tests/test_tasks.py:198-238`): each package reads the label cache the
    other wrote (the same file and hash), the keypoints (1, 4, 3) all visible."""
    import cv2

    for split, n in (("train", 2),):
        (tmp_path / "images" / split).mkdir(parents=True)
        (tmp_path / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = np.full((96, 96, 3), 120, np.uint8)
            cv2.imwrite(str(tmp_path / "images" / split / f"im{i}.png"), img)
            kps = " ".join(f"{x / 96:.4f} {y / 96:.4f} 2" for x, y in ((24, 24), (56, 24), (56, 56), (24, 56)))
            (tmp_path / "labels" / split / f"im{i}.txt").write_text(f"0 0.4167 0.4167 0.3333 0.3333 {kps}\n")
    path = str(tmp_path / "images" / "train")
    ref = JaxDataset(path, kpt_shape=(4, 3))
    assert Path(path).with_suffix(".labels.npz").exists()
    got = YOLODataset(path, kpt_shape=(4, 3))
    assert got._hash() == ref._hash()
    item = got.get_item_raw(0)
    assert item["keypoints"].shape == (1, 4, 3) and (item["keypoints"][..., 2] == 2).all()
    for a, b in zip(got.labels, ref.labels):
        np.testing.assert_array_equal(a["keypoints"], b["keypoints"])
    Path(path).with_suffix(".labels.npz").unlink()
    YOLODataset(path, kpt_shape=(4, 3))
    back = JaxDataset(path, kpt_shape=(4, 3))
    np.testing.assert_array_equal(back.labels[1]["keypoints"], got.labels[1]["keypoints"])


HYPS = [None, {"mosaic": 0.0}, {"fliplr": 1.0, "flipud": 1.0, "degrees": 30.0, "shear": 5.0, "scale": 0.9},
        {"mosaic": 0.0, "flipud": 0.5, "scale": 0.9, "translate": 0.3}]


@pytest.mark.parametrize("hyp", HYPS, ids=["mosaic", "letterbox", "mosaic_flips_rotate_shear", "letterbox_flipud"])
def test_pose_train_transforms_match_jax(dataset, hyp):
    """PoseTrainTransforms (plan + CPU render) against the JAX PoseTrainTransforms on the same files and seeds, with
    the data YAML's flip_idx (K = 4) or the default (K = 17: COCO_FLIP_IDX): the image, classes, boxes, mask and
    keypoints (max_gt, K, 3) bit for bit. Points off the canvas after the warp are invisible, and but for the plain
    letterbox's mild warp some are."""
    port_ds, jax_ds, info = dataset
    kpt_shape, flip_idx = info["kpt_shape"], (None if info["kpt_shape"][0] == 17 else info["flip_idx"])
    port = PoseTrainTransforms(IMGSZ, hyp, max_gt=24, kpt_shape=kpt_shape, flip_idx=flip_idx)
    ref = JaxPoseTrainTransforms(IMGSZ, hyp, max_gt=24, kpt_shape=kpt_shape, flip_idx=flip_idx)
    assert port.flip_idx == ref.flip_idx == (JAX_COCO_FLIP_IDX if flip_idx is None else K4_FLIP)
    n_inst = n_off = n_vis = 0
    for i in range(len(port_ds)):
        a = port(port_ds, i, np.random.RandomState(100 + i))
        b = ref(jax_ds, i, np.random.RandomState(100 + i))
        assert a["keypoints"].shape == (24,) + kpt_shape and a["keypoints"].dtype == np.float32
        for k in ("img", "cls", "bboxes", "mask", "keypoints"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"sample {i} {k}")
        kp = a["keypoints"][a["mask"]]
        off = (kp[..., 0] < 0) | (kp[..., 0] > IMGSZ) | (kp[..., 1] < 0) | (kp[..., 1] > IMGSZ)
        assert not kp[..., 2][off].any()
        n_inst, n_off, n_vis = n_inst + len(kp), n_off + int(off.sum()), n_vis + int((kp[..., 2] > 0).sum())
    assert n_inst > 10 and n_vis > 0
    if hyp != {"mosaic": 0.0}:  # the mosaic's border and the larger warps push points off the canvas
        assert n_off > 0


def test_loader_ships_keypoints(dataset):
    """The loader's batches carry the keypoints (B, max_gt, K, 3) f32 beside the plans, the same for 1 and 4
    workers."""
    port_ds, _, info = dataset
    tf = PoseTrainTransforms(IMGSZ, max_gt=8, kpt_shape=info["kpt_shape"], flip_idx=info["flip_idx"])
    batches = []
    for workers in (1, 4):
        it = iter(DataLoader(port_ds, tf.plan, batch_size=4, workers=workers, shuffle=True, seed=2, infinite=True))
        batches.append(next(it))
        it.close()
    a, b = batches
    assert a["keypoints"].shape == (4, 8) + info["kpt_shape"] and a["keypoints"].dtype == np.float32
    for k in ("cls", "bboxes", "mask", "keypoints"):
        np.testing.assert_array_equal(a[k], b[k])


def test_kpt_iou_matches_jax():
    """OKS of (M, K, 3) ground truth with mixed visibility against (N, K, 3) predictions, the JAX numpy bit for bit;
    a prediction equal to a ground truth scores 1 over its visible points."""
    rng = np.random.default_rng(3)
    gt = np.concatenate([rng.uniform(0, 64, (5, 17, 2)), rng.integers(0, 3, (5, 17, 1))], -1).astype(np.float32)
    pred = np.concatenate([rng.uniform(0, 64, (9, 17, 2)), rng.random((9, 17, 1))], -1).astype(np.float32)
    pred[4, :, :2] = gt[1, :, :2]
    area = rng.uniform(20, 900, 5).astype(np.float32) * 0.53
    assert np.array_equal(OKS_SIGMA, JAX_OKS_SIGMA)
    ref = jax_kpt_iou_np(gt, pred, area, OKS_SIGMA)
    got = kpt_iou_np(gt, pred, area, OKS_SIGMA)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    assert got[1, 4] == pytest.approx(1.0) and kpt_iou_np(gt[:0], pred, area[:0], OKS_SIGMA).shape == (0, 9)


# -- the pose loss ----------------------------------------------------------------------------------------


NC, STRIDES = 5, (8.0, 16.0, 32.0)


def loss_case(seed, size, kpt_shape=(17, 3), tied=False):
    """Head maps (JAX NHWC), raw keypoints and padded gts with keypoints in pixels (visibility 0/1/2 when ndim is
    3). With `tied` the maps are zero (every anchor scores 0.5 and predicts the same box about itself) and 16
    gts of 40 px lie on a 64-px grid, so each gt's ten anchors have the same ten assigned scores: 160
    foreground anchors tie in runs of 16 across the budget of 64."""
    rng = np.random.default_rng(seed)
    shapes = [(size // 8, size // 8), (size // 16, size // 16), (size // 32, size // 32)]
    maps = [rng.standard_normal((2, h, w, 64 + NC)).astype(np.float32) * (0 if tied else 1) for h, w in shapes]
    A = sum(h * w for h, w in shapes)
    K, ndim = kpt_shape
    kraw = rng.standard_normal((2, A, K * ndim)).astype(np.float32)
    M = 16
    if tied:
        g = np.array([(16 + 64 * i, 16 + 64 * j) for i in range(4) for j in range(4)], np.float32)
        gt = np.tile(np.concatenate([g, g + 40], 1)[None], (2, 1, 1))
        mask = np.ones((2, M), bool)
    else:
        xy = rng.uniform(0, size * 0.6, (2, M, 2))
        gt = np.concatenate([xy, xy + rng.uniform(6, size * 0.4, (2, M, 2))], -1).astype(np.float32)
        mask = np.arange(M)[None] < np.array([[5], [9]])
        gt *= mask[..., None]
    lab = rng.integers(0, NC, (2, M)).astype(np.int32)
    kxy = gt[..., None, :2] + rng.uniform(0, 1, (2, M, K, 2)) * (gt[..., None, 2:] - gt[..., None, :2])
    kpts = np.concatenate([kxy, rng.integers(0, 3, (2, M, K, 1))], -1) if ndim == 3 else kxy
    return maps, kraw, lab, gt.astype(np.float32), mask, kpts.astype(np.float32)


def port_pose_loss(maps, kraw, lab, gt, mask, kpts, kpt_shape, dtype=torch.float32):
    leaves = [torch.from_numpy(m.transpose(0, 3, 1, 2).copy()).to(dtype).requires_grad_() for m in maps]
    tk = torch.from_numpy(kraw).to(dtype).requires_grad_()
    out = {"feats": [(t[:, :64], t[:, 64:]) for t in leaves], "kpt_raw": tk}
    total, items = v8_pose_loss(out, *map(torch.from_numpy, (lab, gt, mask, kpts)), STRIDES, NC, kpt_shape=kpt_shape)
    total.backward()
    return total, items, [t.grad for t in leaves] + [tk.grad]


@pytest.mark.parametrize("case", ["17x3", "5x2", "tied"])
def test_pose_loss_matches_jax(case):
    """Total and the five items (box, pose, kobj, cls, dfl) rtol 1e-5 / atol 1e-6 against the JAX loss; the port's
    f32 gradients (head maps, raw keypoints) within 1e-4 of each one's largest of the port's f64 run. With ndim 2
    there is no kobj term (0). In the tied case the 64th and 65th foreground scores are equal, so the budget's
    cut keeps the lower anchors, as `lax.top_k` does."""
    kpt_shape = (5, 2) if case == "5x2" else (17, 3)
    tied = case == "tied"
    maps, kraw, lab, gt, mask, kpts = loss_case(6, 256 if tied else 64, kpt_shape, tied)
    out = {"feats": tuple(jnp.asarray(m) for m in maps), "kpt_raw": jnp.asarray(kraw)}
    ref_total, ref_items = jax.jit(lambda o, *t: jax_pose_loss(o, *t, STRIDES, NC, kpt_shape=kpt_shape))(
        out, *map(jnp.asarray, (lab, gt, mask, kpts)))
    total, items, g32 = port_pose_loss(maps, kraw, lab, gt, mask, kpts, kpt_shape)
    _, _, g64 = port_pose_loss(maps, kraw, lab, gt, mask, kpts, kpt_shape, torch.float64)
    assert items.shape == (5,) and not items.requires_grad
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=1e-5, atol=1e-6)
    assert float(items[1]) > 0 and (float(items[2]) > 0) == (kpt_shape[1] == 3)
    for a, b in zip(g32, g64):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=0, atol=1e-4 * float(b.abs().max()))
    if tied:
        from lpc_yolo_tpu_torch.losses.detection import v8_detection_loss

        feats = [(torch.from_numpy(m.transpose(0, 3, 1, 2)[:, :64].copy()),
                  torch.from_numpy(m.transpose(0, 3, 1, 2)[:, 64:].copy())) for m in maps]
        assign = v8_detection_loss(feats, *map(torch.from_numpy, (lab, gt, mask)), STRIDES, NC, return_assign=True)[2]
        score = (assign.target_scores.sum(-1) * assign.fg_mask).sort(1, descending=True).values
        assert int(assign.fg_mask[0].sum()) == 160 and float(score[0, 63]) == float(score[0, 64]) > 0


# -- a train step of a narrow yolov8n-pose --------------------------------------------------------------


def narrow_yaml(nc: int = 4, kpt_shape=(17, 3)) -> dict:
    d = yaml.safe_load((PORT_CFG / "yolov8-pose.yaml").read_text())
    d.update(nc=nc, kpt_shape=list(kpt_shape), scales={"t": [0.1, 0.0625, 512]}, scale="t")
    return d


def jax_shapes(jm, size=IMGSZ):
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), training=True))


def make_batch(seed: int) -> dict:
    """f32 RGB frames in [0, 1], padded gts and their (17, 3) keypoints in pixels inside each box."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 30, (2, 4, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (2, 4, 2))], -1).astype(np.float32)
    mask = np.array([[True, True, True, False], [True, False, False, False]])
    kxy = boxes[..., None, :2] + rng.uniform(0, 1, (2, 4, 17, 2)) * (boxes[..., None, 2:] - boxes[..., None, :2])
    kpts = np.concatenate([kxy, rng.integers(0, 3, (2, 4, 17, 1))], -1).astype(np.float32) * mask[..., None, None]
    return {"img": rng.random((2, IMGSZ, IMGSZ, 3), dtype=np.float32),
            "cls": rng.integers(0, 4, (2, 4)).astype(np.int32), "bboxes": boxes * mask[..., None], "mask": mask,
            "keypoints": kpts}


def port_first_trace(tm, batch, dtype, cfg):
    tm = tm.to(dtype).train()
    dev = tts.to_device(batch, torch.device("cpu"))
    dev["img"] = dev["img"].to(dtype)
    total, items = tts.make_loss_fn(tm)(dev)
    total.backward()
    named = dict(tm.named_parameters())
    grads = [p.grad for p in named.values()]
    gnorm = tts.global_norm(grads)
    trace = {k: g * (cfg.grad_clip / gnorm.clamp(min=cfg.grad_clip)) + (cfg.weight_decay * p if p.dim() == 4 else 0)
             for (k, p), g in zip(named.items(), grads)}
    return total.detach(), items, trace


def assert_named_close(named, ref, tol, what, floor):
    assert named.keys() == ref.keys()
    for k, t in named.items():
        r = ref[k].detach().double().numpy()
        np.testing.assert_allclose(t.detach().double().numpy(), r, rtol=0, atol=tol * np.abs(r).max() + floor,
                                   err_msg=f"{what} {k}")


def test_train_step_matches_jax():
    """The pose loss (5 items) through the JAX step (loss_kind "pose", kpt_shape from the batch's keypoints) and
    the port's: loss and items rtol 1e-4; the first momentum trace at the tolerances of `tests/test_torch_v8.py`
    (JAX within 1e-2 of each leaf's largest of the port's f64 run, the port's f32 within 2e-3 of it); then two
    steps of the port's own step, every leaf finite and the keypoint towers moved."""
    d = narrow_yaml()
    jm = jax_build(d)
    variables = random_variables(jax_shapes(jm), seed=0)
    jcfg, tcfg = jts.OptConfig(warmup_steps=2, total_steps=10), tts.OptConfig(warmup_steps=2, total_steps=10)
    jstate, tx = jts.init_train_state(jm, variables, jcfg)
    batch = make_batch(0)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="pose").__wrapped__
    jstep = jax.jit(raw).lower(jstate, batch).compile(compiler_options=XLA_OPTS)
    jstate, jmet = jstep(jstate, batch)
    assert np.asarray(jmet["items"]).shape == (5,)
    total, items, t32 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float32, tcfg)
    _, _, t64 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float64, tcfg)
    np.testing.assert_allclose(float(total), float(jmet["loss"]), rtol=1e-4)
    np.testing.assert_allclose(items.numpy(), np.asarray(jmet["items"]), rtol=1e-4)
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jstate.opt_state[2].inner_state.trace)})
    assert_named_close(t32, t64, 2e-3, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)

    tm = load_flax(build_model(d, device="cpu"), variables)
    state = tts.init_train_state(tm, tcfg, device="cpu")
    step = tts.make_train_step(tm, tcfg, loss_kind="pose")
    start = {k: v.detach().clone() for k, v in state.params.items() if ".cv4." in k}
    for i in range(2):
        state, met = step(state, make_batch(i))
        assert met["items"].shape == (5,) and met["skipped"] is False
    assert all(torch.isfinite(v).all() for v in state.params.values())
    assert all(not torch.equal(state.params[k], v) for k, v in start.items() if k.endswith("weight"))


# -- train(data=...) ---------------------------------------------------------------------------------------


def narrow_yaml_file(tmp: Path) -> Path:
    path = tmp / "yolov8-pose-narrow.yaml"
    path.write_text(yaml.safe_dump(narrow_yaml(nc=3)))
    return path


def test_train_data_on_the_cpu(tmp_path, monkeypatch):
    """`YOLO(<narrow yolov8-pose yaml>, nc=3).train(data=...)` on a keypoint-labelled set on the CPU: 2 epochs of
    batch 4, every step finite, the five items (box, pose, kobj, cls, dfl), a validation each epoch with the (P)
    keys, results.csv with train/pose, train/kobj and the (P) columns, last.ckpt and best.ckpt; the JAX package
    reads last.ckpt and the facade's YOLO.save, whose task is "pose"."""
    import lpc_yolo_tpu.engine.model as jax_model
    from lpc_yolo_tpu.utils.checkpoint import load_checkpoint as jax_load

    from lpc_yolo_tpu_torch.utils.flax_bridge import state_dict_to_flax

    data = make_synthetic_dataset(tmp_path / "ds", n_train=8, n_val=2, imgsz=IMGSZ, nc=3, max_boxes=3, seed=1)
    add_keypoints(data, (17, 3), COCO_FLIP_IDX)
    yolo = YOLO(narrow_yaml_file(tmp_path), device="cpu", seed=0, nc=3)
    res = yolo.train(data=data, imgsz=IMGSZ, batch=4, epochs=2, close_mosaic=1, workers=2, device="cpu",
                     save_dir=tmp_path / "run")
    tr = yolo.trainer
    assert len(tr.history) == 4 and all(np.isfinite(h["loss"]) and h["skipped"] is False for h in tr.history)
    assert all(len(h["items"]) == 5 for h in tr.history) and tr.epoch_history[-1]["pose"] > 0
    assert [k for k in res if k.endswith("(P)")] == ["metrics/precision(P)", "metrics/recall(P)",
                                                      "metrics/mAP50(P)", "metrics/mAP50-95(P)"]
    header = (tmp_path / "run" / "results.csv").read_text().splitlines()[0].split(",")
    assert header[:6] == ["epoch", "train/box", "train/pose", "train/kobj", "train/cls", "train/dfl"]
    assert "metrics/mAP50(P)" in header
    assert sorted(p.name for p in (tmp_path / "run" / "weights").iterdir()) == ["best.ckpt", "last.ckpt"]
    jm = jax_build(yaml.safe_load(narrow_yaml_file(tmp_path).read_text()))
    jcfg = jts.OptConfig(**{k: getattr(tr.cfg, k) for k in ("lr0", "momentum", "warmup_steps", "total_steps",
                                                             "optimizer")})
    template, _ = jts.init_train_state(jm, random_variables(jax_shapes(jm), seed=1), jcfg)
    jstate, meta = jax_load(tmp_path / "run" / "weights" / "last.ckpt", template)
    assert meta["epoch"] == 1 and int(jstate.step) == tr.state.step == 4
    ours = state_dict_to_flax(tr.state.params)["params"]
    assert "cv4_0_0" in ours["model_22"]
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree_util.tree_leaves_with_path(jax.device_get(jstate.params))):
        assert pa == pb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: None)
    jy = jax_model.YOLO(yolo.save(tmp_path / "trained.ckpt"))
    assert (jy.task, jy.model.nc) == ("pose", 3)


def test_results_csv_matches_jax(dataset, tmp_path, monkeypatch):
    """results.csv of a pose model against the JAX trainer's own rows: both trainers run 2 epochs with the same stub
    step (5 f32 items, lr) and stub validation (box and (P) keys) on the keypoint set; the port writes the JAX
    header (train/box, train/pose, train/kobj, train/cls, train/dfl, the metrics with the (P) keys) with its
    render_frac last, and the same cells."""
    import lpc_yolo_tpu.engine.model as jax_model
    import lpc_yolo_tpu.engine.trainer as jax_trainer

    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    info = dataset[2]
    data = {"path": info["path"], "train": info["train"], "val": info["val"], "nc": 3,
            "names": {i: f"class{i}" for i in range(3)}, "kpt_shape": list(info["kpt_shape"]),
            "flip_idx": info["flip_idx"]}
    rng = np.random.default_rng(4)
    items = rng.uniform(0, 5, (6, 5)).astype(np.float32)
    lrs = rng.uniform(0, 0.002, 6)
    keys = ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness",
            "metrics/precision(P)", "metrics/recall(P)", "metrics/mAP50(P)", "metrics/mAP50-95(P)"]
    results = [dict(zip(keys, rng.uniform(0, 1, len(keys)).tolist())) for _ in range(2)]

    def counting(make):
        n = iter(range(12))
        return lambda *a, **k: make(next(n))

    jax_step = counting(lambda i: {"items": items[i], "skipped": np.asarray(False), "lr": np.float32(lrs[i])})
    port_step = counting(lambda i: {"loss": torch.tensor(0.0), "items": torch.from_numpy(items[i]),
                                    "lr": float(lrs[i]), "skipped": False})
    jax_results, port_results = counting(lambda i: results[i]), counting(lambda i: results[i])
    kinds = []

    class StubValidator:
        def __init__(self, *a, **k):
            pass

        __call__ = staticmethod(jax_results)

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: None)
    monkeypatch.setattr(jax_trainer, "init_train_state",
                        lambda *a: (types.SimpleNamespace(ema_params={}, batch_stats={}), None))
    monkeypatch.setattr(jax_trainer, "make_train_step",
                        lambda *a, **k: kinds.append(k["loss_kind"]) or (lambda state, batch: (state, jax_step())))
    monkeypatch.setattr(jax_trainer, "data_parallel_mesh", lambda **k: None)
    monkeypatch.setattr(jax_trainer, "replicate", lambda state, mesh: state)
    monkeypatch.setattr(jax_trainer, "shard_batch", lambda batch, mesh: batch)
    monkeypatch.setattr(jax_trainer, "Validator", StubValidator)
    monkeypatch.setattr(jax_trainer, "save_checkpoint", lambda *a: None)
    monkeypatch.setattr(port_trainer, "make_train_step",
                        lambda *a, **k: kinds.append(k["loss_kind"]) or (lambda state, batch: (state, port_step())))
    monkeypatch.setattr(port_trainer.Trainer, "validate", lambda self, model, state: port_results())
    kw = dict(data=data, epochs=2, batch=4, imgsz=IMGSZ, workers=1, optimizer="adamw")
    d = narrow_yaml(nc=3, kpt_shape=info["kpt_shape"])
    path = tmp_path / "yolov8-pose-narrow.yaml"
    path.write_text(yaml.safe_dump(d))
    jax_trainer.Trainer(jax_model.YOLO(str(path), nc=3), save_dir=str(tmp_path / "jax"), **kw).train()
    port_trainer.Trainer(YOLO(path, device="cpu", seed=0, nc=3), save_dir=tmp_path / "port", device="cpu", **kw).train()
    assert kinds == ["pose", "pose"]
    ref, got = ((tmp_path / n / "results.csv").read_text().splitlines() for n in ("jax", "port"))
    header = ref[0].split(",")
    assert header[:6] == ["epoch", "train/box", "train/pose", "train/kobj", "train/cls", "train/dfl"]
    assert "metrics/mAP50-95(P)" in header and got[0].split(",") == header + ["render_frac"] and len(got) == len(ref) == 3
    timing = {"time_s", "input_wait_frac", "render_frac"}
    for r, g in zip(ref[1:], got[1:]):
        rj, rp = dict(zip(header, r.split(","))), dict(zip(header + ["render_frac"], g.split(",")))
        assert {k: v for k, v in rp.items() if k not in timing} == {k: v for k, v in rj.items() if k not in timing}
