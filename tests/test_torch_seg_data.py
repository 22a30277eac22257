"""The port's segmentation data path against OpenCV and the JAX package, on the CPU.

* `fill_poly` equals `cv2.fillPoly(img, [pts], 1)` (OpenCV 5.0, LINE_8,
  shift 0) bit for bit, under `hypothesis` and on seeded polygons of every
  kind: convex, concave, self-intersecting, degenerate (collinear points,
  repeated points, one or two vertices), partly or wholly outside the
  canvas, negative coordinates.
* `resize_linear` equals `cv2.resize(..., INTER_LINEAR)` of f32 planes bit for
  bit (upscales, downscales, the exact 2x one), so `unletterbox_masks` equals
  the JAX predictor's pad crop, cv2 resize and `> 0.5` (:328-340) on the same
  masks; `mask_iou` equals the JAX `mask_iou_np` bit for bit.
* `make_synthetic_dataset(..., segments=True)` writes the JAX generator's
  label files; `SegTrainTransforms` (plan + CPU render) against the JAX
  `SegTrainTransforms` on the same files and `RandomState` seeds: images,
  classes, boxes and the (max_gt, imgsz / 4, imgsz / 4) masks bit for bit,
  mosaic on and off, both flips, rotation and shear; the loader ships the
  masks with the batch.
* `train(data=...)` of a narrow yolov8n-seg on a polygon-labelled set: the
  four loss items, the validator's (M) keys in results.csv in the JAX
  trainer's columns (with stub steps and validations, as `tests/test_torch_v8.py`),
  and its `.ckpt` files read by the JAX package with task "segment".
"""

import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from lpc_yolo_tpu.data import YOLODataset as JaxDataset
from lpc_yolo_tpu.data.augment import SegTrainTransforms as JaxSegTrainTransforms
from lpc_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic_dataset
from lpc_yolo_tpu.utils.metrics import mask_iou_np

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import (DataLoader, SegTrainTransforms, YOLODataset, check_det_dataset,
                                     make_synthetic_dataset)
from lpc_yolo_tpu_torch.ops.masks import fill_poly, resize_linear, unletterbox_masks
from lpc_yolo_tpu_torch.utils.metrics import mask_iou

ROOT = Path(__file__).resolve().parents[1]
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v8"
SHAPES = ((120, 200), (90, 70), (64, 128), (40, 48))
IMGSZ = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_fill_matches_cv2(pts, h: int, w: int) -> None:
    pts = np.asarray(pts, np.int32).reshape(-1, 2)
    ref = np.zeros((h, w), np.uint8)
    cv2.fillPoly(ref, [pts], 1)
    got = fill_poly(np.zeros((h, w), np.uint8), pts)
    assert np.array_equal(got, ref), f"{h}x{w} {pts.tolist()}: {int((got != ref).sum())} pixels differ"


@settings(max_examples=400, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48),
       pts=st.lists(st.tuples(st.integers(-70, 120), st.integers(-70, 120)), min_size=1, max_size=16))
def test_fill_poly_matches_cv2_hypothesis(h, w, pts):
    """Any polygon of 1 to 16 vertices, anywhere from far outside to inside a canvas of 1 to 48 pixels a side."""
    assert_fill_matches_cv2(pts, h, w)


def polygons(kind: str, rng: np.random.Generator, n: int = 60):
    """Seeded polygons of one kind on a 64x80 canvas."""
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 40))
        if kind == "convex":
            a = np.sort(rng.uniform(0, 2 * np.pi, k))
            c, r = rng.uniform(10, 60, 2), rng.uniform(3, 40)
            p = c + r * np.stack([np.cos(a), np.sin(a)], 1)
        elif kind == "concave":  # a star: radii alternate
            a = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False)
            r = np.where(np.arange(2 * k) % 2, rng.uniform(2, 10), rng.uniform(12, 35))
            p = rng.uniform(15, 60, 2) + r[:, None] * np.stack([np.cos(a), np.sin(a)], 1)
        elif kind == "self_intersecting":
            p = rng.uniform(0, 80, (k, 2))
        elif kind == "collinear":  # every vertex on one line, or repeated
            t = rng.uniform(-10, 90, k)
            p = rng.uniform(0, 60, 2) + t[:, None] * rng.uniform(-1, 1, 2)
        elif kind == "repeated":
            p = np.repeat(rng.uniform(0, 80, (max(k // 3, 1), 2)), rng.integers(1, 4), axis=0)
        elif kind == "outside":  # partly or wholly past the canvas on any side
            p = rng.uniform(-100, 180, (k, 2))
        elif kind == "negative":  # the mosaic border's negative coordinates, and the box clip's 0 and w / h
            p = rng.uniform(-40, 30, (k, 2))
            p[rng.random(k) < 0.2] = 0
        else:  # tiny: one or two vertices
            p = rng.uniform(-2, 70, (int(rng.integers(1, 3)), 2))
        out.append(p.astype(np.int32))
    return out


@pytest.mark.parametrize("kind", ["convex", "concave", "self_intersecting", "collinear", "repeated", "outside",
                                  "negative", "tiny"])
def test_fill_poly_matches_cv2_by_kind(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    for p in polygons(kind, rng):
        assert_fill_matches_cv2(p, 64, 80)


def test_fill_poly_training_masks_match_cv2():
    """The training path's polygons: 200-point contours warped, clipped to their boxes, flipped and scaled by
    1/4 into a 160x160 mask, whose far edge (x or y = 160) lies just outside it."""
    rng = np.random.default_rng(9)
    for _ in range(30):
        a = np.linspace(0, 2 * np.pi, 200, endpoint=False)
        p = rng.uniform(0, 640, 2) + rng.uniform(20, 400) * np.stack([np.cos(a), np.sin(a) * rng.uniform(0.3, 1)], 1)
        p = p.clip(0, 640).astype(np.float32)
        assert_fill_matches_cv2((p * 0.25).astype(np.int32), 160, 160)


@pytest.mark.parametrize("src, dst", [((16, 16), (64, 64)), ((37, 52), (120, 90)), ((64, 64), (32, 32)),
                                      ((640, 640), (720, 1280)), ((48, 64), (31, 17)), ((5, 7), (5, 29))])
def test_resize_linear_matches_cv2(src, dst):
    """cv2's f32 INTER_LINEAR resize, bit for bit: its weights (the fraction in f64, rounded to f32) and its fused
    a + (b - a) * w in each pass."""
    x = np.random.default_rng(sum(src + dst)).random((3,) + src, dtype=np.float32)
    got = resize_linear(torch.from_numpy(x), dst).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], cv2.resize(x[i], dst[::-1], interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("orig", [(720, 1280), (480, 320), (100, 100), (33, 250)])
def test_unletterbox_masks_matches_the_jax_predictor(orig):
    """`unletterbox_masks` against the JAX predictor's own steps on the same sigmoid masks at imgsz 96: the
    pad cropped at round(pad), `cv2.resize(mi, (w0, h0))` and `> 0.5`, mask for mask, bit for bit."""
    S = 96
    m = np.random.default_rng(orig[0]).random((4, S, S), dtype=np.float32)
    m[0] = 0.5  # exact halves stay below the threshold
    h0, w0 = orig
    gain = min(S / h0, S / w0)
    pw, ph = (S - w0 * gain) / 2, (S - h0 * gain) / 2
    y1, y2, x1, x2 = int(round(ph)), int(round(S - ph)), int(round(pw)), int(round(S - pw))
    ref = np.stack([cv2.resize(mi, (w0, h0)) > 0.5 for mi in m[:, y1:y2, x1:x2]])
    np.testing.assert_array_equal(unletterbox_masks(torch.from_numpy(m), S, orig).numpy(), ref)


def test_mask_iou_matches_jax():
    rng = np.random.default_rng(3)
    gt = rng.random((5, 40, 30)) < 0.3
    pred = rng.random((9, 40, 30)) < 0.5
    pred[0] = gt[2]
    ref = mask_iou_np(gt.astype(np.uint8), pred)
    got = mask_iou(torch.from_numpy(gt.astype(np.uint8)), torch.from_numpy(pred)).numpy()
    assert got.dtype == np.float32 and got.tobytes() == ref.tobytes()
    assert got[2, 0] == pytest.approx(1.0)


# -- the dataset and the transforms ----------------------------------------------------------------------


def test_synthetic_segments_match_jax(tmp_path):
    """`segments=True` writes the JAX generator's polygon label files (square frames: the JAX draws), and the
    port's dataset reads each as a (4, 2) polygon with its bounding box."""
    port = check_det_dataset(make_synthetic_dataset(tmp_path / "port", n_train=5, n_val=2, imgsz=96, segments=True))
    jax_make_synthetic_dataset(tmp_path / "jax", n_train=5, n_val=2, imgsz=96, segments=True)
    for split in ("train", "val"):
        for f in sorted((tmp_path / "jax" / "labels" / split).glob("*.txt")):
            assert (tmp_path / "port" / "labels" / split / f.name).read_text() == f.read_text()
    ds = YOLODataset(port["train"], cache=False)
    item = ds.get_item_raw(0)
    assert len(item["segments"]) == len(item["bboxes"]) > 0 and all(s.shape == (4, 2) for s in item["segments"])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Polygon labels on the frames of `tests/test_torch_data.py` (tiles down- and upscaled at imgsz 64), one
    frame's label file holding box rows only (they become rectangles)."""
    root = tmp_path_factory.mktemp("seg")
    info = check_det_dataset(make_synthetic_dataset(root, n_train=10, n_val=2, max_boxes=6, seed=3, shapes=SHAPES,
                                                    segments=True))
    lf = root / "labels" / "train" / "im004.txt"
    rows = [r.split() for r in lf.read_text().splitlines()]
    lf.write_text("".join(f"{r[0]} {(float(r[1]) + float(r[3])) / 2:.6f} {(float(r[2]) + float(r[6])) / 2:.6f} "
                          f"{float(r[3]) - float(r[1]):.6f} {float(r[6]) - float(r[2]):.6f}\n" for r in rows))
    return YOLODataset(info["train"], cache=False), JaxDataset(info["train"], cache=False), info


HYPS = [None, {"mosaic": 0.0}, {"fliplr": 1.0, "flipud": 1.0, "degrees": 30.0, "shear": 5.0},
        {"mosaic": 0.0, "flipud": 0.5, "scale": 0.9, "translate": 0.3}]


@pytest.mark.parametrize("hyp", HYPS, ids=["mosaic", "letterbox", "mosaic_flips_rotate_shear", "letterbox_flipud"])
def test_seg_train_transforms_match_jax(dataset, hyp):
    """SegTrainTransforms (plan + CPU render) against the JAX SegTrainTransforms on the same files and seeds:
    the image, classes, boxes, mask and every instance mask bit for bit."""
    port_ds, jax_ds, _ = dataset
    port, ref = SegTrainTransforms(IMGSZ, hyp, max_gt=24), JaxSegTrainTransforms(IMGSZ, hyp, max_gt=24)
    n_inst = 0
    for i in range(len(port_ds)):
        a = port(port_ds, i, np.random.RandomState(100 + i))
        b = ref(jax_ds, i, np.random.RandomState(100 + i))
        assert a["masks"].shape == (24, IMGSZ // 4, IMGSZ // 4) and a["masks"].dtype == np.uint8
        for k in ("img", "cls", "bboxes", "mask", "masks"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"sample {i} {k}")
        n_inst += int(b["mask"].sum())
        assert all(b["masks"][j].any() for j in np.nonzero(b["mask"])[0][:1])
    assert n_inst > 10


def test_loader_ships_masks(dataset):
    """The loader's batches carry the masks (B, max_gt, 16, 16) uint8 beside the plans, the same for 1 and 4
    workers."""
    port_ds, _, _ = dataset
    tf = SegTrainTransforms(IMGSZ, max_gt=8)
    batches = []
    for workers in (1, 4):
        it = iter(DataLoader(port_ds, tf.plan, batch_size=4, workers=workers, shuffle=True, seed=2, infinite=True))
        batches.append(next(it))
        it.close()
    a, b = batches
    assert a["masks"].shape == (4, 8, 16, 16) and a["masks"].dtype == np.uint8 and len(a["plan"]) == 4
    for k in ("cls", "bboxes", "mask", "masks"):
        np.testing.assert_array_equal(a[k], b[k])


# -- train(data=...) ---------------------------------------------------------------------------------------


def narrow_yaml_file(tmp: Path) -> Path:
    d = yaml.safe_load((PORT_CFG / "yolov8-seg.yaml").read_text())
    d.update(nc=3, scales={"t": [0.1, 0.0625, 512]}, scale="t")
    path = tmp / "yolov8-seg-narrow.yaml"
    path.write_text(yaml.safe_dump(d))
    return path


def test_train_data_on_the_cpu(tmp_path, monkeypatch):
    """`YOLO(<narrow yolov8-seg yaml>, nc=3).train(data=...)` on a polygon-labelled set on the CPU: 2 epochs of
    batch 4, every step finite, the four items (box, seg, cls, dfl), a validation each epoch with the (M) keys,
    results.csv with train/seg and the (M) columns, last.ckpt and best.ckpt; the JAX package reads last.ckpt
    and the facade's YOLO.save, whose task is "segment"."""
    import jax
    import lpc_yolo_tpu.engine.model as jax_model
    from lpc_yolo_tpu.engine import train_step as jts
    from lpc_yolo_tpu.nn import build_model as jax_build
    from lpc_yolo_tpu.utils.checkpoint import load_checkpoint as jax_load

    from lpc_yolo_tpu_torch.utils.flax_bridge import random_variables, state_dict_to_flax

    data = make_synthetic_dataset(tmp_path / "ds", n_train=8, n_val=2, imgsz=IMGSZ, nc=3, max_boxes=3, seed=1,
                                  segments=True)
    yolo = YOLO(narrow_yaml_file(tmp_path), device="cpu", seed=0, nc=3)
    res = yolo.train(data=data, imgsz=IMGSZ, batch=4, epochs=2, close_mosaic=1, workers=2, device="cpu",
                     save_dir=tmp_path / "run")
    tr = yolo.trainer
    assert len(tr.history) == 4 and all(np.isfinite(h["loss"]) and h["skipped"] is False for h in tr.history)
    assert all(len(h["items"]) == 4 for h in tr.history)
    assert [k for k in res if k.endswith("(M)")] == ["metrics/precision(M)", "metrics/recall(M)",
                                                      "metrics/mAP50(M)", "metrics/mAP50-95(M)"]
    header = (tmp_path / "run" / "results.csv").read_text().splitlines()[0].split(",")
    assert header[:5] == ["epoch", "train/box", "train/seg", "train/cls", "train/dfl"] and "metrics/mAP50(M)" in header
    assert sorted(p.name for p in (tmp_path / "run" / "weights").iterdir()) == ["best.ckpt", "last.ckpt"]
    jm = jax_build(yaml.safe_load(narrow_yaml_file(tmp_path).read_text()))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), np.zeros((1, IMGSZ, IMGSZ, 3), np.float32),
                                            training=True))
    jcfg = jts.OptConfig(**{k: getattr(tr.cfg, k) for k in ("lr0", "momentum", "warmup_steps", "total_steps",
                                                             "optimizer")})
    template, _ = jts.init_train_state(jm, random_variables(shapes, seed=1), jcfg)
    jstate, meta = jax_load(tmp_path / "run" / "weights" / "last.ckpt", template)
    assert meta["epoch"] == 1 and int(jstate.step) == tr.state.step == 4
    ours = state_dict_to_flax(tr.state.params)["params"]
    assert "proto" in ours["model_22"]
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree_util.tree_leaves_with_path(jax.device_get(jstate.params))):
        assert pa == pb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: None)
    jy = jax_model.YOLO(yolo.save(tmp_path / "trained.ckpt"))
    assert (jy.task, jy.model.nc) == ("segment", 3)


def test_results_csv_matches_jax(dataset, tmp_path, monkeypatch):
    """results.csv of a segment model against the JAX trainer's own rows: both trainers run 2 epochs with the same
    stub step (4 f32 items, lr) and stub validation (box and (M) keys); the port writes the JAX header
    (train/box, train/seg, train/cls, train/dfl, the metrics with the (M) keys) with its render_frac last, and
    the same cells."""
    import lpc_yolo_tpu.engine.model as jax_model
    import lpc_yolo_tpu.engine.trainer as jax_trainer

    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    info = dataset[2]
    data = {"path": info["path"], "train": info["train"], "val": info["val"], "nc": 3,
            "names": {i: f"class{i}" for i in range(3)}}
    rng = np.random.default_rng(4)
    items = rng.uniform(0, 5, (6, 4)).astype(np.float32)
    lrs = rng.uniform(0, 0.002, 6)
    keys = ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness",
            "metrics/precision(M)", "metrics/recall(M)", "metrics/mAP50(M)", "metrics/mAP50-95(M)"]
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
    path = narrow_yaml_file(tmp_path)
    jax_trainer.Trainer(jax_model.YOLO(str(path), nc=3), save_dir=str(tmp_path / "jax"), **kw).train()
    port_trainer.Trainer(YOLO(path, device="cpu", seed=0, nc=3), save_dir=tmp_path / "port", device="cpu", **kw).train()
    assert kinds == ["segment", "segment"]
    ref, got = ((tmp_path / n / "results.csv").read_text().splitlines() for n in ("jax", "port"))
    header = ref[0].split(",")
    assert header[:5] == ["epoch", "train/box", "train/seg", "train/cls", "train/dfl"]
    assert "metrics/mAP50-95(M)" in header and got[0].split(",") == header + ["render_frac"] and len(got) == len(ref) == 3
    timing = {"time_s", "input_wait_frac", "render_frac"}
    for r, g in zip(ref[1:], got[1:]):
        rj, rp = dict(zip(header, r.split(","))), dict(zip(header + ["render_frac"], g.split(",")))
        assert {k: v for k, v in rp.items() if k not in timing} == {k: v for k, v in rj.items() if k not in timing}


def test_validator_gt_masks_follow_the_box_labels(tmp_path):
    """The validator's ground-truth masks at letterbox resolution: each polygon filled as the JAX validator fills
    it (f32 scale and pad, int32, cv2.fillPoly), one mask per box label the validator keeps (the first max_gt),
    and a box row's empty polygon as an empty mask (the JAX validator's cv2.fillPoly raises on it)."""
    from lpc_yolo_tpu_torch.data import ValTransforms
    from lpc_yolo_tpu_torch.engine.validator import Validator

    (tmp_path / "images" / "val").mkdir(parents=True)
    (tmp_path / "labels" / "val").mkdir(parents=True)
    img = np.random.default_rng(0).integers(0, 256, (50, 80, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "images" / "val" / "a.png"), img)
    rows = ["1 0.5 0.5 0.2 0.3", "0 0.1 0.1 0.6 0.15 0.55 0.8 0.05 0.7", "2 0.3 0.2 0.9 0.25 0.8 0.9",
            "0 0.2 0.6 0.4 0.6 0.4 0.95 0.2 0.95"]
    (tmp_path / "labels" / "val" / "a.txt").write_text("\n".join(rows) + "\n")
    ds = YOLODataset(str(tmp_path / "images" / "val"), cache=False)
    sample = ValTransforms(64, max_gt=3)(ds, 0)
    batch = {k: [sample[k]] for k in ("orig_shape", "gain", "pad")}
    batch["mask"] = sample["mask"][None]
    got = Validator(None, imgsz=64, max_gt=3, device="cpu").gt_masks(ds, 0, batch, 0)
    assert got.shape == (3, 64, 64) and got.dtype == np.uint8 and not got[0].any()
    h0, w0 = sample["orig_shape"]
    for i in (1, 2):
        p = np.asarray(ds.labels[0]["segments"][i], np.float32) * np.array([w0 * sample["gain"], h0 * sample["gain"]],
                                                                          np.float32)
        p += np.asarray(sample["pad"], np.float32)
        ref = np.zeros((64, 64), np.uint8)
        cv2.fillPoly(ref, [p.astype(np.int32)], 1)
        np.testing.assert_array_equal(got[i], ref)
        assert ref.any()
