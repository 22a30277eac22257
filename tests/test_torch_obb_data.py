"""The port's oriented-box data path against OpenCV and the JAX package, on the CPU.

* `data/cvops.py::min_area_rect` against `cv2.minAreaRect` (OpenCV 5.0): on
  `cv2.boxPoints` rectangles at every whole degree in [-90, 90] and on 1000
  seeded convex and non-convex quads, the centre and size within 1e-4 of the
  largest coordinate, the angle within 1e-4 degrees and always on cv2's side
  of its -90 / 0 branch (an axis-aligned rectangle is -90 with its vertical
  side as w); on rectangles rounded to whole pixels, 99.5% bit for bit and
  about 1 row in 5000 the other of two near-equal rectangles.
* `YOLODataset(obb=True)`: on square frames each DOTA row's rotated box
  is the JAX dataset's; on a 1280 x 720 frame the JAX parse (minAreaRect
  of the normalized quad, w scaled by w0 and h by h0) is not the box in the
  frame, and the port's is (`rotated_boxes`); the label cache of an oriented
  set is keyed apart from the JAX package's.
* `OBBTrainTransforms` (plan + CPU render) against the JAX transform on the
  same files, rotated boxes and seeds: the images bit for bit (the plan's
  identity warp changes no pixel), the rotated boxes, classes and mask
  equal; the loader ships the rotated boxes. `ValTransforms`' rotated boxes
  equal the JAX validator's `_gt_rboxes` on square frames, cut to max_gt.
* `probiou_matrix_np` equals the JAX one bit for bit.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from lpc_yolo_tpu.data import YOLODataset as JaxDataset
from lpc_yolo_tpu.data.augment import OBBTrainTransforms as JaxOBBTrainTransforms
from lpc_yolo_tpu.engine.validator import Validator as JaxValidator
from lpc_yolo_tpu.utils.metrics import probiou_matrix_np as jax_probiou_matrix_np

from lpc_yolo_tpu_torch.data import DataLoader, OBBTrainTransforms, ValTransforms, YOLODataset, check_det_dataset
from lpc_yolo_tpu_torch.data.cvops import min_area_rect
from lpc_yolo_tpu_torch.data.dataset import rotated_boxes
from lpc_yolo_tpu_torch.utils.metrics import probiou_matrix_np

IMGSZ = 64
SIDES = (96, 64, 130, 40, 77)  # square frames: downscaled, kept, downscaled unevenly, upscaled


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cv2_rect(pts) -> np.ndarray:
    (cx, cy), (w, h), a = cv2.minAreaRect(np.asarray(pts, np.float32))
    return np.array([cx, cy, w, h, a], np.float32)


def assert_rects_close(got: np.ndarray, ref: np.ndarray, pts: np.ndarray):
    scale = np.abs(pts).reshape(len(pts), -1).max(1)
    err = np.abs(got[:, :4] - ref[:, :4]).max(1)
    assert (err <= 1e-4 * scale).all(), f"centre/size off by {(err / scale).max():.3g} of the largest coordinate"
    assert np.abs(got[:, 4] - ref[:, 4]).max() <= 1e-4
    assert (got[:, 4] >= -90).all() and (got[:, 4] < 0).all()
    assert np.array_equal(got[:, 4] == -90, ref[:, 4] == -90)


# -- min_area_rect ------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("rect", [((50, 50), (30, 16)), ((512.3, 300.7), (100, 300)), ((64, 64), (20, 20)),
                                  ((0.5, 0.4), (0.1, 0.3))], ids=["30x16", "100x300", "square", "normalized"])
def test_min_area_rect_on_rectangles(rect):
    """`cv2.boxPoints` of a rectangle at every whole degree in [-90, 90]: cv2's centre, size and angle in [-90, 0),
    w the side along the angle. The axis-aligned ones (-90, 0, 90 degrees) come back at -90 with the vertical side
    as w, as cv2's; e.g. the corners of ((50, 50), (30, 16), 30) give ((50, 50), (16, 30), -60)."""
    pts = np.stack([cv2.boxPoints((rect[0], rect[1], float(d))) for d in range(-90, 91)])
    got, ref = min_area_rect(pts), np.stack([cv2_rect(p) for p in pts])
    assert got.shape == (181, 5) and got.dtype == np.float32
    assert_rects_close(got, ref, pts)
    for d in (-90, 0, 90):
        r = got[d + 90]
        assert r[4] == -90 and np.isclose(r[2], rect[1][1] if d == 0 else rect[1][0], rtol=1e-5)
    if rect == ((50, 50), (30, 16)):
        np.testing.assert_allclose(got[30 + 90], [50, 50, 16, 30, -60], rtol=0, atol=1e-4)
        np.testing.assert_allclose(cv2_rect(pts[30 + 90]), [50, 50, 16, 30, -60], rtol=0, atol=1e-4)


def seeded_quads(n: int = 1000) -> np.ndarray:
    """Convex quads (jittered rotated rectangles, corners in order, some on a pixel grid or in normalized units)
    and non-convex ones (a corner pulled inside the triangle of the others, or the corners out of order)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        c, wh, a = rng.uniform(50, 900, 2), rng.uniform(4, 400, 2), rng.uniform(-180, 180)
        q = cv2.boxPoints((tuple(c), tuple(wh), a)) + rng.normal(0, 0.05 * wh.min(), (4, 2))
        kind = i % 4
        if kind == 1:  # concave: one corner pulled towards the centre
            q[rng.integers(4)] = c + (q[rng.integers(4)] - c) * 0.2
        elif kind == 2:  # corners out of order (a self-crossing quad)
            q = q[rng.permutation(4)]
        elif kind == 3:
            q = np.round(q) if i % 8 == 3 else q / 1024
        out.append(q.astype(np.float32))
    return np.stack(out)


def test_min_area_rect_on_seeded_quads():
    """1000 seeded convex and non-convex quads: cv2's centre and size within 1e-4 of the largest coordinate, angle
    within 1e-4 degrees and on cv2's side of every branch; most rows are cv2's bit for bit (its hull order, calipers
    and f32 steps are reproduced)."""
    pts = seeded_quads()
    got, ref = min_area_rect(pts), np.stack([cv2_rect(p) for p in pts])
    assert_rects_close(got, ref, pts)
    assert (got == ref).all(1).mean() > 0.9
    one = min_area_rect(pts[5])
    assert one.shape == (5,) and np.array_equal(one, got[5])


@pytest.mark.parametrize("seed", [0, 1])
def test_min_area_rect_on_near_rectangles(seed):
    """DOTA-style quads, 5000 rotated rectangles' corners rounded to whole pixels of a 1024 frame and normalized: two
    caliper positions (the two near-parallel sides) give areas equal to f32 rounding, so which rectangle cv2 keeps
    turns on its caliper test (`firstVecIsRight` in f32 on the edge vectors turned into one frame), which
    `_calipers` reproduces. Every row is cv2's bit for bit."""
    rng = np.random.default_rng(seed)
    quads = np.stack([np.round(cv2.boxPoints((tuple(rng.uniform(300, 700, 2)), tuple(rng.uniform(20, 300, 2)),
                                              rng.uniform(-90, 90)))) / 1024 for _ in range(5000)]).astype(np.float32)
    got, ref = min_area_rect(quads), np.stack([cv2_rect(p) for p in quads])
    assert (got == ref).all(), np.flatnonzero(~(got == ref).all(1))


def test_min_area_rect_of_degenerate_sets():
    """Points on one line give cv2's zero-height rectangle along the line, one point cv2's zero rectangle at -90."""
    sets = np.array([[[0, 0], [1, 1], [2, 2], [3, 3]], [[5, 1], [1, 5], [3, 3], [2, 4]], [[1, 1]] * 4,
                     [[0, 0], [0, 5], [0, 2], [0, 1]], [[0, 0], [5, 0], [2, 0], [1, 0]]], np.float32)
    np.testing.assert_allclose(min_area_rect(sets), np.stack([cv2_rect(p) for p in sets]), rtol=0, atol=1e-5)


# -- DOTA rows ------------------------------------------------------------------------------------------------------


def write_dota_set(root: Path, sides=SIDES, shapes=None, seed: int = 3) -> str:
    """PNG frames of noise with filled rotated rectangles and their DOTA quads (normalized, in the rectangle's
    corner order), a class each; square frames of `sides` unless `shapes` (h, w) are given."""
    rng = np.random.default_rng(seed)
    shapes = shapes or [(s, s) for s in sides]
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(shapes):
        img = rng.integers(60, 200, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(int(rng.integers(2, 6))):
            side = min(h, w)
            c = rng.uniform(0.3, 0.7, 2) * [w, h]
            wh = rng.uniform(0.1, 0.35, 2) * side
            quad = cv2.boxPoints((tuple(c), tuple(wh), float(rng.uniform(-90, 90))))
            cv2.fillPoly(img, [quad.astype(np.int32)], tuple(int(v) for v in rng.integers(0, 255, 3)))
            lines.append(f"{int(rng.integers(0, 3))} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in quad))
        for split in ("train", "val"):
            cv2.imwrite(str(root / "images" / split / f"{i}.png"), img)
            (root / "labels" / split / f"{i}.txt").write_text("\n".join(lines) + "\n")
    (root / "data.yaml").write_text(yaml.safe_dump({"path": str(root), "train": "images/train", "val": "images/val",
                                                    "nc": 3}))
    return str(root / "data.yaml")


@pytest.fixture(scope="module")
def dota(tmp_path_factory):
    root = tmp_path_factory.mktemp("dota")
    info = check_det_dataset(write_dota_set(root))
    return YOLODataset(info["train"], cache=False, obb=True), JaxDataset(info["train"], cache=False, obb=True), info


def test_dota_rows_match_jax_on_square_frames(dota):
    """On square frames each DOTA row's rotated box (`get_item_raw`, in units of the frame's side) is the JAX
    dataset's `rboxes` row within 1e-5 (the angle in radians, in [-pi/2, 0)); classes and quads are the JAX labels'.
    The port keeps each quad's hull in `bboxes`, as for any polygon row, where the JAX parse keeps its rectangle's
    (cx, cy, w, h), which only its confusion matrix reads."""
    port, ref, _ = dota
    n = 0
    for i in range(len(port)):
        item, lab = port.get_item_raw(i), ref.labels[i]
        np.testing.assert_array_equal(item["cls"], lab["cls"])
        assert all(map(np.array_equal, item["segments"], lab["segments"]))
        assert item["rboxes"].dtype == np.float32 and item["rboxes"].shape == (len(lab["cls"]), 5)
        assert (item["rboxes"][:, 4] >= -np.pi / 2).all() and (item["rboxes"][:, 4] < 0).all()
        np.testing.assert_allclose(item["rboxes"], lab["rboxes"], rtol=0, atol=1e-5)
        q = np.stack(lab["segments"])
        hull = np.concatenate([(q.min(1) + q.max(1)) / 2, q.max(1) - q.min(1)], -1)
        np.testing.assert_allclose(item["bboxes"], hull, rtol=0, atol=1e-6)
        n += len(lab["cls"])
    assert n > 10


def test_non_square_frame_rotated_box_is_the_box_in_pixels(tmp_path):
    """A 300 x 100 box at 30 degrees on a 1280 x 720 frame. The JAX parse's rotated box, scaled as its validator
    and OBB transform scale it (w by w0, h by h0; engine/validator.py:195-198, data/augment.py:656-660), is
    143.25 x 251.82 at -44.25 degrees; cv2.minAreaRect of the quad in pixels, and the port's, is 100 x 300 at -60
    degrees (ROADMAP Queue 3)."""
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    h0, w0 = 720, 1280
    cv2.imwrite(str(tmp_path / "images" / "a.png"), np.full((h0, w0, 3), 100, np.uint8))
    quad = cv2.boxPoints(((640.0, 360.0), (300.0, 100.0), 30.0))
    (tmp_path / "labels" / "a.txt").write_text("0 " + " ".join(f"{x / w0:.6f} {y / h0:.6f}" for x, y in quad) + "\n")
    jrb = JaxDataset(str(tmp_path / "images"), cache=False, obb=True).labels[0]["rboxes"][0]
    jax_px = [jrb[0] * w0, jrb[1] * h0, jrb[2] * w0, jrb[3] * h0, np.rad2deg(jrb[4])]
    np.testing.assert_allclose(jax_px, [640, 360, 143.25, 251.82, -44.25], atol=0.02)
    item = YOLODataset(str(tmp_path / "images"), cache=False, obb=True).get_item_raw(0)
    rb = item["rboxes"][0]
    port_px = [*(rb[:4] * max(h0, w0)), np.rad2deg(rb[4])]
    q = np.array([[float(v) for v in f"{x / w0:.6f} {y / h0:.6f}".split()] for x, y in quad]) * [w0, h0]
    ref = cv2_rect(q)
    np.testing.assert_allclose(port_px[:4], ref[:4], rtol=0, atol=1e-4 * w0)
    np.testing.assert_allclose(port_px[4], ref[4], atol=1e-3)
    np.testing.assert_allclose(port_px, [640, 360, 100, 300, -60], atol=0.02)
    np.testing.assert_allclose(rotated_boxes(item["segments"], item["bboxes"], (h0, w0)), item["rboxes"])


def test_rotated_boxes_computed_once_an_image(tmp_path, monkeypatch):
    """`get_item_raw` makes an image's rotated boxes on its first load and hands out copies of them after: a second
    load, of every image, calls `rotated_boxes` no more and gives the same rows, which a caller's edit of its copy
    does not change."""
    import lpc_yolo_tpu_torch.data.dataset as dataset_module

    write_dota_set(tmp_path, sides=(64, 48, 80))
    ds = YOLODataset(str(tmp_path / "images" / "train"), cache=False, obb=True)
    calls = []
    real = dataset_module.rotated_boxes
    monkeypatch.setattr(dataset_module, "rotated_boxes", lambda *a: calls.append(1) or real(*a))
    first = [ds.get_item_raw(i)["rboxes"] for i in range(len(ds))]
    assert len(calls) == len(ds)
    first[0] += 1.0
    again = [ds.get_item_raw(i) for i in range(len(ds))]
    assert len(calls) == len(ds)
    for item in again:
        np.testing.assert_array_equal(item["rboxes"], real(item["segments"], item["bboxes"], item["img"].shape[:2]))
    np.testing.assert_array_equal(again[0]["rboxes"] + 1.0, first[0])


def test_label_cache_keyed_apart_from_jax(tmp_path):
    """The port's oriented set hashes its cache with "obb" (the JAX package writes its oriented caches under the plain
    hash, holding the rectangles of normalized quads): a JAX-written cache serves the port's box/polygon reading of
    the same files and not its oriented one, and each package reads back what it wrote."""
    write_dota_set(tmp_path, sides=(64, 48))
    path = str(tmp_path / "images" / "train")
    ref = JaxDataset(path, obb=True)
    assert "rboxes" in ref.labels[0] and Path(path).with_suffix(".labels.npz").exists()
    plain, oriented = YOLODataset(path), YOLODataset(path, obb=True)
    assert plain._hash() == ref._hash() != oriented._hash()
    assert "rboxes" in plain.labels[0] and "rboxes" not in oriented.labels[0]
    assert YOLODataset(path, obb=True).labels[0].keys() == oriented.labels[0].keys()
    assert oriented.get_item_raw(0)["rboxes"].shape == ref.labels[0]["rboxes"].shape


# -- the transforms ------------------------------------------------------------------------------------------------


def same_rboxes(port_ds, jax_ds):
    """The JAX dataset's labels with the port's rotated boxes (square frames: the same units), so that the transforms
    are held to each other apart from `min_area_rect` (held to cv2 above)."""
    for i in range(len(port_ds)):
        jax_ds.labels[i] = {**jax_ds.labels[i], "rboxes": port_ds.get_item_raw(i)["rboxes"]}
    return jax_ds


@pytest.mark.parametrize("hyp", [None, {"hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0}], ids=["hsv", "no_hsv"])
def test_obb_train_transforms_match_jax(dota, hyp):
    """OBBTrainTransforms (plan + CPU render) against the JAX OBBTrainTransforms on the same files, rotated boxes and
    RandomState seeds: the image bit for bit (letterbox with scaleup and the HSV tables; the plan's warp is the
    identity and moves no pixel), classes, mask and the rotated boxes (max_gt, 5) equal, bboxes zero."""
    port_ds, jax_ds, _ = dota
    jax_ds = same_rboxes(port_ds, jax_ds)
    port, ref = OBBTrainTransforms(IMGSZ, hyp, max_gt=3), JaxOBBTrainTransforms(IMGSZ, hyp, max_gt=3)
    cut = 0
    for i in range(len(port_ds)):
        a = port(port_ds, i, np.random.RandomState(100 + i))
        b = ref(jax_ds, i, np.random.RandomState(100 + i))
        assert a["img"].shape == (IMGSZ, IMGSZ, 3) and a["rboxes"].shape == (3, 5) and a["rboxes"].dtype == np.float32
        for k in ("img", "cls", "mask", "bboxes", "rboxes"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"sample {i} {k}")
        assert not a["bboxes"].any() and a["rboxes"][a["mask"]].all()
        cut += len(jax_ds.labels[i]["cls"]) > 3
    assert cut > 0


def test_loader_ships_rboxes(dota):
    """The loader's batches carry the rotated boxes (B, max_gt, 5) f32 beside the plans, the same for 1 and 4
    workers."""
    port_ds = dota[0]
    tf = OBBTrainTransforms(IMGSZ, max_gt=6)
    batches = []
    for workers in (1, 4):
        it = iter(DataLoader(port_ds, tf.plan, batch_size=4, workers=workers, shuffle=True, seed=2, infinite=True))
        batches.append(next(it))
        it.close()
    a, b = batches
    assert a["rboxes"].shape == (4, 6, 5) and a["rboxes"].dtype == np.float32 and a["mask"].any()
    for k in ("cls", "mask", "rboxes"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("max_gt", [3, 128])
def test_val_transforms_rboxes_match_jax(dota, max_gt):
    """`ValTransforms` (scaleup=False) hands on each frame's rotated boxes in letterbox pixels, (max_gt, 5) f32: on
    square frames, from the same rotated boxes, those of the JAX validator's `_gt_rboxes` bit for bit, for the rows
    the box labels keep."""
    port_ds, jax_ds, _ = dota
    jax_ds = same_rboxes(port_ds, jax_ds)
    tf = ValTransforms(IMGSZ, max_gt)
    jv = JaxValidator.__new__(JaxValidator)
    for i in range(len(port_ds)):
        s = tf(port_ds, i)
        batch = {"orig_shape": [s["orig_shape"]], "gain": [s["gain"]], "pad": [s["pad"]]}
        ref = jv._gt_rboxes(jax_ds, i, batch, 0)
        n = int(s["mask"].sum())
        assert s["rboxes"].shape == (max_gt, 5) and n == min(len(ref), max_gt) and not s["rboxes"][n:].any()
        np.testing.assert_array_equal(s["rboxes"][:n], ref[:n])


def test_probiou_matrix_matches_jax():
    """`probiou_matrix_np` (and the (0, n) and (m, 0) cases) equals the JAX numpy bit for bit."""
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(0, 64, (7, 4)), rng.uniform(-1, 2, (7, 1))], 1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 64, (9, 4)), rng.uniform(-1, 2, (9, 1))], 1).astype(np.float32)
    b[:3] = a[:3]
    got = probiou_matrix_np(a, b)
    np.testing.assert_array_equal(got, jax_probiou_matrix_np(a, b))
    assert got.shape == (7, 9) and (np.diag(got[:3, :3]) > 0.99).all()
    assert probiou_matrix_np(a[:0], b).shape == (0, 9) and probiou_matrix_np(a, b[:0]).shape == (7, 0)
