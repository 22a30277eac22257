"""The validation slice of the port against the JAX package, on the CPU.

A tiny YOLO-format dataset is written under a temp dir: six seeded noise
PNGs of mixed shapes (one smaller than imgsz, so that the validator's
`scaleup=False` matters; one a multiple of it; the rest downscaled), and one of
them without a label file. The labels are the JAX model's own strongest,
mutually non-overlapping detections on its own validation letterbox (boxes
that reach past the frame, as the random weights make them), so both
validators find true positives at high IoU and the mAP comparison is not
degenerate. Both packages run the full LPC-YOLO YAML on the same seeded
weights (the weight bridge, as tests/test_torch_slice.py does), f32, imgsz 64,
batch 4 over six images (a padded last batch).

The JAX facade is made without its constructor's random init (slow on a CPU,
and replaced by the seeded weights anyway); `val` is its own method.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import cv2
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from lpc_yolo_tpu.data import DataLoader as JaxDataLoader
from lpc_yolo_tpu.data import ValTransforms as JaxValTransforms
from lpc_yolo_tpu.data import YOLODataset as JaxDataset
from lpc_yolo_tpu.data.dataset import check_det_dataset as jax_check
from lpc_yolo_tpu.engine.model import YOLO as JaxYOLO
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.ops.letterbox import letterbox_geometry as jax_geometry
from lpc_yolo_tpu.ops.letterbox import letterbox_image
from lpc_yolo_tpu.ops.pallas_preprocess import build_letterbox_mats as jax_mats
from lpc_yolo_tpu.ops.pallas_preprocess import letterbox_pallas
from lpc_yolo_tpu.utils import cocoeval as jax_coco
from lpc_yolo_tpu.utils import metrics as jax_metrics

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import DataLoader, ValTransforms, YOLODataset, check_det_dataset
from lpc_yolo_tpu_torch.ops.letterbox import build_letterbox_mats, letterbox, letterbox_geometry, letterbox_tables
from lpc_yolo_tpu_torch.utils import cocoeval, metrics
from lpc_yolo_tpu_torch.utils.flax_bridge import random_variables
from lpc_yolo_tpu_torch.utils.compare import assert_val_results_agree

ROOT = Path(__file__).resolve().parents[1]
YAML = "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
JAX_YAML = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v10" / YAML
IMGSZ = 64
SHAPES = [(48, 40), (96, 128), (80, 60), (64, 64), (120, 90), (50, 70)]
UNLABELLED = 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_yolo():
    jm = jax_build(JAX_YAML)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True))
    jy = JaxYOLO.__new__(JaxYOLO)
    jy.model, jy.variables, jy.task = jm, random_variables(shapes, seed=0), "v10"
    jy.names = {i: str(i) for i in range(jm.nc)}
    return jy


def _letterboxed(img):
    """The JAX validator's input for one BGR frame: cv2 letterbox, scaleup=False, RGB in [0, 1]."""
    lb, gain, pad = letterbox_image(img, (IMGSZ, IMGSZ), scaleup=False)
    return lb[..., ::-1].astype(np.float32) / 255.0, gain, pad


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, jax_yolo):
    root = tmp_path_factory.mktemp("valslice")
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(7)
    predict = jax.jit(lambda v, x: jax_yolo.model.apply(v, x, training=False, predict_only=True)["det"])
    for i, (h0, w0) in enumerate(SHAPES):
        img = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "images" / "val" / f"{i}.png"), img)
        if i == UNLABELLED:
            continue
        x, gain, (pw, ph) = _letterboxed(img)
        det = np.asarray(predict(jax_yolo.variables, jnp.asarray(x[None])))[0]
        keep = []
        for row in det:  # strongest first; random weights give boxes that reach past the frame, kept as they are
            b = row[:4].astype(np.float64)
            if min(b[2] - b[0], b[3] - b[1]) < 4:
                continue
            if keep and metrics.box_iou_np(np.stack([k[0] for k in keep]), b[None]).max() > 0.4:
                continue
            keep.append((b, int(row[5])))
            if len(keep) == 3:
                break
        lines = []
        for b, c in keep:
            x1, y1, x2, y2 = (b - [pw, ph, pw, ph]) / gain
            lines.append(f"{c} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} {(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(lines) + "\n")
    data = {"path": str(root), "val": "images/val", "nc": 80, "names": {i: str(i) for i in range(80)}}
    (root / "data.yaml").write_text(yaml.safe_dump(data))
    return root / "data.yaml"


# ---------------------------------------------------------------- (a) dataset


def test_check_det_dataset_matches_jax(tmp_path):
    """User YAMLs (relative path, absolute path, list splits, names as a list) and dicts parse alike."""
    (tmp_path / "sub").mkdir()
    cases = [
        {"path": "sub", "train": "images/train", "val": "images/val", "names": ["a", "b"]},
        {"path": str(tmp_path / "sub"), "val": ["images/v1", "images/v2"], "nc": 3},
        {"val": "images/val", "test": "images/test", "names": {0: "x", 5: "y"}, "kpt_shape": [17, 3],
         "flip_idx": [0, 2, 1]},
    ]
    for k, d in enumerate(cases):
        p = tmp_path / f"d{k}.yaml"
        p.write_text(yaml.safe_dump(d))
        assert check_det_dataset(str(p)) == jax_check(str(p))
        assert check_det_dataset(p) == jax_check(p)
        assert check_det_dataset(d) == jax_check(d)


def test_bundled_dataset_name_is_not_ported():
    with pytest.raises(NotImplementedError, match="bundled"):
        check_det_dataset("coco8.yaml")


def _label_dir(tmp_path):
    """Box rows, polygon rows, blank lines, an empty label file and a missing one."""
    img_dir, lab_dir = tmp_path / "images" / "val", tmp_path / "labels" / "val"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    rows = {
        "a": "0 0.5 0.5 0.2 0.3\n\n3 0.25 0.75 0.1 0.1\n",
        "b": "2 0.1 0.1 0.4 0.1 0.3 0.5 0.05 0.3\n1 0.6 0.6 0.2 0.2\n",
        "c": "",
    }
    for stem in ("a", "b", "c", "d"):
        cv2.imwrite(str(img_dir / f"{stem}.jpg"), np.full((8, 8, 3), 100, np.uint8))
        if stem in rows:
            (lab_dir / f"{stem}.txt").write_text(rows[stem])
    return img_dir


def _assert_labels_equal(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert la.keys() == lb.keys() == {"cls", "bboxes", "segments"}
        np.testing.assert_array_equal(la["cls"], lb["cls"])
        np.testing.assert_array_equal(la["bboxes"], lb["bboxes"])
        assert la["cls"].dtype == lb["cls"].dtype and la["bboxes"].dtype == lb["bboxes"].dtype
        assert len(la["segments"]) == len(lb["segments"])
        for sa, sb in zip(la["segments"], lb["segments"]):
            np.testing.assert_array_equal(sa, sb)


def test_dataset_labels_match_jax(tmp_path):
    img_dir = _label_dir(tmp_path)
    port, ref = YOLODataset(img_dir, cache=False), JaxDataset(img_dir, cache=False)
    assert port.im_files == ref.im_files and port.label_files == ref.label_files
    _assert_labels_equal(port.labels, ref.labels)
    assert [len(lab["cls"]) for lab in port.labels] == [2, 2, 0, 0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_label_cache_serves_both_packages(tmp_path, writer):
    """A cache written by either package has the same name, hash and format, and both read it:
    labels marked in the cache file (cls + 7) come back from both, so neither parsed the files again."""
    img_dir = _label_dir(tmp_path)
    (YOLODataset if writer == "port" else JaxDataset)(img_dir, cache=True)
    cpath = img_dir.with_suffix(".labels.npz")
    z = np.load(cpath, allow_pickle=True)
    assert set(z.files) == {"hash", "labels"}
    assert str(z["hash"]) == YOLODataset(img_dir, cache=False)._hash() == JaxDataset(img_dir, cache=False)._hash()
    marked = [{**lab, "cls": lab["cls"] + 7} for lab in z["labels"]]
    np.savez_compressed(cpath, hash=z["hash"], labels=np.array(marked, dtype=object))
    _assert_labels_equal(YOLODataset(img_dir, cache=True).labels, marked)
    _assert_labels_equal(JaxDataset(img_dir, cache=True).labels, marked)


def test_disk_cache_reads_npy_twins_without_opencv(tmp_path, monkeypatch):
    """With cache_images='disk' an image whose .npy twin exists is read with np.load alone; one
    without a twin needs OpenCV, and without it the error names the way out."""
    img_dir = _label_dir(tmp_path)
    twin = np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    np.save(img_dir / "a.npy", twin)
    ds = YOLODataset(img_dir, cache_images="disk")
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    np.testing.assert_array_equal(ds.load_image(0), twin)
    with pytest.raises(ImportError, match="cache_images='disk'"):
        ds.load_image(1)
    monkeypatch.undo()
    im = ds.load_image(1)  # decoded once, then its twin is written
    np.testing.assert_array_equal(np.load(img_dir / "b.npy"), im)


def test_disk_cache_twin_is_never_read_half_written(tmp_path):
    """A worker thread that loads an image while another writes its .npy twin (the loader repeats
    the last sample of a padded batch) gets the whole frame: 8 readers load the image the moment
    its twin appears, while one thread decodes it and writes the twin; 5 rounds."""
    import threading

    img_dir = tmp_path / "images" / "val"
    img_dir.mkdir(parents=True)
    im = np.random.default_rng(1).integers(0, 256, (1000, 1500, 3), dtype=np.uint8)
    cv2.imwrite(str(img_dir / "a.png"), im)
    twin = img_dir / "a.npy"
    ds = YOLODataset(img_dir, cache=False, cache_images="disk")
    for _ in range(5):
        twin.unlink(missing_ok=True)
        got, errors = [], []

        def load(wait_for_twin):
            try:
                while wait_for_twin and not twin.exists():
                    pass
                got.append(ds.load_image(0))
            except Exception as e:  # collected and reported below
                errors.append(e)

        threads = [threading.Thread(target=load, args=(k > 0,)) for k in range(9)]
        for t in threads[1:] + threads[:1]:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert len(got) == 9 and all(np.array_equal(g, im) for g in got)
    assert sorted(p.name for p in img_dir.iterdir()) == ["a.npy", "a.png"]


# ------------------------------------------------------- (b) transforms, loader


def test_val_transforms_match_jax(dataset):
    """GT boxes, gain and pad equal the JAX package's to 1e-6; the port hands on the raw frame."""
    val = check_det_dataset(str(dataset))["val"]
    port, ref = YOLODataset(val), JaxDataset(val)
    tp, tr = ValTransforms(IMGSZ, max_gt=8), JaxValTransforms(IMGSZ, max_gt=8)
    for i in range(len(port)):
        a, b = tp(port, i), tr(ref, i)
        np.testing.assert_array_equal(a["img"], cv2.imread(ref.im_files[i]))
        np.testing.assert_allclose(a["bboxes"], b["bboxes"], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_array_equal(a["mask"], b["mask"])
        assert abs(a["gain"] - b["gain"]) <= 1e-6
        np.testing.assert_allclose(a["pad"], b["pad"], atol=1e-6, rtol=0)
        assert a["orig_shape"] == b["orig_shape"] and a["path"] == b["path"]
    assert port.labels[UNLABELLED]["cls"].size == 0


def test_loader_batches_match_jax(dataset):
    """Batch order, padding of the last batch (pad_count) and every label field as the JAX loader."""
    val = check_det_dataset(str(dataset))["val"]
    port = list(DataLoader(YOLODataset(val), ValTransforms(IMGSZ, 8), batch_size=4, workers=3))
    ref = list(JaxDataLoader(JaxDataset(val), JaxValTransforms(IMGSZ, 8), batch_size=4, shuffle=False, workers=3))
    assert [b["pad_count"] for b in port] == [b["pad_count"] for b in ref] == [0, 2]
    for a, b in zip(port, ref):
        assert a["path"] == b["path"] and a["orig_shape"] == b["orig_shape"]
        assert len(a["img"]) == len(b["img"]) == 4
        for k in ("cls", "bboxes", "mask", "gain", "pad"):
            np.testing.assert_allclose(np.asarray(a[k], np.float64), np.asarray(b[k], np.float64), atol=1e-6, rtol=0)


# ------------------------------------------------------- (c) letterbox, scaleup=False

LB_SHAPES = [(48, 40), (50, 70), (64, 64), (120, 90), (200, 100)]


@pytest.mark.parametrize("h0,w0", LB_SHAPES)
def test_scaleup_false_geometry_and_tables_match_jax(h0, w0):
    """Geometry, and the tables scattered back to the matrices, equal the JAX package's exactly."""
    assert letterbox_geometry((h0, w0), (IMGSZ, IMGSZ), scaleup=False) == \
        jax_geometry((h0, w0), (IMGSZ, IMGSZ), scaleup=False)
    for a, b in zip(build_letterbox_mats(h0, w0, IMGSZ, scaleup=False), jax_mats(h0, w0, IMGSZ, scaleup=False)):
        np.testing.assert_array_equal(a, b)
    if h0 <= IMGSZ and w0 <= IMGSZ:  # no resize: every content tap is the identity
        tab = letterbox_tables(h0, w0, IMGSZ, scaleup=False)
        rows = tab[0] >= 0
        assert rows.sum() == h0 and (tab[2][rows].view(np.float32) == 1).all() and (tab[3][rows] == 0).all()


@pytest.mark.parametrize("h0,w0", LB_SHAPES)
def test_scaleup_false_plain_matches_pallas_and_cv2(h0, w0):
    """u8 output: equal to the JAX Pallas kernel (interpret mode) on the scaleup=False matrices;
    against cv2's letterbox the repo's contract, <= 1 LSB at the 99.9th percentile and <= 2 max
    (cv2 resizes in fixed point; frames that are not resized are equal to it)."""
    img = np.random.default_rng(h0 * w0).integers(0, 256, (h0, w0, 3), dtype=np.uint8)
    got = letterbox(torch.from_numpy(img[None]), IMGSZ, out_dtype=torch.uint8, scaleup=False)[0].numpy()
    ry, rx, pad = map(jnp.asarray, jax_mats(h0, w0, IMGSZ, scaleup=False))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(letterbox_pallas(jnp.asarray(img), ry, rx, pad, size=IMGSZ, tile=IMGSZ, out_dtype=jnp.uint8))
    np.testing.assert_array_equal(got, ref)
    lb = letterbox_image(img, (IMGSZ, IMGSZ), scaleup=False)[0][..., ::-1]
    d = np.abs(got.astype(np.int32) - lb.astype(np.int32))
    assert np.percentile(d, 99.9) <= 1 and d.max() <= 2
    if h0 <= IMGSZ and w0 <= IMGSZ:
        assert d.max() == 0


# -------------------------------------------------------------- (d) metrics


def _match_inputs(seed, n=40, m=12):
    rng = np.random.default_rng(seed)
    gt = np.sort(rng.uniform(0, 60, (m, 4)).reshape(m, 2, 2), axis=1).reshape(m, 4)
    pred = gt[rng.integers(0, m, n)] + rng.normal(0, 3, (n, 4))
    pred[:, 2:] = np.maximum(pred[:, 2:], pred[:, :2] + 1)
    return gt, pred, rng.integers(0, 4, m).astype(np.float64), rng.integers(0, 4, n).astype(np.float64), rng.random(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_functions_match_jax(seed):
    """The port's copies of the metric functions give the JAX package's numbers exactly."""
    gt, pred, gt_cls, pred_cls, conf = _match_inputs(seed)
    iouv = np.linspace(0.5, 0.95, 10)
    iou = metrics.box_iou_np(gt, pred)
    np.testing.assert_array_equal(iou, jax_metrics.box_iou_np(gt, pred))
    tp = metrics.match_predictions(pred_cls, gt_cls, iou, iouv)
    np.testing.assert_array_equal(tp, jax_metrics.match_predictions(pred_cls, gt_cls, iou, iouv))
    assert tp.any()
    a, b = metrics.ap_per_class(tp, conf, pred_cls, gt_cls), jax_metrics.ap_per_class(tp, conf, pred_cls, gt_cls)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    rec, prec = np.sort(np.random.default_rng(seed).random(20)), np.random.default_rng(seed + 9).random(20)
    assert metrics.compute_ap(rec, prec)[0] == jax_metrics.compute_ap(rec, prec)[0]
    np.testing.assert_array_equal(metrics.smooth(prec, 0.1), jax_metrics.smooth(prec, 0.1))

    names = {i: str(i) for i in range(5)}
    dm, dj = metrics.DetMetrics(names).process(tp, conf, pred_cls, gt_cls), \
        jax_metrics.DetMetrics(names).process(tp, conf, pred_cls, gt_cls)
    assert dm.results_dict() == dj.results_dict()
    assert (dm.map75, dm.fitness) == (dj.map75, dj.fitness)
    np.testing.assert_array_equal(dm.maps, dj.maps)

    det = np.concatenate([pred, conf[:, None], pred_cls[:, None]], 1)
    cm, cj = metrics.ConfusionMatrix(5, conf=0.001), jax_metrics.ConfusionMatrix(5, conf=0.001)
    for c in (cm, cj):
        c.process_batch(det, gt, gt_cls)
        c.process_batch(None, gt[:3], gt_cls[:3])
        c.process_batch(det[:5], gt[:0], gt_cls[:0])
    np.testing.assert_array_equal(cm.matrix, cj.matrix)
    assert cm.matrix.sum() > 0


# ------------------------------------------------------ (e) val end to end


def test_val_matches_jax(dataset, jax_yolo):
    """YOLO(device='cpu').val against the JAX YOLO.val on the same weights and dataset: the same
    keys in the same order, the mAP keys and fitness to the last digit, precision and recall within 1e-9
    relative (`assert_val_results_agree` says why)."""
    ref = jax_yolo.val(data=str(dataset), imgsz=IMGSZ, batch=4, workers=2)
    yolo = YOLO(YAML, device="cpu", seed=None).load_flax(jax_yolo.variables)
    got = yolo.val(data=str(dataset), imgsz=IMGSZ, batch=4, workers=2)
    assert ref["metrics/mAP50(B)"] > 0.3  # the labels are the JAX model's own detections
    assert_val_results_agree(got, ref)
    assert all(np.isfinite(v) for v in got.values())
    assert set(yolo.validator.speed) == {"preprocess", "inference", "postprocess"}
    assert yolo.validator.dtype == torch.float32 and yolo.validator.device.type == "cpu"


# ------------------------------------------------------------ (f) COCO scoring


def test_save_json_coco_map_matches_jax(dataset, jax_yolo, tmp_path):
    """val(save_json=True): the port's COCO mAPs equal the JAX eval_json on the port's own prediction
    rows against the JAX package's annotations of the dataset; the port's COCOEvaluator gives the
    JAX one's 12 stats on those rows."""
    yolo = YOLO(YAML, device="cpu", seed=None).load_flax(jax_yolo.variables)
    got = yolo.val(data=str(dataset), imgsz=IMGSZ, batch=4, save_json=True, save_dir=str(tmp_path))
    preds = json.loads((tmp_path / "predictions.json").read_text())
    assert len(preds) > 0
    anno = jax_coco.yolo_dataset_to_coco(JaxDataset(check_det_dataset(str(dataset))["val"]))
    assert cocoeval.yolo_dataset_to_coco(YOLODataset(check_det_dataset(str(dataset))["val"])) == anno
    ref = jax_coco.eval_json(preds, anno)
    assert got["metrics/mAP50-95(COCO)"] == ref["mAP50-95"] and got["metrics/mAP50(COCO)"] == ref["mAP50"]
    assert ref["mAP50"] > 0.3
    assert cocoeval.eval_json(preds, anno) == ref
