"""The port's training data path against OpenCV and the JAX package, on the CPU.

`cvops` is held against cv2 (it reproduces OpenCV 5.0) op by op. `TrainTransforms`
and the loader are held against the JAX `TrainTransforms` and `DataLoader`
on the same files and `RandomState` seeds: labels and images exactly. The
dataset is the port's synthetic one, PNG + `.npy` twins, which cv2 decodes
losslessly for the JAX side; its frames are 120x200, 90x70, 64x128 and 40x48,
so that at imgsz 64 the mosaic tiles are downscaled (one exactly 2x, cv2's
INTER_AREA switch) and upscaled, and so is the letterbox.
"""

import importlib.util

import cv2
import numpy as np
import pytest
import torch

from lpc_yolo_tpu.data import DataLoader as JaxDataLoader
from lpc_yolo_tpu.data import TrainTransforms as JaxTrainTransforms
from lpc_yolo_tpu.data import YOLODataset as JaxDataset
from lpc_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic_dataset
from lpc_yolo_tpu.ops.letterbox import letterbox_image as jax_letterbox_image

from lpc_yolo_tpu_torch.data import (DataLoader, TrainTransforms, YOLODataset, check_det_dataset,
                                     make_synthetic_dataset, render)
from lpc_yolo_tpu_torch.data import cvops
from lpc_yolo_tpu_torch.data.augment import Plan, letterbox_canvas

SHAPES = ((120, 200), (90, 70), (64, 128), (40, 48))
IMGSZ = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))[None]


def assert_images_equal(got: np.ndarray, ref: np.ndarray, what: str) -> None:
    """The port's augmented images equal the JAX package's byte for byte. (The acceptance would allow
    mean |diff| <= 0.01 LSB and 0.1 % of the values more than 1 LSB off; the port reaches 0, and any
    miss grows through the HSV round trip, so the test holds it there.)"""
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8, what
    d = np.abs(got.astype(np.int32) - ref)
    assert d.max() == 0, f"{what}: {(d > 0).mean()} of the values off, mean {d.mean()}, max {d.max()}"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    info = check_det_dataset(make_synthetic_dataset(root, n_train=10, n_val=2, max_boxes=6, seed=3, shapes=SHAPES))
    return YOLODataset(info["train"], cache=False), JaxDataset(info["train"], cache=False)


@pytest.mark.parametrize("src, dst", [((1080, 810), (640, 480)), ((1000, 700), (640, 448)), ((720, 1280), (360, 640)),
                                      ((160, 160), (64, 64)), ((120, 200), (38, 64))])
def test_resize_downscale_bit_exact(src, dst):
    """cv2.resize INTER_LINEAR downscales, the exact 2x one through cv2's INTER_AREA switch."""
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,), dtype=np.uint8)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(cvops.resize(t(img), dst[::-1])[0].numpy(), ref)


@pytest.mark.parametrize("src, dst", [((333, 517), (412, 640)), ((360, 480), (480, 640)), ((48, 64), (85, 64)),
                                      ((37, 100), (246, 91))])
def test_resize_upscale_within_one_lsb(src, dst):
    """Upscales: the acceptance allows 1 LSB on at most 0.1 % of the values; the port is bit-exact."""
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,), dtype=np.uint8)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(cvops.resize(t(img), dst[::-1])[0].numpy(), ref)


@pytest.mark.parametrize("case", range(5))
def test_warp_affine_matches_cv2(case):
    """warpAffine INTER_LINEAR, border 114, of a mosaic-sized canvas (2s -> s) under the pipeline's kinds of
    matrix: scale + translate, rotation, shear, and scales that reach the border. Bit-exact."""
    rng = np.random.RandomState(case)
    s = 96
    img = rng.randint(0, 256, (2 * s, 2 * s, 3)).astype(np.uint8)
    if case % 2:  # smooth content, where 1-LSB steps would show
        img = cv2.GaussianBlur(img, (9, 9), 3)
    C = np.eye(3)
    C[:2, 2] = -s
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D(angle=(0.0, 7.5, -33.0, 90.0, 3.0)[case], center=(0, 0),
                                    scale=(0.5, 1.3, 0.77, 1.0, 0.4)[case])
    S = np.eye(3)
    S[0, 1] = np.tan(np.deg2rad(4.0)) if case == 2 else 0.0
    T = np.eye(3)
    T[:2, 2] = rng.uniform(0.4, 0.6, 2) * s
    M = (T @ S @ R @ C)[:2]
    ref = cv2.warpAffine(img, M, dsize=(s, s), borderValue=(114, 114, 114))
    np.testing.assert_array_equal(cvops.warp_affine(t(img), M, (s, s))[0].numpy(), ref)


def test_bgr2hsv_bit_exact_on_every_colour():
    v = np.arange(256, dtype=np.uint8)
    img = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(cvops.bgr2hsv(t(img))[0].numpy(), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


def test_hsv2bgr_within_one_lsb_on_every_hsv():
    """Every (h < 180, s, v): the acceptance allows 1 LSB; the port is bit-exact."""
    v = np.arange(256, dtype=np.uint8)
    hsv = np.stack(np.meshgrid(np.arange(180, dtype=np.uint8), v, v, indexing="ij"), -1).reshape(180 * 256, 256, 3)
    np.testing.assert_array_equal(cvops.hsv2bgr(t(hsv))[0].numpy(), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_lut_pad_flips_blend_bit_exact():
    rng = np.random.RandomState(7)
    a, b = (rng.randint(0, 256, (2, 40, 56, 3)).astype(np.uint8) for _ in range(2))
    tables = rng.randint(0, 256, (2, 3, 256)).astype(np.uint8)
    ref = np.stack([cv2.merge([cv2.LUT(c, tab) for c, tab in zip(cv2.split(im), tb)]) for im, tb in zip(a, tables)])
    np.testing.assert_array_equal(cvops.lut(torch.from_numpy(a), tables).numpy(), ref)
    # the host letterbox's resize and constant border (114) are the render's canvas fill: an identity warp of
    # the letterbox plan equals the JAX host letterbox (cv2.resize + copyMakeBorder with the +-0.1 side split)
    for h0, w0 in ((40, 48), (90, 70), (64, 48), (33, 64)):
        im = rng.randint(0, 256, (h0, w0, 3)).astype(np.uint8)
        canvas, _ = letterbox_canvas({"img": im, "bboxes": np.zeros((0, 4))}, 0, IMGSZ)
        plan = Plan(canvas, None, 0.0, np.eye(3), canvas.hw, None, False, False)
        ref = jax_letterbox_image(im, (IMGSZ, IMGSZ))[0]
        np.testing.assert_array_equal(render([plan], {0: im}, torch.device("cpu"))[0].numpy(), ref,
                                      err_msg=f"letterbox canvas of {h0}x{w0}")
    r = [rng.beta(32.0, 32.0) for _ in range(2)]  # Python floats, as the JAX mixup draws them
    ref = np.stack([(x.astype(np.float32) * ri + y.astype(np.float32) * (1 - ri)).astype(np.uint8)
                    for x, y, ri in zip(a, b, r)])
    np.testing.assert_array_equal(cvops.blend(torch.from_numpy(a), torch.from_numpy(b), r).numpy(), ref)
    # the flips are folded into the warp's output coordinates: an identity warp mirrored
    minv = torch.tensor([[[1.0, 0, 0], [0, 1, 0]]] * 2)
    const = lambda v: torch.full((2,), v)  # noqa: E731
    flipped = cvops.warp_core(torch.from_numpy(a).reshape(-1, 3), torch.arange(2) * 40 * 56, const(56), const(40),
                              const(56), minv, (40, 56), torch.tensor([True, False]), torch.tensor([True, True]))
    np.testing.assert_array_equal(flipped.numpy(), np.stack([a[0][::-1, ::-1], a[1][:, ::-1]]))


@pytest.mark.parametrize("hyp", [None, {"mosaic": 0}, {"mixup": 1.0}], ids=["mosaic", "letterbox", "mixup"])
def test_train_transforms_match_jax(dataset, hyp):
    """TrainTransforms (plan + CPU render) against the JAX TrainTransforms on the same files and seeds."""
    assert importlib.util.find_spec("albumentations") is None  # else the JAX transforms draw once more
    port_ds, jax_ds = dataset
    port, ref = TrainTransforms(IMGSZ, hyp, max_gt=24), JaxTrainTransforms(IMGSZ, hyp, max_gt=24)
    for i in range(len(port_ds)):
        a = port(port_ds, i, np.random.RandomState(100 + i))
        b = ref(jax_ds, i, np.random.RandomState(100 + i))
        for k in ("cls", "bboxes", "mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"sample {i} {k}")
        assert b["mask"].any()
        assert_images_equal(a["img"], b["img"], f"sample {i}")


def test_batched_render_equals_per_sample(dataset):
    """One render of a batch that mixes mosaics, a mixup and letterboxes equals each plan rendered alone."""
    port_ds, _ = dataset
    plans = [TrainTransforms(IMGSZ, hyp).plan(port_ds, i, np.random.RandomState(i))
             for i, hyp in enumerate([None, {"mixup": 1.0}, {"mosaic": 0}, {"mosaic": 0, "degrees": 10}])]
    sources = {k: v for p in plans for k, v in p["sources"].items()}
    batch = render([p["plan"] for p in plans], sources, torch.device("cpu"))
    for i, p in enumerate(plans):
        alone = render([p["plan"]], p["sources"], torch.device("cpu"))[0]
        np.testing.assert_array_equal(batch[i].numpy(), alone.numpy())


def test_loader_matches_jax_over_two_epochs(dataset):
    """The infinite, shuffled, seeded loader against the JAX DataLoader: 2 epochs of the 10 frames at batch 4,
    the last batch of each epoch padded with 2 repeats."""
    port_ds, jax_ds = dataset
    port = iter(DataLoader(port_ds, TrainTransforms(IMGSZ, max_gt=24), batch_size=4, workers=3, shuffle=True,
                           seed=5, infinite=True))
    ref = iter(JaxDataLoader(jax_ds, JaxTrainTransforms(IMGSZ, max_gt=24), batch_size=4, workers=3, shuffle=True,
                             seed=5, infinite=True))
    pads = []
    for n in range(6):
        a, b = next(port), next(ref)
        assert a["pad_count"] == b["pad_count"]
        pads.append(a["pad_count"])
        for k in ("cls", "bboxes", "mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"batch {n} {k}")
        assert_images_equal(a["img"], b["img"], f"batch {n}")
    assert pads == [0, 0, 2, 0, 0, 2]


def test_loader_is_deterministic_across_workers(dataset):
    """The trainer's loader (plans) with 1 and 4 workers: the same plans, labels and rendered batches."""
    port_ds, _ = dataset
    tt = TrainTransforms(IMGSZ, {"mixup": 0.5}, max_gt=24)
    one, four = (iter(DataLoader(port_ds, tt.plan, batch_size=4, workers=w, shuffle=True, seed=9, infinite=True))
                 for w in (1, 4))
    for _ in range(3):
        a, b = next(one), next(four)
        for k in ("cls", "bboxes", "mask"):
            np.testing.assert_array_equal(a[k], b[k])
        assert [p.canvas for p in a["plan"]] == [p.canvas for p in b["plan"]]
        cpu = torch.device("cpu")
        np.testing.assert_array_equal(render(a["plan"], a["sources"], cpu).numpy(),
                                      render(b["plan"], b["sources"], cpu).numpy())


def test_synthetic_dataset_labels_equal_jax(tmp_path):
    """The same RandomState draws as the JAX generator: equal label files; the PNG decodes to its .npy twin."""
    port = make_synthetic_dataset(tmp_path / "port", n_train=5, n_val=3, imgsz=96, nc=4, max_boxes=5, seed=2)
    ref = jax_make_synthetic_dataset(tmp_path / "jax", n_train=5, n_val=3, imgsz=96, nc=4, max_boxes=5, seed=2)
    for split in ("train", "val"):
        pl = sorted((tmp_path / "port" / "labels" / split).glob("*.txt"))
        jl = sorted((tmp_path / "jax" / "labels" / split).glob("*.txt"))
        assert [f.name for f in pl] == [f.name for f in jl] and len(pl) in (5, 3)
        assert [f.read_text() for f in pl] == [f.read_text() for f in jl]
        for png in sorted((tmp_path / "port" / "images" / split).glob("*.png")):
            np.testing.assert_array_equal(cv2.imread(str(png)), np.load(png.with_suffix(".npy")))
    assert check_det_dataset(port)["names"] == check_det_dataset(ref)["names"]
