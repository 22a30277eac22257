"""mosaic9, copy_paste and the perspective warp of the port's training transforms, on the CPU.

Each is held against the JAX package's transforms (`lpc_yolo_tpu/data/augment.py`: `mosaic9` :299,
`copy_paste` :367, `random_perspective` with `perspective` != 0 :205-255) on the same files and
`RandomState` seeds: the port's plan rendered on the CPU equals the JAX sample bit for bit, and the
labels exactly. `cvops.warp_perspective` is held to `cv2.warpPerspective`. The dataset is the synthetic
one of `tests/test_torch_data.py` (frames 120x200, 90x70, 64x128 and 40x48 at imgsz 64, so tiles are
down- and upscaled and mosaic9's tiles overlap).
"""

import importlib.util

import cv2
import numpy as np
import pytest
import torch

from lpc_yolo_tpu.data import YOLODataset as JaxDataset
from lpc_yolo_tpu.data.augment import PoseTrainTransforms as JaxPoseTrainTransforms
from lpc_yolo_tpu.data.augment import SegTrainTransforms as JaxSegTrainTransforms
from lpc_yolo_tpu.data.augment import TrainTransforms as JaxTrainTransforms

from lpc_yolo_tpu_torch.data import (DataLoader, PoseTrainTransforms, SegTrainTransforms, TrainTransforms,
                                     YOLODataset, check_det_dataset, cvops, make_synthetic_dataset, render)
from lpc_yolo_tpu_torch.data.augment import OBBTrainTransforms

SHAPES = ((120, 200), (90, 70), (64, 128), (40, 48))
IMGSZ = 64
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug")
    info = check_det_dataset(make_synthetic_dataset(root, n_train=10, n_val=2, max_boxes=6, seed=3, shapes=SHAPES))
    return YOLODataset(info["train"], cache=False), JaxDataset(info["train"], cache=False)


def assert_sample_equal(a: dict, b: dict, keys, what: str) -> None:
    for k in keys:
        assert a[k].dtype == b[k].dtype, f"{what} {k}: {a[k].dtype} != {b[k].dtype}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


HYPS = {"mosaic9": {"mosaic9": 1.0}, "mosaic9_mixup": {"mosaic9": 0.5, "mixup": 0.5},
        "copy_paste": {"copy_paste": 0.5}, "perspective": {"perspective": 0.0005},
        "perspective_strong": {"perspective": 0.005, "degrees": 20.0, "shear": 3.0},
        "all": {"mosaic9": 0.5, "mixup": 0.5, "copy_paste": 1.0, "perspective": 0.001, "flipud": 0.5}}


@pytest.mark.parametrize("hyp", list(HYPS.values()), ids=list(HYPS))
def test_train_transforms_match_jax(dataset, hyp):
    """TrainTransforms (plan + CPU render) against the JAX TrainTransforms, 10 frames x 3 seeds: pixels bit for
    bit, classes, boxes and mask exactly."""
    assert importlib.util.find_spec("albumentations") is None  # else the JAX transforms draw once more
    port_ds, jax_ds = dataset
    port, ref = TrainTransforms(IMGSZ, hyp, max_gt=48), JaxTrainTransforms(IMGSZ, hyp, max_gt=48)
    n9 = pasted = 0
    for seed in (100, 200, 300):
        for i in range(len(port_ds)):
            rng = np.random.RandomState(seed + i)
            plan = port.plan(port_ds, i, np.random.RandomState(seed + i))["plan"]
            n9 += len(plan.canvas.tiles) == 9
            pasted += 0 if plan.paste is None else len(plan.paste)
            assert plan.perspective == bool(hyp.get("perspective"))
            a = port(port_ds, i, np.random.RandomState(seed + i))
            b = ref(jax_ds, i, rng)
            assert_sample_equal(a, b, ("img", "cls", "bboxes", "mask"), f"seed {seed} sample {i}")
    if hyp.get("mosaic9"):
        assert n9 > 0
    if hyp.get("copy_paste"):
        assert pasted > 0


def test_mosaic9_tiles_overlap_and_the_later_wins(dataset):
    """A mosaic9 canvas whose tiles overlap (frames of different sizes): the render paints the later tile over
    the earlier, as the JAX canvas does, and leaves 114 where no tile lies."""
    port_ds, jax_ds = dataset
    port, ref = TrainTransforms(IMGSZ, {"mosaic9": 1.0}), JaxTrainTransforms(IMGSZ, {"mosaic9": 1.0})
    overlaps = 0
    for i in range(len(port_ds)):
        tiles = port.plan(port_ds, i, np.random.RandomState(7 + i))["plan"].canvas.tiles
        rects = [t.rect for t in tiles if t.rect[2] > t.rect[0] and t.rect[3] > t.rect[1]]
        overlaps += any(max(a[0], b[0]) < min(a[2], b[2]) and max(a[1], b[1]) < min(a[3], b[3])
                        for j, a in enumerate(rects) for b in rects[j + 1:])
        assert_sample_equal(port(port_ds, i, np.random.RandomState(7 + i)), ref(jax_ds, i, np.random.RandomState(7 + i)),
                            ("img", "cls", "bboxes", "mask"), f"sample {i}")
    assert overlaps > 0


def test_copy_paste_chains_read_earlier_pastes():
    """Pastes whose crops overlap earlier pastes' targets: the render's mirror chain equals the JAX loop of
    crops pasted one after another (each reading the image as the earlier pastes left it)."""
    from lpc_yolo_tpu.data.augment import copy_paste as jax_copy_paste

    from lpc_yolo_tpu_torch.data.augment import Canvas, Plan, Tile, copy_paste

    rng = np.random.RandomState(0)
    s = 64
    img = rng.randint(0, 256, (s, s, 3)).astype(np.uint8)
    checked = 0
    for seed in range(40):
        r = np.random.RandomState(seed)
        xy = r.uniform(0, s - 8, (8, 2))
        boxes = np.concatenate([xy, xy + r.uniform(3, 30, (8, 2))], 1).clip(0, s).astype(np.float32)
        cls = np.arange(8, dtype=np.int32)
        ref_img, ref_boxes, ref_cls = jax_copy_paste(img, boxes, cls, np.random.RandomState(seed), 1.0)
        got_boxes, got_cls, crops = copy_paste(boxes, cls, np.random.RandomState(seed), 1.0, s)
        np.testing.assert_array_equal(got_boxes, ref_boxes)
        np.testing.assert_array_equal(got_cls, ref_cls)
        tile = Tile(0, (s, s), (s, s), (0, 0, s, s), (0, 0))
        plan = Plan(Canvas((s, s), (tile,)), None, 0.0, np.eye(3), (s, s), None, False, False,
                    crops if len(crops) else None)
        np.testing.assert_array_equal(render([plan], {0: img}, CPU)[0].numpy(), ref_img, err_msg=f"seed {seed}")
        checked += len(crops) > 1
    assert checked > 5


@pytest.mark.parametrize("case", range(6))
def test_warp_perspective_matches_cv2(case):
    """warpPerspective INTER_LINEAR, border 114, of a mosaic-sized canvas (2s -> s) under the pipeline's kinds of
    matrix with perspective terms from 1e-4 to 3e-3 of a pixel; output widths that are multiples of 16 (cv2's
    vector loop). Bit-exact."""
    rng = np.random.RandomState(case)
    s = (32, 64, 96, 160, 64, 96)[case]
    img = rng.randint(0, 256, (2 * s, 2 * s, 3)).astype(np.uint8)
    if case % 2:
        img = cv2.GaussianBlur(img, (9, 9), 3)
    C = np.eye(3)
    C[:2, 2] = -s
    P = np.eye(3)
    P[2, :2] = rng.uniform(-1, 1, 2) * (5e-4, 1e-3, 3e-3, 1e-4, 2e-3, 5e-4)[case]
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D(angle=rng.uniform(-40, 40), center=(0, 0), scale=rng.uniform(0.5, 1.5))
    S = np.eye(3)
    S[0, 1] = np.tan(np.deg2rad(rng.uniform(-5, 5)))
    T = np.eye(3)
    T[:2, 2] = rng.uniform(0.4, 0.6, 2) * s
    M = T @ S @ R @ P @ C
    ref = cv2.warpPerspective(img, M, dsize=(s, s), borderValue=(114, 114, 114))
    got = cvops.warp_perspective(torch.from_numpy(img)[None], M, (s, s))[0].numpy()
    np.testing.assert_array_equal(got, ref)
    ok, inv = cv2.invert(M, flags=cv2.DECOMP_LU)
    np.testing.assert_array_equal(cvops.invert_perspective(M), inv)


@pytest.fixture(scope="module")
def seg_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug_seg")
    info = check_det_dataset(make_synthetic_dataset(root, n_train=10, n_val=2, max_boxes=6, seed=3, shapes=SHAPES,
                                                    segments=True))
    return YOLODataset(info["train"], cache=False), JaxDataset(info["train"], cache=False)


@pytest.mark.parametrize("hyp", [{"perspective": 0.0005}, {"perspective": 0.003, "mosaic": 0.0, "degrees": 10.0}],
                         ids=["mosaic", "letterbox"])
def test_seg_transforms_with_perspective_match_jax(seg_dataset, hyp):
    """SegTrainTransforms with the perspective warp: the polygons divided by w in f64, the image, labels and
    every instance mask bit for bit against the JAX transform."""
    port_ds, jax_ds = seg_dataset
    port, ref = SegTrainTransforms(IMGSZ, hyp, max_gt=24), JaxSegTrainTransforms(IMGSZ, hyp, max_gt=24)
    for i in range(len(port_ds)):
        a = port(port_ds, i, np.random.RandomState(100 + i))
        b = ref(jax_ds, i, np.random.RandomState(100 + i))
        assert_sample_equal(a, b, ("img", "cls", "bboxes", "mask", "masks"), f"sample {i}")


@pytest.fixture(scope="module")
def pose_dataset(tmp_path_factory):
    from test_torch_pose_data import add_keypoints

    root = tmp_path_factory.mktemp("aug_pose")
    data = make_synthetic_dataset(root, n_train=10, n_val=2, max_boxes=6, seed=3, shapes=SHAPES)
    info = check_det_dataset(add_keypoints(data, (4, 3), [1, 0, 3, 2]))
    kw = dict(cache=False, kpt_shape=info["kpt_shape"])
    return YOLODataset(info["train"], **kw), JaxDataset(info["train"], **kw), info


@pytest.mark.parametrize("hyp", [{"perspective": 0.0005}, {"perspective": 0.004, "degrees": 15.0}],
                         ids=["mild", "strong"])
def test_pose_transforms_with_perspective_match_jax(pose_dataset, hyp):
    """PoseTrainTransforms with the perspective warp: keypoints divided by w, those off the canvas made
    invisible; the image and labels bit for bit against the JAX transform."""
    port_ds, jax_ds, info = pose_dataset
    kw = dict(max_gt=24, kpt_shape=info["kpt_shape"], flip_idx=info["flip_idx"])
    port, ref = PoseTrainTransforms(IMGSZ, hyp, **kw), JaxPoseTrainTransforms(IMGSZ, hyp, **kw)
    for i in range(len(port_ds)):
        a = port(port_ds, i, np.random.RandomState(100 + i))
        b = ref(jax_ds, i, np.random.RandomState(100 + i))
        assert_sample_equal(a, b, ("img", "cls", "bboxes", "mask", "keypoints"), f"sample {i}")


def test_batched_render_equals_per_sample(dataset):
    """One render of a batch that mixes mosaic9 and mosaic4 canvases, mixup, copy_paste and letterboxes equals
    each plan rendered alone; a batch of perspective plans too; mixing affine and perspective plans raises."""
    port_ds, _ = dataset
    hyps = [{"mosaic9": 1.0, "copy_paste": 1.0}, {"mosaic9": 1.0, "mixup": 1.0}, None, {"mosaic": 0},
            {"copy_paste": 1.0, "mixup": 1.0}]
    for persp in (0.0, 0.002):
        plans = [TrainTransforms(IMGSZ, {**(hyp or {}), "perspective": persp}).plan(port_ds, i, np.random.RandomState(i))
                 for i, hyp in enumerate(hyps)]
        sources = {k: v for p in plans for k, v in p["sources"].items()}
        batch = render([p["plan"] for p in plans], sources, CPU)
        for i, p in enumerate(plans):
            alone = render([p["plan"]], p["sources"], CPU)[0]
            np.testing.assert_array_equal(batch[i].numpy(), alone.numpy(), err_msg=f"perspective {persp} plan {i}")
    mixed = [TrainTransforms(IMGSZ, {"perspective": v}).plan(port_ds, 0, np.random.RandomState(0)) for v in (0, 1e-3)]
    with pytest.raises(ValueError, match="perspective"):
        render([p["plan"] for p in mixed], mixed[0]["sources"], CPU)


def test_loader_is_deterministic_across_workers(dataset):
    """The trainer's loader of mosaic9 / copy_paste / perspective plans with 1 and 4 workers: the same plans,
    labels and rendered batches."""
    port_ds, _ = dataset
    tt = TrainTransforms(IMGSZ, {"mosaic9": 0.5, "copy_paste": 0.5, "mixup": 0.3, "perspective": 5e-4}, max_gt=48)
    one, four = (iter(DataLoader(port_ds, tt.plan, batch_size=4, workers=w, shuffle=True, seed=9, infinite=True))
                 for w in (1, 4))
    for _ in range(3):
        a, b = next(one), next(four)
        for k in ("cls", "bboxes", "mask"):
            np.testing.assert_array_equal(a[k], b[k])
        assert [p.canvas for p in a["plan"]] == [p.canvas for p in b["plan"]]
        np.testing.assert_array_equal(render(a["plan"], a["sources"], CPU).numpy(),
                                      render(b["plan"], b["sources"], CPU).numpy())


def test_unknown_hyp_keys_are_refused():
    """A hyp key that no transform reads (the JAX transforms ignore it) raises, naming it; every transform."""
    for kind in (TrainTransforms, SegTrainTransforms, PoseTrainTransforms, OBBTrainTransforms):
        with pytest.raises(NotImplementedError, match="erasing"):
            kind(IMGSZ, {"erasing": 0.4})
        kind(IMGSZ, {"mosaic9": 0.5, "copy_paste": 0.3, "perspective": 1e-3})
