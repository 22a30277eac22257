"""The classification data path of the port against the JAX package's (`lpc_yolo_tpu/data/classify.py`), on the
CPU: the same class-folder sets (`make_cls_dataset`: PNG frames and their `.npy` twins) read by both.

* `check_cls_dataset`'s dict, the samples' order and labels of `ClassificationDataset`.
* `ClsTransforms` bytes: the square INTER_LINEAR resize (`data/cvops.py::resize`) against cv2's, on square and
  non-square frames (fx != fy), upscales, downscales and an exact 2x; the flip on the same `rng.rand()` draw.
* The loader's batches (train: shuffled, infinite, augmented; val: one pass, padded) over two epochs.
* The JAX val-label fault (ROADMAP Queue 3): the JAX dataset numbers a split's own folders, so a val split that
  lacks one of train's classes labels every later class one lower; the port labels by the dataset's names.
* `.npy` twins: `cache_images` reads them (the card's machine has no OpenCV), and they hold the PNGs' pixels.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

from lpc_yolo_tpu.data import DataLoader as JaxLoader
from lpc_yolo_tpu.data.classify import ClassificationDataset as JaxClsDataset
from lpc_yolo_tpu.data.classify import ClsTransforms as JaxClsTransforms
from lpc_yolo_tpu.data.classify import check_cls_dataset as jax_check_cls_dataset

from lpc_yolo_tpu_torch.data import ClassificationDataset, ClsTransforms, DataLoader, check_cls_dataset, make_cls_dataset

SHAPES = ((64, 64), (48, 80), (90, 60), (20, 36))


@pytest.fixture(scope="module")
def cls_root(tmp_path_factory):
    return make_cls_dataset(tmp_path_factory.mktemp("cls") / "set", n_train=5, n_val=3, nc=3, shapes=SHAPES)


def test_check_cls_dataset_and_samples_match_jax(cls_root):
    """The dataset dict, then each split's samples: paths in the same order and, where both splits hold every
    class, the same labels; with names the port's labels are those names' indices."""
    info = check_cls_dataset(cls_root)
    assert info == jax_check_cls_dataset(cls_root)
    assert info["names"] == {0: "class0", 1: "class1", 2: "class2"} and info["nc"] == 3
    for split in ("train", "val"):
        got = ClassificationDataset(info[split], imgsz=32, names=info["names"])
        ref = JaxClsDataset(info[split], imgsz=32, names=info["names"])
        assert got.samples == ref.samples and len(got) == len(ref) == 3 * (5 if split == "train" else 3)
        assert [lb for _, lb in got.samples] == sorted(lb for _, lb in got.samples)
        assert ClassificationDataset(info[split]).samples == got.samples  # the split's own folders: the same here
    with pytest.raises(FileNotFoundError):
        check_cls_dataset(Path(cls_root) / "nothing")


@pytest.mark.parametrize("imgsz", [32, 40, 96])
def test_cls_transforms_bytes_match_jax(cls_root, imgsz):
    """Every frame of the train split through both transforms: with augment off the resized bytes equal cv2's
    (32 from 64x64 is cv2's exact-2x INTER_AREA switch; 48x80, 90x60 and 20x36 resize with fx != fy, 96 and
    the 20x36 frame upscale); with augment on the same seeded draws flip the same frames."""
    info = check_cls_dataset(cls_root)
    got_ds, ref_ds = ClassificationDataset(info["train"], names=info["names"]), JaxClsDataset(info["train"])
    flips = 0
    for augment in (False, True):
        port, jax_t = ClsTransforms(imgsz, augment=augment), JaxClsTransforms(imgsz, augment=augment)
        for i in range(len(got_ds)):
            a = port(got_ds, i, np.random.RandomState(i))
            b = jax_t(ref_ds, i, np.random.RandomState(i))
            assert a["img"].shape == (imgsz, imgsz, 3) and a["img"].dtype == np.uint8
            np.testing.assert_array_equal(a["img"], b["img"])
            assert a["label"] == b["label"] and a["label"].dtype == np.int32
            if augment:
                plain = ClsTransforms(imgsz)(got_ds, i, None)
                flips += not np.array_equal(a["img"], plain["img"])
    assert 0 < flips < len(got_ds)


def test_loader_batches_match_jax(cls_root):
    """The train loader (shuffled, infinite, augmented, batch 4: the epoch's last batch padded) over two epochs,
    and the val loader's one pass: the same images, labels and pad counts as the JAX loader's."""
    info = check_cls_dataset(cls_root)
    got_ds = ClassificationDataset(info["train"], imgsz=32, names=info["names"])
    ref_ds = JaxClsDataset(info["train"], imgsz=32, names=info["names"])
    got = DataLoader(got_ds, ClsTransforms(32, augment=True), batch_size=4, workers=2, shuffle=True, infinite=True)
    ref = JaxLoader(ref_ds, JaxClsTransforms(32, augment=True), batch_size=4, workers=2, infinite=True)
    assert len(got) == len(ref) == 4
    gi, ri = iter(got), iter(ref)
    try:
        for _ in range(2 * len(got)):
            a, b = next(gi), next(ri)
            np.testing.assert_array_equal(a["img"], b["img"])
            np.testing.assert_array_equal(a["label"], b["label"])
            assert a["pad_count"] == b["pad_count"] and a["label"].dtype == np.int32
    finally:
        gi.close()
        ri.close()
    val = [ClassificationDataset(info["val"], imgsz=32, names=info["names"]), JaxClsDataset(info["val"], imgsz=32)]
    a_all = list(DataLoader(val[0], ClsTransforms(32), batch_size=4, workers=2))
    b_all = list(JaxLoader(val[1], JaxClsTransforms(32), batch_size=4, shuffle=False, workers=2))
    assert [b["pad_count"] for b in a_all] == [b["pad_count"] for b in b_all] == [0, 0, 3]
    for a, b in zip(a_all, b_all):
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_val_split_missing_a_class_keeps_its_labels(tmp_path):
    """A val split without class1: the JAX dataset numbers val's own folders (class0 -> 0, class2 -> 1) though the
    model's classes are train's (`check_cls_dataset`), so its class2 images carry label 1, class1's index; the
    port's carry 2, their index in the dataset's names. A folder the names lack is refused."""
    root = make_cls_dataset(tmp_path / "set", n_train=2, n_val=2, nc=3, skip_val=(1,))
    info = check_cls_dataset(root)
    assert info["nc"] == 3 and not (Path(info["val"]) / "class1").exists()
    truth = [int(Path(p).parent.name[-1]) for p, _ in ClassificationDataset(info["val"], names=info["names"]).samples]
    got = [lb for _, lb in ClassificationDataset(info["val"], names=info["names"]).samples]
    ref = [lb for _, lb in JaxClsDataset(info["val"], names=info["names"]).samples]
    assert truth == got == [0, 0, 2, 2]
    assert ref == [0, 0, 1, 1]  # the JAX fault: class2 labelled as class1
    with pytest.raises(ValueError, match="not among"):
        ClassificationDataset(info["train"], names={0: "class0", 1: "class2"})


def test_npy_twins_hold_the_png_pixels(cls_root, monkeypatch):
    """`cache_images` reads each frame's `.npy` twin (OpenCV is never called), and the twin holds cv2's decode
    of the PNG beside it."""
    info = check_cls_dataset(cls_root)
    ds = ClassificationDataset(info["val"], cache_images="disk")
    decoded = [cv2.imread(p) for p, _ in ds.samples]
    import lpc_yolo_tpu_torch.data.dataset as D

    def no_cv2(path):
        raise AssertionError(f"decoded {path}")

    monkeypatch.setattr(D, "imread", no_cv2)
    for i, im in enumerate(decoded):
        np.testing.assert_array_equal(ds.load_image(i), im)
    with pytest.raises(AssertionError, match="decoded"):
        ClassificationDataset(info["val"]).load_image(0)
