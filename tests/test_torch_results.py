"""The port's serving remainder against the JAX package and OpenCV, on the CPU.

* `data/cvops.py::find_external_contours` against cv2.findContours
  (RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) point for point and in order on 400
  seeded masks (noise, rectangles with holes and islands in them, blobs,
  masks touching the frame, lone pixels, diagonal chains) and
  `contour_area` against cv2.contourArea; `Masks.xy`, `.xyn`,
  `masks2segments` and `scale_image` against the JAX ones bit for bit and
  `scale_masks` within 5e-6 (3e-7 of the exact contraction).
* `data/png.py` against cv2.imread bit for bit: files cv2 writes (grey,
  BGR, BGRA; 8 and 16 bits; compression 0 to 9), grey + alpha, and files
  written here with each of the five row filters; `load_source` and
  `imread` reading PNGs with cv2 unimportable.
* `Results`: `summary`, `tojson`, `verbose` and `save_txt` string for
  string with the JAX ones; `plot` bit for bit (boxes, track ids, masks,
  keypoints, probs); an OBB result's rotated boxes (the JAX `plot` draws
  their hulls: ROADMAP Queue 3); `save_crop` and `save` file for file;
  7-column `Boxes`; the identity device moves; ImportErrors without cv2.
* `v10_postprocess`, `v10_detections` and `regularize_rboxes` against JAX.
* `predict(stream=True)` against `predict()`, and the save family's files
  against the JAX `Predictor` writing the same Results (images, a directory
  of PNGs, a video), with full-width yolov10n at imgsz 64.
"""

import copy
import struct
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp
from lpc_yolo_tpu.engine import results as JR
from lpc_yolo_tpu.ops import masks as JMK
from lpc_yolo_tpu.ops.boxes import regularize_rboxes as jax_regularize
from lpc_yolo_tpu.ops.postprocess import v10_detections as jax_v10_detections
from lpc_yolo_tpu.ops.postprocess import v10_postprocess as jax_v10_postprocess
from lpc_yolo_tpu.utils.plotting import Annotator as JAnnotator

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data.cvops import contour_area, find_external_contours
from lpc_yolo_tpu_torch.data.dataset import imread
from lpc_yolo_tpu_torch.data.png import read_png
from lpc_yolo_tpu_torch.engine import results as TR
from lpc_yolo_tpu_torch.engine.predictor import load_source
from lpc_yolo_tpu_torch.ops import masks as TMK
from lpc_yolo_tpu_torch.ops.boxes import regularize_rboxes
from lpc_yolo_tpu_torch.ops.postprocess import v10_detections, v10_postprocess

ROOT = Path(__file__).resolve().parents[1]
NAMES = {0: "person", 1: "car", 2: "dog", 3: "traffic light"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- contours ------------------------------------------------------------------------------------------------


def seeded_masks(kind: str, n: int, seed: int):
    """n masks of one kind, 1 to 40 px a side."""
    import scipy.ndimage as nd

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(1, 41, 2))
        if kind == "noise":
            m = rng.random((h, w)) < rng.uniform(0.1, 0.9)
        elif kind == "rects":  # rectangles, some with a hole and an island inside it
            m = np.zeros((h, w), bool)
            for _ in range(rng.integers(1, 5)):
                y0, x0 = rng.integers(0, h), rng.integers(0, w)
                y1, x1 = rng.integers(y0, h + 1), rng.integers(x0, w + 1)
                m[y0:y1 + 1, x0:x1 + 1] = True
                if y1 - y0 > 4 and x1 - x0 > 4 and rng.random() < 0.6:
                    m[y0 + 1:y1 - 1, x0 + 1:x1 - 1] = False
                    m[(y0 + y1) // 2, (x0 + x1) // 2] = True
        elif kind == "blobs":
            m = nd.gaussian_filter(rng.random((h, w)), rng.uniform(0.5, 3)) > 0.5
        else:  # sparse pixels and diagonal chains, many touching the frame
            m = rng.random((h, w)) < 0.08
            for _ in range(rng.integers(0, 4)):
                y, x = rng.integers(0, h), rng.integers(0, w)
                d = rng.choice([-1, 1])
                for k in range(rng.integers(1, 12)):
                    if 0 <= y + k < h and 0 <= x + d * k < w:
                        m[y + k, x + d * k] = True
        out.append((m * rng.integers(1, 256)).astype(np.uint8))  # any nonzero value is foreground
    return out


@pytest.mark.parametrize("kind", ["noise", "rects", "blobs", "sparse"])
def test_contours_match_cv2(kind):
    """100 masks of each kind: the same contours as cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE), in
    its order, each from its start pixel, point for point; contour_area equal to cv2.contourArea."""
    for i, m in enumerate(seeded_masks(kind, 100, seed=["noise", "rects", "blobs", "sparse"].index(kind))):
        ref = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
        got = find_external_contours(m)
        assert len(got) == len(ref), f"{kind} mask {i}"
        for a, b in zip(got, ref):
            assert a.dtype == np.int32 and np.array_equal(a, b), f"{kind} mask {i}"
            assert contour_area(a) == cv2.contourArea(b)


def test_contour_edge_cases():
    """Empty and full masks, a lone pixel in each corner, a ring with an island in its hole (only the ring),
    a 1-px wall between the outside and a hole, and float contours' areas."""
    cases = [np.zeros((5, 7), np.uint8), np.ones((5, 7), np.uint8), np.ones((1, 1), np.uint8)]
    corners = np.zeros((6, 6), np.uint8)
    corners[[0, 0, 5, 5], [0, 5, 0, 5]] = 1
    ring = np.zeros((9, 9), np.uint8)
    ring[1:8, 1:8] = 1
    ring[2:7, 2:7] = 0
    ring[4, 4] = 1
    wall = np.zeros((6, 8), np.uint8)
    wall[:, 0] = 1
    wall[0, :] = wall[-1, :] = wall[:, -1] = 1
    for m in cases + [corners, ring, wall]:
        ref = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
        got = find_external_contours(m)
        assert len(got) == len(ref) and all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert len(find_external_contours(ring)) == 1
    pts = np.random.default_rng(0).uniform(0, 50, (7, 1, 2)).astype(np.float32)
    assert contour_area(pts) == cv2.contourArea(pts)


def frame_masks(n: int, hw, seed: int) -> np.ndarray:
    """(n, h, w) bool masks of ellipses, some of two parts, some empty."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, *hw), np.uint8)
    for i in range(n):
        for _ in range(rng.integers(0, 3)):
            c = (int(rng.integers(0, hw[1])), int(rng.integers(0, hw[0])))
            ax = (int(rng.integers(2, 20)), int(rng.integers(2, 20)))
            cv2.ellipse(out[i], c, ax, float(rng.uniform(0, 180)), 0, 360, 1, -1)
    return out.astype(bool)


def test_masks_polygons_match_jax():
    """`Masks.xy` and `.xyn` (the largest outer border by area) and `masks2segments` ("largest" by points,
    and "concat") equal the JAX ones, which call cv2, bit for bit; `scale_image` of uint8 and f32 arrays
    equal the JAX one (cv2.resize); `scale_masks` is within 3e-7 of its weights contracted in f64, and within
    5e-6 of the JAX one (jax.image.resize: the same weights, XLA's f32 contraction up to ~2e-6 off)."""
    masks = frame_masks(12, (72, 96), seed=3)
    ours, theirs = TR.Masks(masks, (72, 96)), JR.Masks(masks, (72, 96))
    for a, b in zip(ours.xy, theirs.xy):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(ours.xyn, theirs.xyn))
    for strategy in ("largest", "concat"):
        assert all(np.array_equal(a, b) for a, b in zip(TMK.masks2segments(masks, strategy),
                                                        JMK.masks2segments(masks, strategy)))
    rng = np.random.default_rng(4)
    for dtype, channels in ((np.uint8, None), (np.uint8, 1), (np.uint8, 3), (np.uint8, 5), (np.float32, None),
                            (np.float32, 3), (np.float32, 4)):
        shape = (64, 64) if channels is None else (64, 64, channels)
        arr = (rng.random(shape) * 255).astype(dtype)
        for im0 in ((48, 64), (100, 75), (30, 90), (64, 64)):
            a, b = TMK.scale_image(arr, im0), JMK.scale_image(arr, im0)
            assert a.shape == b.shape and np.array_equal(a, b), (dtype, channels, im0)
    m = rng.random((3, 64, 64)).astype(np.float32)
    for shape in ((48, 64), (200, 150), (40, 70), (64, 64)):
        for padding in (True, False):
            got = TMK.scale_masks(torch.from_numpy(m), shape, padding).numpy()
            ref = np.asarray(JMK.scale_masks(jnp.asarray(m), shape, padding))
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6)
            if not padding:  # the same weights contracted in f64: XLA's f32 einsum is up to ~2e-6 off it
                exact = np.einsum("chw,hH,wW->cHW", m.astype(np.float64),
                                  TMK._triangle_weights(64, shape[0]).double().numpy(),
                                  TMK._triangle_weights(64, shape[1]).double().numpy())
                np.testing.assert_allclose(got, exact, rtol=0, atol=3e-7)


# -- PNG -----------------------------------------------------------------------------------------------------


def png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def write_filtered_png(path, arr: np.ndarray, ctype: int, filters) -> None:
    """A PNG of arr (h, w, c) uint8 or uint16 in colour type `ctype`, row y filtered with filters[y % len]."""
    h, w, c = arr.shape
    depth = 16 if arr.dtype == np.uint16 else 8
    bpp = c * depth // 8
    raw = [list(arr[y].astype(">u2" if depth == 16 else np.uint8).tobytes()) for y in range(h)]
    out, prior = bytearray(), [0] * len(raw[0])
    for y, row in enumerate(raw):
        f = filters[y % len(filters)]
        line = []
        for i, v in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, cc = prior[i], prior[i - bpp] if i >= bpp else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            line.append((v - pred) & 255)
        out += bytes([f] + line)
        prior = row
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                           + png_chunk(b"IDAT", zlib.compress(bytes(out), 6)) + png_chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
def test_png_reader_matches_cv2_imread(depth, tmp_path):
    """Grey, BGR and BGRA images cv2 writes at every compression level 0..9, and grey, grey + alpha, RGB and
    RGBA files written here with each of the five filters (and all five in turn): `read_png` gives
    cv2.imread's array bit for bit."""
    rng = np.random.default_rng(depth)
    dtype, top = (np.uint8, 256) if depth == 8 else (np.uint16, 65536)
    n = 0
    for channels in (1, 3, 4):
        for level in range(10):
            h, w = (int(v) for v in rng.integers(1, 30, 2))
            arr = rng.integers(0, top, (h, w, channels), dtype=np.int64).astype(dtype)
            arr[: h // 2] = (np.arange(w, dtype=np.int64)[None, :, None] * 37 % top).astype(dtype)  # smooth rows
            f = tmp_path / f"cv{channels}_{level}.png"
            cv2.imwrite(str(f), arr[..., 0] if channels == 1 else arr, [cv2.IMWRITE_PNG_COMPRESSION, level])
            assert np.array_equal(read_png(f), cv2.imread(str(f))), f.name
            n += 1
    for ctype, channels in ((0, 1), (4, 2), (2, 3), (6, 4)):
        for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
            arr = rng.integers(0, top, (9, 11, channels), dtype=np.int64).astype(dtype)
            arr[3:6] = arr[2:3]  # rows that repeat: up and paeth predict them exactly
            f = tmp_path / f"own{ctype}_{''.join(map(str, filters))}.png"
            write_filtered_png(f, arr, ctype, filters)
            ref = cv2.imread(str(f))
            assert ref is not None and np.array_equal(read_png(f), ref), f.name
            n += 1
    assert n == 54


def test_png_read_without_opencv(tmp_path, monkeypatch):
    """With cv2 unimportable, `load_source` (a directory, a glob, a path) and the dataset's `imread` read PNG
    files as cv2.imread does; a JPEG, a video and a palette PNG (outside the reader's scope) raise an
    ImportError that names the file; a PIL image needs no cv2 either."""
    from PIL import Image

    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (20 + i, 30, 3), dtype=np.uint8) for i in range(3)]
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"f{i}.png"), f)
    (tmp_path / "notes.txt").write_text("not an image")
    (tmp_path / "other").mkdir()
    cv2.imwrite(str(tmp_path / "other" / "x.jpg"), frames[0])
    Image.fromarray(frames[1][..., ::-1]).convert("P").save(tmp_path / "other" / "pal.png")
    pil = Image.fromarray(frames[2][..., ::-1])
    monkeypatch.setitem(sys.modules, "cv2", None)
    for src in (tmp_path, str(tmp_path / "f*.png"), [str(tmp_path / f"f{i}.png") for i in range(3)]):
        got = load_source(src)
        assert [Path(p).name for p, _ in got] == ["f0.png", "f1.png", "f2.png"]
        assert all(np.array_equal(a, b) for (_, a), b in zip(got, frames))
    assert np.array_equal(imread(str(tmp_path / "f1.png")), frames[1])
    assert np.array_equal(load_source(pil)[0][1], frames[2])
    for name in ("x.jpg", "pal.png"):
        with pytest.raises(ImportError, match=name):
            load_source(tmp_path / "other" / name)
    monkeypatch.undo()
    assert np.array_equal(load_source(tmp_path / "other" / "pal.png")[0][1], cv2.imread(str(tmp_path / "other" / "pal.png")))


# -- Results ------------------------------------------------------------------------------------------------


def result_pair(kind: str, seed: int = 0):
    """(port Results, JAX Results) over the same frame and rows."""
    rng = np.random.default_rng(seed)
    h, w = 120, 160
    im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    n = 5
    xy = rng.uniform(0, [w - 40, h - 40], (n, 2))
    wh = rng.uniform(8, 40, (n, 2))
    conf = rng.uniform(0.25, 0.99, (n, 1))
    cls = rng.integers(0, 4, (n, 1)).astype(np.float64)
    boxes = np.concatenate([xy, xy + wh, conf, cls], 1).astype(np.float32)
    kw = {}
    if kind == "track":
        boxes = np.concatenate([boxes[:, :4], rng.permutation(np.arange(1, n + 1))[:, None], boxes[:, 4:]], 1)
    elif kind == "masks":
        kw["masks"] = frame_masks(n, (h, w), seed)
    elif kind == "keypoints":
        kp = np.concatenate([rng.uniform(0, [w, h], (n, 17, 2)), rng.uniform(0, 1, (n, 17, 1))], -1)
        kw["keypoints"] = kp.astype(np.float32)
    if kind == "probs":
        p = rng.random(len(NAMES)).astype(np.float32)
        return (TR.Results(im, "a/im.jpg", NAMES, probs=p / p.sum()),
                JR.Results(im, "a/im.jpg", NAMES, probs=p / p.sum()))
    return TR.Results(im, "a/im.jpg", NAMES, boxes=boxes, **kw), JR.Results(im, "a/im.jpg", NAMES, boxes=boxes, **kw)


KINDS = ["boxes", "track", "masks", "keypoints", "probs"]


@pytest.mark.parametrize("kind", KINDS)
def test_results_text_matches_jax(kind, tmp_path):
    """summary (pixels and normalised), tojson / to_json, verbose and save_txt (with and without conf) give
    the JAX strings; an empty Results too."""
    ours, theirs = result_pair(kind)
    for norm in (False, True):
        assert ours.summary(normalize=norm) == theirs.summary(normalize=norm)
        assert ours.tojson(normalize=norm) == theirs.tojson(normalize=norm) == ours.to_json(normalize=norm)
    assert ours.verbose() == theirs.verbose()
    for conf in (False, True):
        ours.save_txt(str(tmp_path / "a" / f"{conf}.txt"), save_conf=conf)
        theirs.save_txt(str(tmp_path / "b" / f"{conf}.txt"), save_conf=conf)
        assert (tmp_path / "a" / f"{conf}.txt").read_text() == (tmp_path / "b" / f"{conf}.txt").read_text()
    assert ours.new().verbose() == theirs.new().verbose() == "(no detections), "
    assert ours.new().summary() == theirs.new().summary() == []


@pytest.mark.parametrize("kind", KINDS)
def test_plot_matches_jax(kind, tmp_path):
    """`plot` (and with other options) equals the JAX plot bit for bit; `save` writes the same file;
    `save_crop` writes the same crops under the same names."""
    ours, theirs = result_pair(kind, seed=1)
    for kw in ({}, {"conf": False}, {"labels": False, "line_width": 3}, {"boxes": False, "masks": False}):
        assert np.array_equal(ours.plot(**kw), theirs.plot(**kw)), kw
    ours.save(str(tmp_path / "ours.png"))
    theirs.save(str(tmp_path / "theirs.png"))
    assert (tmp_path / "ours.png").read_bytes() == (tmp_path / "theirs.png").read_bytes()
    for r, d in ((ours, "a"), (theirs, "b")):
        r.save_crop(tmp_path / d, file_name="im.jpg")
        r.save_crop(tmp_path / d, file_name="im.jpg")  # the second takes im1.jpg, im2.jpg, ...
    files = lambda d: sorted(p.relative_to(tmp_path / d) for p in (tmp_path / d).rglob("*.jpg"))  # noqa: E731
    assert files("a") == files("b")
    assert all((tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes() for f in files("a"))
    assert (len(files("a")) == 0) == (kind == "probs")


def test_obb_plot_draws_rotated_boxes():
    """An OBB result's plot draws its rotated boxes, as the reference does: the JAX Annotator's rotated
    box_label of each row's corners. The JAX Results.plot draws the rows' axis-aligned hulls instead (its
    `rotated` test reads the 6-wide hull rows): a JAX fault, ROADMAP Queue 3."""
    rng = np.random.default_rng(2)
    im = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    rb = np.concatenate([rng.uniform(40, 100, (3, 2)), rng.uniform(10, 40, (3, 2)), rng.uniform(0, 3, (3, 1)),
                         rng.uniform(0.3, 0.9, (3, 1)), rng.integers(0, 4, (3, 1))], 1).astype(np.float32)
    ours = TR.Results(im, "o.jpg", NAMES, boxes=np.concatenate([TR.OBBoxes(rb, im.shape[:2]).xyxy, rb[:, 5:]], 1),
                      obb=rb)
    ann = JAnnotator(im.copy())
    from lpc_yolo_tpu.utils.plotting import colors

    for corners, row in zip(ours.obb.xyxyxyxy, rb):
        ann.box_label(corners, f"{NAMES[int(row[6])]} {row[5]:.2f}", color=colors(int(row[6]), bgr=True), rotated=True)
    assert np.array_equal(ours.plot(), ann.result())
    theirs = JR.Results(im, "o.jpg", NAMES, boxes=ours.boxes.data, obb=rb)
    assert not np.array_equal(theirs.plot(), ours.plot())


def test_boxes_layouts_and_device_moves():
    """6- and 7-column Boxes read conf and cls at -2 and -1 and the id at column 4, as the JAX Boxes; a flat
    row of 7 is one tracked box; 5 columns raise. cpu, numpy, cuda and to are the identity on Boxes, OBBoxes,
    Masks, Probs and Results; update replaces rows."""
    six = np.array([[1, 2, 30, 40, 0.9, 3], [5, 6, 7, 8, 0.5, 1]], np.float32)
    seven = np.array([[1, 2, 30, 40, 7, 0.9, 3]], np.float32)
    for data in (six, seven, seven[0]):
        a, b = TR.Boxes(data, (50, 60)), JR.Boxes(data, (50, 60))
        for attr in ("xyxy", "conf", "cls", "xywh", "xyxyn", "xywhn", "id"):
            x, y = getattr(a, attr), getattr(b, attr)
            assert (x is None and y is None) or np.array_equal(x, y), attr
    assert TR.Boxes(seven, (50, 60)).id.tolist() == [7]
    with pytest.raises(ValueError, match="6 or 7"):
        TR.Boxes(np.zeros((2, 5)), (50, 60))
    r = TR.Results(np.zeros((50, 60, 3), np.uint8), "x.jpg", NAMES, boxes=six, masks=np.zeros((2, 50, 60), bool),
                   obb=np.zeros((2, 7), np.float32), probs=np.ones(4, np.float32) / 4)
    for obj in (r, r.boxes, r.obb, r.masks, r.probs):
        assert obj.cpu() is obj and obj.numpy() is obj and obj.cuda() is obj and obj.to("cuda") is obj
    assert r.update(boxes=seven).boxes.id.tolist() == [7] and len(r) == 1


def test_drawing_without_opencv_raises(monkeypatch):
    """Without cv2, plot, save, save_crop and the save family raise an ImportError that names the feature;
    summary, verbose and save_txt need none."""
    ours, _ = result_pair("boxes")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="drawing a box"):
        ours.plot()
    with pytest.raises(ImportError, match="saving a crop"):
        ours.save_crop("unused")
    assert ours.verbose() and ours.summary()


def test_v10_decode_and_regularize_match_jax():
    """v10_postprocess and v10_detections (tied scores on a 1/8 grid, max_det over and under the pool) and
    regularize_rboxes equal the JAX functions bit for bit."""
    rng = np.random.default_rng(0)
    p = rng.random((2, 100, 11)).astype(np.float32)
    p[..., 4:] = np.round(p[..., 4:] * 8) / 8
    for max_det in (300, 20):
        got = v10_postprocess(torch.from_numpy(p), max_det, 7)
        ref = jax_v10_postprocess(jnp.asarray(p), max_det, 7)
        assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(got, ref))
        assert np.array_equal(v10_detections(torch.from_numpy(p), max_det, 7).numpy(),
                              np.asarray(jax_v10_detections(jnp.asarray(p), max_det, 7)))
    r = (rng.random((64, 5)) * [100, 100, 50, 50, 7] - [0, 0, 0, 0, 3.5]).astype(np.float32)
    r[:8, 3] = r[:8, 2]  # w == h
    assert np.array_equal(regularize_rboxes(torch.from_numpy(r)).numpy(), np.asarray(jax_regularize(jnp.asarray(r))))


# -- predict(stream=True) and the save family ----------------------------------------------------------------

S = 64


@pytest.fixture(scope="module")
def v10n():
    return YOLO("yolov10n.yaml", device="cpu", seed=0)


@pytest.fixture(scope="module")
def jax_predictor_cls():
    """A JAX Predictor class over the JAX yolov10n graph (never run: its stream is replaced)."""
    from lpc_yolo_tpu.engine.predictor import Predictor
    from lpc_yolo_tpu.nn import build_model

    model = build_model(ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v10" / "yolov10n.yaml")
    return lambda **kw: Predictor(model, None, task="v10", imgsz=S, names=dict(NAMES), **kw)


def clip_frames(n: int, seed: int = 31):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (72, 96, 3), dtype=np.uint8)
    return [np.ascontiguousarray(np.roll(base, 4 * i, axis=0)) for i in range(n)]


def test_predict_stream_matches_list(v10n, tmp_path):
    """`predict(stream=True)` and `yolo(source, stream=True)` are generators whose items equal `predict()`'s
    list; a glob of PNGs predicts what the frames predict; an unknown option raises."""
    frames = clip_frames(5)
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"f{i}.png"), f)
    ref = v10n.predict(frames, imgsz=S, conf=0.3, batch=2)
    for gen in (v10n.predict(frames, imgsz=S, conf=0.3, batch=2, stream=True),
                v10n(frames, imgsz=S, conf=0.3, batch=2, stream=True)):
        assert isinstance(gen, types.GeneratorType)
        got = list(gen)
        assert len(got) == 5 and all(np.array_equal(a.boxes.data, b.boxes.data) for a, b in zip(got, ref))
    files = v10n.predict(str(tmp_path / "*.png"), imgsz=S, conf=0.3, batch=2)
    assert all(np.array_equal(a.boxes.data, b.boxes.data) for a, b in zip(files, ref))
    with pytest.raises(TypeError, match="save_json"):
        v10n.predict(frames, save_json=True)


def tree(d: Path):
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def test_save_family_matches_jax_predictor(v10n, jax_predictor_cls, tmp_path):
    """predict(save, save_txt, save_conf, save_crop) writes what the JAX Predictor writes for the same
    Results: the annotated frames under their names, labels/<stem>.txt, crops/<class>/<stem>.jpg; a video's
    frames into <stem>.avi and labels/<stem>_<frame>.txt. project/name give runs that increment."""
    frames = clip_frames(4)
    src = tmp_path / "src"
    src.mkdir()
    for i, f in enumerate(frames[:2]):
        cv2.imwrite(str(src / f"im{i}.png"), f)
    vid = tmp_path / "clip.avi"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (96, 72))
    for f in frames:
        w.write(f)
    w.release()
    flags = dict(save=True, save_txt=True, save_conf=True, save_crop=True)
    for source in (src, vid):
        ours = tmp_path / f"ours_{source.name}"
        res = v10n.predict(source, imgsz=S, conf=0.3, save_dir=ours, **flags)
        jp = jax_predictor_cls(save_dir=str(tmp_path / f"jax_{source.name}"), **flags)
        jp._stream = lambda _src, res=res: iter(copy.deepcopy(res))
        assert len(jp(source)) == len(res)
        a, b = tree(ours), tree(tmp_path / f"jax_{source.name}")
        assert a.keys() == b.keys() and len(a) > 3
        assert all(a[k] == b[k] for k in a if not k.endswith(".avi"))  # the same labels, images and crops
    assert {"clip.avi", "labels/clip_0.txt", "labels/clip_3.txt"} <= set(tree(tmp_path / "ours_clip.avi"))
    gen = v10n.predict(frames[:1], imgsz=S, conf=0.3, save_txt=True, project=tmp_path / "runs", name="exp",
                       stream=True)
    assert isinstance(gen, types.GeneratorType) and not (tmp_path / "runs").exists()
    list(gen)
    v10n.predict(frames[:1], imgsz=S, conf=0.3, save_txt=True, project=tmp_path / "runs", name="exp")
    assert sorted(p.name for p in (tmp_path / "runs").iterdir()) == ["exp", "exp2"]
    assert (tmp_path / "runs" / "exp2" / "labels" / "image0.txt").exists()
