"""Serving predictor: frames -> device letterbox -> the model graph -> decode -> Results.

Counterpart of `lpc_yolo_tpu/engine/predictor.py::Predictor` (:87-363), v10,
v8 and segment paths: a v10Detect model decodes its one-to-one branch by the
NMS-free top-k, a Detect or Segment model through `decode_feats` and
`non_max_suppression` at `conf` and `iou`, one candidate per anchor (:200),
its greedy loop one launch of the NMS kernel per batch. A World model reads
the facade's text table (1, M, 512) broadcast to the batch (:154-159) and
decodes M classes as a Detect model decodes nc. A Segment model's
masks follow the JAX predictor (:190-199, :328-340): each row's mask
coefficients gathered by its anchor, `process_mask(..., upsample=True)`, the
letterbox pad cropped, cv2's f32 linear resize to the frame and `> 0.5`,
into `Results.masks` (n, h0, w0) bool. The JAX predictor decodes all
`max_det` rows of a batch; here only the rows above `conf` that `Results`
keeps are decoded, on the device, one frame at a time (identical values:
the others are never read). A Pose model's keypoints follow the JAX
predictor (:175-180, :341-349): each row's decoded keypoints gathered by its
anchor, the kept rows' un-letterboxed with the predictor's own gain and pad
((k - pad) / gain in f32, no clip), into `Results.keypoints` (n, K, 3) f32.
A keypoint set of ndim 2 raises NotImplementedError: the JAX predictor
reshapes its rows by nk // 3 (:344). An OBB model's rows come from `nms_rotated`
(best class per anchor, :181-190) and follow the JAX predictor (:293-320):
the rows above conf, the letterbox undone on the rotated parameters (the
angle is scale-invariant) into `Results.obb` (n, 7) f32, and their
axis-aligned hulls as `Results.boxes`. A Classify model's softmax (B, nc) f32 goes to each
frame's `Results.probs` (`Probs`), with the JAX predictor's `speed` split (:283-290: its
"postprocess" is 0). The JAX predictor letterboxes on the host with
cv2 to uint8 (:261) and folds /255 into the stem (:148-151); the card's
machine has no cv2, so here every frame is letterboxed on the device by the
letterbox kernel, as uint8, straight into its slot of the NHWC input batch
(same-shape frames in one launch), then cast to the serving dtype. The model is a BN-folded serving
copy (`nn/fuse.py`) with /255 folded into its stem, so its 3x3 s1 convs run
through the conv3x3 kernel. The conf filter and `scale_boxes` back to each
frame follow the JAX predictor (:322-327), and so does `Results.speed`
(:358-362): "preprocess" is the host's time to pin, copy and enqueue the
letterbox, "inference" runs until the detections are on the host,
"postprocess" is the conf filter and unscaling, each per frame.

`Predictor(...)(source, stream=True)` is a generator that yields each frame's
Results as its batch comes off the card (JAX :202-218); the save family
(save, save_txt, save_conf, save_crop, save_dir, project, name, exist_ok)
writes each Results before it is yielded, into `utils/infra.py::get_save_dir`
with the JAX layout (:220-250). Sources are loaded as the JAX `load_source`
loads them (:39-84): ndarrays, PIL images, paths, directories, globs, videos;
PNG files are read without OpenCV (`data/png.py`), every other image or video
file with cv2, and the save family draws and writes with cv2: without it these
raise an ImportError that names the file or the feature.
"""

from __future__ import annotations

import copy
import glob
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..nn.fuse import fold_preprocess, fuse_conv_bn
from ..nn.quant import quantize_serving
from ..ops.boxes import rbox_hull, scale_boxes
from ..ops.letterbox import letterbox
from ..ops.masks import process_kept_rows, unletterbox_masks
from ..data.png import read_image
from ..utils import require_cv2, resolve_device
from ..utils.infra import get_save_dir
from .results import Results

IMG_SUFFIXES = {".bmp", ".dng", ".jpeg", ".jpg", ".mpo", ".png", ".tif", ".tiff", ".webp", ".pfm"}
VID_SUFFIXES = {".asf", ".avi", ".gif", ".m4v", ".mkv", ".mov", ".mp4", ".mpeg", ".mpg", ".ts", ".wmv", ".webm"}


def load_source(source) -> List[Tuple[str, np.ndarray]]:
    """Resolve a source into [(path, HWC uint8 BGR frame)] (JAX :39-84).

    ndarrays, PIL images (told by their class name; PIL is not imported) and
    lists of any source need nothing else; a glob, a directory (its image and
    video files, sorted) or a file path is read file by file: PNGs without
    OpenCV (`data/png.py::read_image`), other images and every frame of a
    video with cv2, imported only for them.
    """
    if isinstance(source, (list, tuple)):
        out: List[Tuple[str, np.ndarray]] = []
        for s in source:
            out.extend(load_source(s))
        return out
    if isinstance(source, np.ndarray):
        if source.dtype != np.uint8 or source.ndim != 3 or source.shape[2] != 3:
            raise ValueError(f"expected an (h, w, 3) uint8 BGR frame, got {source.shape} {source.dtype}")
        return [("image0.jpg", source)]
    if source.__class__.__name__ == "Image":  # a PIL image, duck-typed
        return [("image0.jpg", np.ascontiguousarray(np.asarray(source.convert("RGB"))[..., ::-1]))]
    p = str(source)
    if any(c in p for c in "*?[") and not os.path.exists(p):
        files = sorted(glob.glob(p, recursive=True))
    elif os.path.isdir(p):
        files = sorted(str(f) for f in Path(p).iterdir() if f.suffix.lower() in IMG_SUFFIXES | VID_SUFFIXES)
    else:
        files = [p]
    out = []
    for f in files:
        if Path(f).suffix.lower() in VID_SUFFIXES:
            cap = require_cv2(f"reading the video {f}").VideoCapture(f)
            i = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                out.append((f"{f}#frame{i}", frame))
                i += 1
            cap.release()
        else:
            out.append((f, read_image(f)))
    return out


def serving_model(model, device: torch.device, dtype: torch.dtype, int8: bool = True):
    """The serving copy of `model`: BN folded once in f32, then every tensor in `dtype`,
    so its 3x3 s1 convs take the conv3x3 kernel; it takes the raw 0..255 frame (/255
    folded into the stem, as the JAX predictor and validator fold it). A module that sets
    `keeps_f32` (a World model's contrastive heads, which compute in f32, their BatchNorm
    unfolded) keeps f32 parameters. Where the model carries calibrated `int8_scales`
    (`YOLO.quantize_int8`) and `int8` is set, its int8 sites serve through the s8 kernels
    (`nn/quant.py::quantize_serving`). The caller's model is left as it was."""
    serving = copy.deepcopy(model).to(device).eval()
    fuse_conv_bn(serving, dtype)
    fold_preprocess(serving, dtype)
    serving.to(dtype)
    for m in serving.modules():
        if getattr(m, "keeps_f32", False):
            m.float()
    scales = getattr(model, "int8_scales", None)
    if int8 and scales is not None:
        quantize_serving(serving, scales)
    return serving


def letterbox_batch(frames: List[np.ndarray], size: int, device: torch.device, out_dtype: torch.dtype,
                    scaleup: bool = True) -> torch.Tensor:
    """Letterbox HWC uint8 BGR frames into one (n, S, S, 3) RGB batch on `device`.

    Frames of one shape are stacked, copied from pinned memory and letterboxed
    into their slots by one launch of the letterbox kernel.
    """
    x = torch.empty((len(frames), size, size, 3), dtype=out_dtype, device=device)
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for j, im in enumerate(frames):
        groups.setdefault(im.shape, []).append(j)
    for slots in groups.values():
        src = torch.from_numpy(np.stack([frames[j] for j in slots]))
        if device.type == "cuda":
            src = src.pin_memory().to(device, non_blocking=True)
        letterbox(src, size, out=x, slots=slots, scaleup=scaleup)
    return x


class Predictor:
    """Batched predictor over a built DetectionModel (weights as loaded)."""

    def __init__(self, model, imgsz: int = 640, batch: int = 1, conf: float = 0.25, iou: float = 0.45,
                 max_det: int = 300, names: Optional[Dict[int, str]] = None,
                 device: Union[str, torch.device, None] = None, dtype: Optional[torch.dtype] = None,
                 text: Optional[np.ndarray] = None, save: bool = False, save_txt: bool = False,
                 save_conf: bool = False, save_crop: bool = False, save_dir: Optional[Union[str, Path]] = None,
                 project: Optional[Union[str, Path]] = None, name: Optional[str] = None, exist_ok: bool = False):
        self.device = resolve_device(device)
        # a World model's text table (1, M, 512), broadcast to each batch (JAX :154-159)
        self.text = None if text is None else torch.as_tensor(np.asarray(text, np.float32), device=self.device)
        # bf16 on the card, f32 on the CPU unless the caller says otherwise
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.imgsz, self.batch, self.conf, self.iou, self.max_det = imgsz, batch, conf, iou, max_det
        self.names = names or {i: str(i) for i in range(model.nc)}
        self.model = serving_model(model, self.device, self.dtype)
        self.kpt_shape = self.model.model[-1].kpt_shape if self.model.task == "pose" else None
        if self.kpt_shape is not None and self.kpt_shape[1] != 3:
            raise NotImplementedError(f"predict of a kpt_shape {self.kpt_shape} model is not ported: the JAX predictor "
                                      f"reshapes keypoint rows by nk // 3 (lpc_yolo_tpu/engine/predictor.py:344)")
        # what to write of each result (JAX :117-131): the annotated frame or video, labels/, crops/
        self.save, self.save_txt, self.save_conf, self.save_crop = save, save_txt, save_conf, save_crop
        self.save_dir: Optional[Path] = None
        if save or save_txt or save_crop:
            task = "detect" if self.model.task in ("v10", "v8", "world", "rtdetr") else self.model.task
            self.save_dir = Path(save_dir) if save_dir else get_save_dir(task, "predict", project, name, exist_ok)
        self._writers: Dict[str, object] = {}

    def preprocess(self, frames: List[np.ndarray]) -> torch.Tensor:
        """Letterbox frames to uint8 (the rounded frame cv2 gives the JAX predictor), as a
        (n, 3, S, S) channels_last batch on the device in the model's dtype, 0..255."""
        return letterbox_batch(frames, self.imgsz, self.device, torch.uint8).permute(0, 3, 1, 2).to(self.dtype)

    @torch.inference_mode()
    def infer(self, frames: List[np.ndarray]):
        """(n, max_det, 6) detections in letterbox pixels, f32, on the device; for a segment model
        with the rows' mask coefficients and the prototypes, for a pose model with the rows' keypoints;
        for an OBB model (n, max_det, 7) rotated rows; for a classify model (n, nc) probabilities
        (`DetectionModel.predict`)."""
        return self.model.predict(self.preprocess(frames), self.max_det, self.conf, self.iou,
                                  text=self.batch_text(len(frames)))

    def batch_text(self, n: int) -> Optional[torch.Tensor]:
        """The text table broadcast to a batch of n frames, (n, M, 512) f32; None for a model without text."""
        return None if self.text is None else self.text.expand(n, -1, -1)

    @torch.inference_mode()
    def frame_masks(self, det: torch.Tensor, mc: torch.Tensor, proto: torch.Tensor, keep: np.ndarray,
                    orig_shape) -> Optional[np.ndarray]:
        """One frame's masks for its kept rows: (n, h0, w0) bool on the host, None when none is kept."""
        if not keep.any():
            return None
        m = process_kept_rows(proto, mc, det, keep, self.imgsz)
        return unletterbox_masks(m, self.imgsz, orig_shape).cpu().numpy()

    def frame_keypoints(self, kpt: np.ndarray, keep: np.ndarray, orig_shape) -> Optional[np.ndarray]:
        """One frame's kept rows' keypoints (n, K, 3) f32 in frame pixels, as the JAX predictor unscales them
        (:341-349): its own gain and (pw, ph), no clip; None when no row is kept."""
        if not keep.any():
            return None
        kp = kpt[keep].reshape(int(keep.sum()), *self.kpt_shape).copy()
        gain = min(self.imgsz / orig_shape[0], self.imgsz / orig_shape[1])
        pw, ph = (self.imgsz - orig_shape[1] * gain) / 2, (self.imgsz - orig_shape[0] * gain) / 2
        kp[..., 0] = (kp[..., 0] - pw) / gain
        kp[..., 1] = (kp[..., 1] - ph) / gain
        return kp

    def frame_obb(self, det: np.ndarray, orig_shape) -> Tuple[np.ndarray, np.ndarray]:
        """One frame's rotated rows above conf in frame pixels, as the JAX predictor unscales them
        (:293-320): (hull boxes (n, 6), rotated rows (n, 7)), f32. The hull is `rbox_hull`'s, as the JAX validator
        takes it; the JAX predictor's closed form |w/2 cos| + |h/2 sin| differs from it by rounding."""
        rows = det[det[:, 5] > self.conf]
        gain = min(self.imgsz / orig_shape[0], self.imgsz / orig_shape[1])
        pw, ph = (self.imgsz - orig_shape[1] * gain) / 2, (self.imgsz - orig_shape[0] * gain) / 2
        rb = rows[:, :5].copy()
        rb[:, 0] = (rb[:, 0] - pw) / gain
        rb[:, 1] = (rb[:, 1] - ph) / gain
        rb[:, 2:4] /= gain
        hull = rbox_hull(torch.from_numpy(rb)).numpy()
        return np.concatenate([hull, rows[:, 5:7]], -1), np.concatenate([rb, rows[:, 5:7]], -1)

    def postprocess(self, det: np.ndarray, im0: np.ndarray) -> np.ndarray:
        """Rows above conf, boxes scaled back to the frame: (n, 6)."""
        rows = det[det[:, 4] > self.conf]
        boxes = scale_boxes((self.imgsz, self.imgsz), torch.from_numpy(rows[:, :4]), im0.shape[:2]).numpy()
        return np.concatenate([boxes, rows[:, 4:6]], axis=-1)

    def __call__(self, source, stream: bool = False):
        """The Results of every frame: a list, or with `stream` a generator that yields them frame by frame."""
        gen = self.stream_inference(source)
        return gen if stream else list(gen)

    def stream_inference(self, source) -> Iterator[Results]:
        """Results frame by frame, each written as the save flags ask before it is yielded (JAX :206-218)."""
        if self.save_dir is None:
            yield from self._stream(source)
            return
        try:
            for r in self._stream(source):
                self._persist(r)
                yield r
        finally:
            for w in self._writers.values():
                w.release()
            self._writers.clear()

    def _persist(self, r: Results) -> None:
        """Write one result into save_dir as the JAX predictor does (:220-250): with `save` the annotated
        frame under its file name (a video's frames into <stem>.avi, MJPG at the video's rate), with
        `save_txt` labels/<stem>.txt (a video frame's labels/<stem>_<frame>.txt), with `save_crop`
        crops/<class>/<stem>.jpg."""
        self.save_dir.mkdir(parents=True, exist_ok=True)
        path = str(r.path)
        vid, _, frame = path.partition("#frame")
        stem = Path(vid).stem or "image0"
        if self.save:
            cv2 = require_cv2("predict(save=True)")
            im = r.plot()
            if frame:
                w = self._writers.get(vid)
                if w is None:
                    cap = cv2.VideoCapture(vid)
                    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
                    cap.release()
                    w = cv2.VideoWriter(str(self.save_dir / f"{stem}.avi"), cv2.VideoWriter_fourcc(*"MJPG"),
                                        max(fps, 1.0), (im.shape[1], im.shape[0]))
                    self._writers[vid] = w
                w.write(im)
            else:
                cv2.imwrite(str(self.save_dir / (Path(path).name or "image0.jpg")), im)
        if self.save_txt:
            txt = f"{stem}_{frame}.txt" if frame else f"{stem}.txt"
            r.save_txt(str(self.save_dir / "labels" / txt), save_conf=self.save_conf)
        if self.save_crop:
            r.save_crop(str(self.save_dir / "crops"), file_name=f"{stem}.jpg")

    def _stream(self, source) -> Iterator[Results]:
        """Results frame by frame, one batch of `batch` frames at a time."""
        frames = load_source(source)
        for i in range(0, len(frames), self.batch):
            chunk = frames[i: i + self.batch]
            n = len(chunk)
            t0 = time.perf_counter()
            x = self.preprocess([im for _, im in chunk])
            t1 = time.perf_counter()
            with torch.inference_mode():
                out = self.model.predict(x, self.max_det, self.conf, self.iou, text=self.batch_text(n))
                det_dev, extra = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
                det = det_dev.cpu().numpy()
                kpts = extra[0].cpu().numpy() if self.kpt_shape is not None else None
            t2 = time.perf_counter()
            if self.model.task == "classify":
                speed = {"preprocess": (t1 - t0) * 1e3 / n, "inference": (t2 - t1) * 1e3 / n, "postprocess": 0.0}
                for j, (path, im0) in enumerate(chunk):
                    yield Results(im0, path, self.names, probs=det[j], speed=speed)
                continue
            for j, (path, im0) in enumerate(chunk):
                masks = keypoints = obb = None
                if self.model.task == "obb":
                    boxes, obb = self.frame_obb(det[j], im0.shape[:2])
                else:
                    boxes = self.postprocess(det[j], im0)
                keep = det[j][:, 4] > self.conf
                if self.model.task == "segment":
                    masks = self.frame_masks(det_dev[j], extra[0][j], extra[1][j], keep, im0.shape[:2])
                elif kpts is not None:
                    keypoints = self.frame_keypoints(kpts[j], keep, im0.shape[:2])
                speed = {"preprocess": (t1 - t0) * 1e3 / n, "inference": (t2 - t1) * 1e3 / n,
                         "postprocess": (time.perf_counter() - t2) * 1e3 / n}
                yield Results(im0, path, self.names, boxes=boxes, masks=masks, keypoints=keypoints, obb=obb,
                              speed=speed)
