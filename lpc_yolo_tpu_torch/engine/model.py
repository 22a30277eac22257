"""The `YOLO` facade of the port (counterpart of `lpc_yolo_tpu/engine/model.py::YOLO`).

`YOLO(cfg, device=..., nc=...)` builds the model from one of the port's own
YAMLs (or a path), with weights made from a seed or loaded from JAX variables
through the weight bridge; `YOLO("x.ckpt")` rebuilds it from a `.ckpt` that
`YOLO.save` of either package wrote (the JAX `_load_native_ckpt`, :90-120).
`.predict(frames)` serves it (`stream=True` frame by frame, the save family
as in the JAX facade; `yolo(frames)` is the same), `.track(frames)` runs it
through ByteTrack or BoT-SORT (`trackers/`), `.train(data=...)` trains it on a dataset (or
`.train(batches=...)` on an iterable of host batches), `.val(data=...)`
measures it on a dataset, `.save(path)` writes it as a `.ckpt` the JAX
facade loads and `.load(weights)` takes over every weight whose name and
shape match. Seven tasks are ported, named as the JAX facade names them:
"v10" for a v10Detect head (NMS-free), "v8" for a Detect head (NMS),
"segment" for a Segment head (NMS and instance masks; `yolov8n-seg.yaml`
resolves to `v8/yolov8-seg.yaml`), "pose" for a Pose head (NMS and
keypoints; `yolov8n-pose.yaml` resolves to `v8/yolov8-pose.yaml`), "obb"
for an OBB head (rotated boxes, rotated fast-NMS; `yolov8n-obb.yaml`
resolves to `v8/yolov8-obb.yaml`), "classify" for a Classify head
(`Results.probs`; `yolov8n-cls.yaml` resolves to `v8/yolov8-cls.yaml`, and
`yolov8-cls-resnet50.yaml` / `-resnet101.yaml` are the ResNet classifiers),
whose `train(data=<class-folder root>)` runs `engine/classify.py::
train_classifier` as the JAX facade routes it (:238-242), and "rtdetr" for an
RTDETRDecoder head (`rtdetr-l.yaml`, `-x`, `-resnet50`, `-resnet101` in
`rt-detr/`, `yolov8n-rtdetr.yaml` resolves to `v8/yolov8-rtdetr.yaml`),
served and validated with no NMS, and trained through the DETR loss
(`losses/detr.py`), and "world" for a WorldDetect head (YOLO-World:
`yolov8s-world.yaml` resolves to `v8/yolov8-world.yaml`, `-worldv2` to
`v8/yolov8-worldv2.yaml`; `YOLOWorld()` builds yolov8s-world), whose class
scores are the similarities of its region embeddings with a text table:
`txt_feats` (1, M, 512), `encode_names` of the class names unless
`set_classes(names, embeddings=...)` sets another. `predict`, `val` and
`train` read that table (the JAX validator and train step read none: ROADMAP
Queue 3); `train(data=...)` sets the names and the table to the dataset's.
`embed(source)` gives one L2-normalised feature vector an image (the graph up
to the layer before the head, global-average-pooled); `fuse()` folds every
conv's BatchNorm into its weights, as the JAX `fuse_conv_bn` does;
`reset_weights()` draws the weights again from the facade's seed; `quantize_int8(calib)` calibrates int8
post-training quantization on the frames of `calib`, after which `predict`, `val` and `track` serve the
eligible convs through the s8 kernels (`nn/quant.py`; every task: a classifier's `predict` and
`engine/classify.py::evaluate_classifier`, a World model on the text table it was calibrated with); `n_params`,
`device` ("cuda:0" or "cpu") and `task_map` are the JAX facade's;
`add_callback`, `clear_callback` and `reset_callbacks` register hooks that the
trainer runs (`utils/callbacks.py`).
`YOLO("x.pt")` reads a reference-layout checkpoint (`utils/pt_checkpoint.py`: `ema`, else `model`, its `.yaml`,
`.names` and state_dict), and `save_pt(path)` writes one. The research zoo's modules build from a YAML that names
them (`nn/research.py`). `export(format=...)` writes an ONNX, TorchScript or `.ckpt` artifact
(`engine/exporter.py`) and `benchmark()` gives the format benchmark's rows (`utils/benchmarks.py`); `info`,
`profile` and `tune` wait for later slices.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch

from ..nn.compiler import DetectionModel, build_model, guess_model_scale, yaml_model_load
from ..nn.modules import ConvBN
from ..utils import resolve_device
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.flax_bridge import flax_shapes, load_flax, random_variables, state_dict_to_flax
from ..utils.names import COCO80
from ..utils.pt_checkpoint import load_pt_state, read_pt, write_pt
from ..utils.text_embed import encode_names
from .predictor import Predictor, letterbox_batch, load_source, serving_model

_CFG_ROOT = Path(__file__).resolve().parents[1] / "cfg" / "models"
SAVE_KEYS = {"save", "save_txt", "save_conf", "save_crop", "save_dir", "project", "name", "exist_ok"}


def _resolve_yaml(name: Union[str, Path]) -> Path:
    """A model-config name or path -> the YAML file, searched in v10, v8, v9, v5, v3, v6 and rt-detr (scale
    letter stripped when needed: yolov8n.yaml -> v8/yolov8.yaml, yolov8n-seg.yaml -> v8/yolov8-seg.yaml,
    yolov8x-p6.yaml -> v8/yolov8-p6.yaml, yolov5n.yaml -> v5/yolov5.yaml, yolov6n.yaml -> v6/yolov6.yaml,
    yolov8n-rtdetr.yaml -> v8/yolov8-rtdetr.yaml; yolov3-tiny.yaml has no scale, and neither have
    yolov9c.yaml and yolov9e.yaml, whose c and e are not scale letters, nor rtdetr-l.yaml), as the JAX
    resolver does (:42-55). The JAX one searches v10, v8 and v9 only, so it finds a v3, v5, v6 or rt-detr
    YAML by its path alone (ROADMAP Queue 3)."""
    p = Path(name)
    if p.exists():
        return p
    unified = re.sub(r"(\d+)([nsmblx])(.+)?$", r"\1\3", p.stem) + p.suffix
    for fam in ("v10", "v8", "v9", "v5", "v3", "v6", "rt-detr"):
        for cand in (_CFG_ROOT / fam / p.name, _CFG_ROOT / fam / unified):
            if cand.exists():
                return cand
    raise FileNotFoundError(f"model config {name} not found (searched {_CFG_ROOT})")


def _read_model_ckpt(path: Union[str, Path]):
    """A `.ckpt` written by `YOLO.save` (either package) -> (model YAML dict, variables, meta)."""
    variables, meta = load_checkpoint(path)
    if meta.get("model_yaml") is None:
        raise ValueError(
            f"{path} has no embedded model config — trainer state checkpoints "
            "(weights/last.ckpt) resume via YOLO(...).train(resume=True); use "
            "model.save(path) to produce a standalone loadable artifact"
        )
    return meta["model_yaml"], {k: variables[k] for k in ("params", "batch_stats")}, meta


class YOLO:
    """User-facing facade: `YOLO("yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml", device="cuda")`.

    seed: fill the weights from this numpy seed through the bridge (the same
    numbers the JAX package gets from `random_variables` of its shape tree);
    None keeps PyTorch's default init. nc: the number of classes, when it is
    not the YAML's (the JAX facade's `nc=`); the names are then "0", "1", ...
    A `.ckpt` or a `.pt` brings its own weights, class count and names; `seed` is then only what
    `reset_weights` draws from.
    """

    def __init__(self, model: Union[str, Path] = "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml",
                 device: Union[str, torch.device, None] = None, seed: Optional[int] = 0, nc: Optional[int] = None):
        self._device = resolve_device(device)
        self.ckpt_path = str(model)  # the source, whose stem names an export's artifacts
        self.seed = seed
        self.callbacks: Dict[str, List[Callable]] = {}  # hooks the trainer runs first (add_callback)
        meta: Dict[str, Any] = {}
        pt_state = None
        if str(model).endswith(".ckpt"):
            d, variables, meta = _read_model_ckpt(model)
        elif str(model).endswith(".pt"):  # a reference-layout checkpoint (JAX :143-175)
            d, pt_state, pt_names = read_pt(model)
            variables, meta = None, {"names": pt_names}
        elif str(model).endswith((".yaml", ".yml")):
            d = yaml_model_load(_resolve_yaml(model))
            d["scale"] = guess_model_scale(model) or d["scale"]
            variables = None
        else:
            raise NotImplementedError("the torch port builds from model YAMLs, .ckpt and .pt files only")
        self.model_yaml: Dict[str, Any] = d
        self.model = build_model(d, device=self._device, nc=nc or meta.get("nc"))
        self.task = self.model.task  # from the head, as the JAX `_guess_task` (:123-131)
        if self.task is None:
            raise NotImplementedError("the torch port serves v10Detect, Detect, Segment, Pose, OBB, Classify, "
                                      "RTDETRDecoder and WorldDetect models only so far")
        if variables is not None:
            self.load_flax(variables)
        elif pt_state is not None:
            load_pt_state(self.model, pt_state)
        elif seed is not None:
            self.load_flax(random_variables(flax_shapes(self.model), seed))
        names = meta.get("names") or dict(COCO80)
        # JSON turned the int keys into str
        names = {int(k): v for k, v in names.items()} if isinstance(names, dict) else dict(enumerate(names))
        keep = len(names) == self.model.nc or self.task == "world" and meta.get("names")  # a World set's M is free
        self.names = names if keep else {i: str(i) for i in range(self.model.nc)}
        self.tracker = None  # the tracker of the last `track` call, which `persist=True` goes on with
        self.txt_feats = None
        if self.task == "world":  # the names' text table, in index order (JAX :84-88)
            self.txt_feats = encode_names([self.names[i] for i in sorted(self.names)])[None]

    def set_classes(self, names, embeddings=None) -> "YOLO":
        """A World model's class set (JAX `engine/model.py:132-141`): the names, and the (1, M, 512) text table,
        `encode_names` of them or the given (M, 512) `embeddings` (e.g. CLIP's), each row L2-normalised."""
        if self.task != "world":
            raise ValueError("set_classes is only supported on world models")
        names = [str(n) for n in names]
        self.names = dict(enumerate(names))
        self.txt_feats = encode_names(names, embeddings=embeddings)[None]
        return self

    def load_flax(self, variables: Dict[str, Any]) -> "YOLO":
        """Load JAX-package variables (nested dicts of numpy arrays)."""
        load_flax(self.model, variables)
        return self

    def save(self, filename: Union[str, Path] = "saved_model.ckpt") -> str:
        """Write the weights and {nc, task, model_yaml, names} as a `.ckpt` that `YOLO(path)` of
        either package loads (JAX `engine/model.py:329-337`)."""
        meta = {"nc": self.model.nc, "task": self.task, "model_yaml": self.model_yaml, "names": self.names}
        save_checkpoint(Path(filename), state_dict_to_flax(self.model.state_dict()), meta)
        return str(filename)

    def save_pt(self, filename: Union[str, Path], ema: bool = False) -> str:
        """Write the model as a reference-layout `.pt` (`utils/pt_checkpoint.py::write_pt`): the fp16 module
        under `model` with `ema` None, as `strip_optimizer` leaves a checkpoint, or under `ema`."""
        return write_pt(filename, self.model, self.model_yaml, self.names, ema=ema)

    def load(self, weights: Union[str, Path, "YOLO"]) -> "YOLO":
        """Take over every weight of `weights` (a YOLO, a `.ckpt` or a YAML) whose name and shape
        match one of this model's, and keep the others (JAX `engine/model.py:339-351`)."""
        other = weights if isinstance(weights, YOLO) else YOLO(weights, device=self._device)
        theirs = other.model.state_dict()
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                if k in theirs and theirs[k].shape == v.shape:
                    v.copy_(theirs[k])
        return self

    def predict(self, source, conf: float = 0.25, iou: float = 0.45, imgsz: int = 640, batch: int = 1,
                max_det: int = 300, device: Union[str, torch.device, None] = None, stream: bool = False,
                **save_kw):
        """Detect in frames (HWC uint8 BGR ndarrays, PIL images, image or video paths, a directory, a glob,
        or lists of them) -> [Results], or with `stream` a generator of them, frame by frame; `iou` is the
        NMS threshold of a v8 model. `save_kw` are the JAX facade's save family (save, save_txt, save_conf,
        save_crop, save_dir, project, name, exist_ok: `engine/predictor.py::Predictor`)."""
        unknown = set(save_kw) - SAVE_KEYS
        if unknown:
            raise TypeError(f"predict got unexpected arguments {sorted(unknown)}")
        predictor = Predictor(self.model, imgsz=imgsz, batch=batch, conf=conf, iou=iou, max_det=max_det,
                              names=self.names, device=device or self._device, text=self.txt_feats, **save_kw)
        return predictor(source, stream=stream)

    def __call__(self, source, **kw):
        return self.predict(source, **kw)

    def track(self, source, tracker: Union[str, Path, dict] = "bytetrack.yaml", conf: float = 0.1,
              stream: bool = False, persist: bool = False, **kw):
        """Track objects through frames (JAX `engine/model.py:216-230`): `predict(conf=conf, batch=1,
        stream=True)` fed frame by frame to a tracker (`trackers/track.py`: a config name, path or dict,
        ByteTrack or BoT-SORT), each Results' boxes [x1, y1, x2, y2, id, conf, cls] of the tracks confirmed
        on that frame. With `persist` the tracker of the last `track` call goes on (its tracks, frame count
        and ids), as the reference keeps the predictor's trackers; otherwise a new one starts, with ids from
        1. The JAX facade starts a new one on every call (ROADMAP Queue 3)."""
        from ..trackers.track import make_tracker, track_stream

        if not (persist and self.tracker is not None):
            self.tracker = make_tracker(tracker, device=kw.get("device") or self._device)
        results = self.predict(source, conf=conf, batch=1, stream=True, **kw)
        gen = track_stream(results, self.tracker)
        return gen if stream else list(gen)

    def val(self, data=None, device: Union[str, torch.device, None] = None, **kw) -> Dict[str, float]:
        """Validate on the `val` split of a dataset YAML (path or dict) -> the metrics dict.

        Options as `engine/validator.py::Validator` (imgsz, batch, conf, iou, max_det,
        max_gt, workers, save_json, save_dir, anno_json, cache_images, dtype).
        It runs on the card unless device="cpu"; the validator stays on `self.validator`.
        """
        from .validator import Validator

        if self.task == "classify":
            raise NotImplementedError("val of a classify model is not ported: the JAX Validator reads out['pred'], "
                                      "which a classify graph does not return "
                                      "(lpc_yolo_tpu/engine/validator.py:148-150); train(data=...) evaluates "
                                      "top-1 and top-5 through engine/classify.py::evaluate_classifier")
        if data is None:
            raise ValueError("val needs data=<dataset yaml or dict>")
        self.validator = Validator(self, device=device or self._device, **kw)
        return self.validator(data)

    def train(self, batches: Optional[Iterable[Mapping[str, Any]]] = None, data=None,
              device: Union[str, torch.device, None] = None, **kw) -> Dict[str, float]:
        """Train on a dataset YAML (`data=`) or on an iterable of host batches (`batches=`);
        see `engine/trainer.py` for the options. Afterwards the facade holds the EMA
        weights. It runs on the card unless device="cpu". Returns the last validation's
        results dict (data=) or the last epoch's mean loss items (batches=). A classify
        model trains on a class-folder root (`data=`) through `engine/classify.py::
        train_classifier`, which takes its own options."""
        from .trainer import Trainer

        if self.task == "classify":
            from .classify import train_classifier

            if batches is not None:
                raise NotImplementedError("a classify model trains from data=<class-folder root> only, as in the "
                                          "JAX package")
            return train_classifier(self, data=data, device=device or self._device, **kw)
        self.trainer = Trainer(self, batches, data=data, device=device or self._device, **kw)
        return self.trainer.train()

    def export(self, format: str = "tflite", imgsz: int = 640, batch: int = 1, **kw) -> str:
        """Export to a deployable artifact; returns its path (JAX :248-252; `engine/exporter.py::export_model`:
        onnx, torchscript and ckpt; the TensorFlow family and stablehlo raise, so the default format does)."""
        from .exporter import export_model

        return export_model(self, fmt=format, imgsz=imgsz, batch=batch, **kw)

    def benchmark(self, data=None, imgsz: int = 640, **kw) -> List[Dict[str, Any]]:
        """The format benchmark's rows (JAX :254-258; `utils/benchmarks.py::benchmark`)."""
        from ..utils.benchmarks import benchmark

        return benchmark(self, data=data, imgsz=imgsz, **kw)

    # the reference's callback hooks (JAX `engine/model.py:320-327`); the trainer merges them into its bus
    def add_callback(self, event: str, func: Callable) -> None:
        self.callbacks.setdefault(event, []).append(func)

    def clear_callback(self, event: str) -> None:
        self.callbacks[event] = []

    def reset_callbacks(self) -> None:
        self.callbacks = {}

    @torch.no_grad()
    def fuse(self) -> "YOLO":
        """Fold every conv's BatchNorm into its weights, in place, as the JAX `fuse_conv_bn` (:271) folds the
        variables: W * f with f = gamma / sqrt(var + eps), and the BatchNorm left as the identity plus the
        folded bias (scale 1, bias beta + (b - mean) * f, mean 0, var 1 - eps), so the same graph serves it.
        A conv bias b (the zoo's CBA with bias, ParNetAttention's) goes into the folded bias and becomes 0;
        the JAX walk drops it (ROADMAP Queue 3)."""
        for m in self.model.modules():
            if not isinstance(m, ConvBN) or m.bn is None:  # the JAX walk's (conv, bn) pairs; a RepConv's branches
                continue  # are ConvBNs
            conv, bn = m.conv, m.bn
            f = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            conv.weight.mul_(f[:, None, None, None])
            mean = bn.running_mean if conv.bias is None else bn.running_mean - conv.bias
            bn.bias.copy_(bn.bias - mean * f)
            if conv.bias is not None:
                conv.bias.zero_()
            bn.weight.fill_(1.0)
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0 - bn.eps)
        return self

    def quantize_int8(self, calib, imgsz: int = 640, batch: int = 8) -> "YOLO":
        """Post-training int8 quantization of the serving copy (JAX `engine/model.py:278-315`).

        Letterboxes the frames of `calib` (any `predict` source) at `imgsz`, the size the model then serves
        at (224 for a classifier), into batches of `batch`, pads the unused slots with 114, and records the
        absmax of every int8 site's input over them on an unquantized bf16 serving copy on the facade's device
        (f32 on the CPU). A World model runs on its text table `txt_feats`, the one its `predict` and `val`
        serve with (the JAX facade calibrates on zero text: ROADMAP Queue 3). The scales stay on the model
        (`model.int8_scales`, by site name), so every later `predict`, `val` and `track` serves the eligible
        convs through the s8 kernels (`nn/quant.py`). Training ignores them; they stay on the model after
        `train()` and after `set_classes`, as the JAX facade keeps its quant fields. Returns self.
        """
        from ..nn.quant import calibrate

        frames = [im for _, im in load_source(calib)]
        if not frames:
            raise ValueError("int8 calibration needs at least one image")
        dev = resolve_device(self._device)
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        serving = serving_model(self.model, dev, dtype, int8=False)
        batches = []
        for i in range(0, len(frames), batch):
            chunk = frames[i:i + batch]
            x = torch.full((batch, imgsz, imgsz, 3), 114, dtype=torch.uint8, device=dev)
            x[:len(chunk)] = letterbox_batch(chunk, imgsz, dev, torch.uint8)
            batches.append(x.permute(0, 3, 1, 2).to(dtype))
        text = None if self.txt_feats is None else torch.as_tensor(np.asarray(self.txt_feats, np.float32), device=dev)
        self.model.int8_scales = calibrate(serving, batches, text=text)
        return self

    def reset_weights(self) -> "YOLO":
        """Draw the weights again (JAX :353): from the facade's seed through the bridge, or with `seed=None`
        PyTorch's default init of every module."""
        if self.seed is not None:
            return self.load_flax(random_variables(flax_shapes(self.model), self.seed))
        for m in self.model.modules():
            if m is not self.model and hasattr(m, "reset_parameters"):
                m.reset_parameters()
        return self

    @property
    def n_params(self) -> int:
        """The number of parameters (JAX :431, the leaves of `params`)."""
        return sum(p.numel() for p in self.model.parameters())

    @property
    def device(self) -> str:
        """The device the facade runs on (JAX :396): "cuda:<index>" or "cpu"."""
        d = self._device
        if d.type == "cuda":
            return f"cuda:{d.index if d.index is not None else torch.cuda.current_device()}"
        return d.type

    @property
    def task_map(self) -> Dict[str, Dict[str, Any]]:
        """task -> engine components (JAX :402)."""
        from .trainer import Trainer
        from .validator import Validator

        return {t: {"trainer": Trainer, "validator": Validator, "predictor": Predictor}
                for t in ("detect", "v8", "v10", "segment", "pose", "obb", "classify", "rtdetr", "world")}

    def embed(self, source, imgsz: int = 224, batch: int = 1,
              device: Union[str, torch.device, None] = None) -> List[np.ndarray]:
        """Feature embeddings of the source images (JAX :358-392): the graph up to the layer before the head,
        global-average-pooled and L2-normalised, one 1-D f32 array an image. Each frame is letterboxed by the
        letterbox kernel (scaleup, as the JAX host letterbox) and the trunk runs f32 on the BN-folded serving
        copy, its 3x3 s1 convs through the conv3x3 kernel on the card."""
        dev = resolve_device(device or self._device)
        serving = serving_model(self.model, dev, torch.float32, int8=False)  # the JAX trunk runs unquantized
        with torch.device("meta"):
            trunk = DetectionModel(self.model.specs[:-1], self.model.save, self.model.nc, self.model.strides,
                                   self.model.reg_max, self.model.default_act)
        trunk.model = torch.nn.ModuleList(list(serving.model)[:-1])
        trunk.eval()
        frames = [im for _, im in load_source(source)]
        out: List[np.ndarray] = []
        with torch.inference_mode():
            for i in range(0, len(frames), batch):
                x = letterbox_batch(frames[i:i + batch], imgsz, dev, torch.uint8).permute(0, 3, 1, 2).float()
                emb = trunk(x).float().mean(dim=(2, 3))
                emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-20)
                out.extend(emb.cpu().numpy())
        return out


class YOLOWorld(YOLO):
    """The open-vocabulary facade (JAX `lpc_yolo_tpu/__init__.py:20-25`): a YOLO that defaults to yolov8s-world."""

    def __init__(self, model: Union[str, Path] = "yolov8s-world.yaml", **kw):
        super().__init__(model, **kw)
