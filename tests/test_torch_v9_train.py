"""YOLOv9 of the port, trained and validated against the JAX package on the CPU in f32 (`tests/test_torch_v9.py`
holds the blocks, the graphs and the forwards).

* One v8 train step of a mini v9 graph (16 layers, each v9 module at least once: Silence read by a later layer,
  CBLinear tuples of one and two maps, CBFuse at ratios 2 and 4, RepNCSPELAN4, ADown, SPPELAN; nc 4, batch 2,
  64 px) against the JAX step, at `tests/test_torch_zoo_train.py::test_p2_train_step_matches_jax`'s
  tolerances: the loss and items of each within rtol 2e-5 of the port's f64 run, the JAX momentum trace within
  1e-2 and the port's f32 trace within 2e-3 of the port's f64 trace. The whole narrow yolov9e's JAX train step
  is not compiled here: it takes minutes on a CPU.
* The optimizer's decay mask on that graph equals the JAX one (kernels only: CBLinear's conv bias and every
  BatchNorm leaf in the no-decay group), and a JAX TrainState of it (SGD and
  AdamW, every leaf seeded) goes through the port's TrainState and back into the state dict of a trainer
  `.ckpt` bit for bit.
* `val(data=...)` of the narrow yolov9c (`tests/test_torch_v9.py::narrow_v9`) at imgsz 64 against the JAX
  validator through `assert_val_results_agree`, with the box towers' last bias lowered as in
  `tests/test_torch_v8.py`.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
from lpc_yolo_tpu.engine import train_step as jts

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.utils.compare import assert_val_results_agree
from lpc_yolo_tpu_torch.utils.flax_bridge import (flax_shapes, flax_to_state_dict, load_flax, random_variables,
                                                  train_state_dict, train_state_from_dict)
from test_torch_ckpt import CFG, assert_trees_equal, filled_jax_state, np_state_dict
from test_torch_v8 import XLA_OPTS, assert_named_close, make_batch, port_first_trace, small_boxes, write_dataset
from test_torch_v9 import narrow_v9
from test_torch_zoo import S, jax_graph

# every v9 module at least once: 0 is read by 6 through the Silence, 4 and 5 are CBLinear tuples of one and two
# maps, 7 fuses them at ratios 2 and 4, 9 at ratio 2
MINI_V9 = """
nc: 4
backbone:
  - [-1, 1, Silence, []]                       # 0
  - [-1, 1, Conv, [16, 3, 2]]                  # 1
  - [-1, 1, Conv, [32, 3, 2]]                  # 2
  - [-1, 1, RepNCSPELAN4, [32, 32, 16, 1]]     # 3
  - [1, 1, CBLinear, [[16]]]                   # 4
  - [3, 1, CBLinear, [[16, 32]]]               # 5
  - [0, 1, Conv, [16, 3, 2]]                   # 6
  - [[4, 5, -1], 1, CBFuse, [[0, 0]]]          # 7
  - [-1, 1, Conv, [32, 3, 2]]                  # 8
  - [[5, -1], 1, CBFuse, [[1]]]                # 9
  - [-1, 1, RepNCSPELAN4, [32, 32, 16, 1]]     # 10
  - [-1, 1, ADown, [64]]                       # 11 P3
  - [-1, 1, RepNCSPELAN4, [64, 32, 16, 1]]     # 12
  - [-1, 1, ADown, [64]]                       # 13 P4
  - [-1, 1, ADown, [64]]                       # 14 P5
  - [-1, 1, SPPELAN, [64, 32]]                 # 15
head:
  - [[12, 13, 15], 1, Detect, [nc]]
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are small at imgsz 64: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mini():
    """The mini v9 graph: its YAML dict, the port's model, the JAX graph and seed-0 variables."""
    d = yaml.safe_load(MINI_V9)
    tm = build_model(d, device="cpu")
    return d, tm, jax_graph(d, tm.strides), random_variables(flax_shapes(tm), seed=0)


def test_mini_v9_train_step_matches_jax(mini):
    """The v8 loss through the JAX step (loss_kind "v8") and the port's on the mini v9 graph (nc 4, batch 2, 64
    px; 543,500 parameters, strides 8 / 16 / 32): the loss and its items of each within rtol 2e-5 of the port's
    f64 run and the two f32 losses within rtol 3e-5 of each other, as in
    `tests/test_torch_zoo_train.py::test_p2_train_step_matches_jax`; the first momentum trace of the JAX step
    within 1e-2 of each leaf's largest value of the port's f64 run, the port's f32 trace within 2e-3 of it
    (floor 1e-5). The gradient reaches CBLinear's kernel and bias through CBFuse's resize, the second conv that
    reads the frame through the Silence (layer 6) and both RepConv branches."""
    d, tm, jm, variables = mini
    assert tm.strides == (8.0, 16.0, 32.0) and sum(p.numel() for p in tm.parameters()) == 543_500
    jcfg, tcfg = jts.OptConfig(warmup_steps=2, total_steps=10), tts.OptConfig(warmup_steps=2, total_steps=10)
    jstate, tx = jts.init_train_state(jm, variables, jcfg)
    batch = make_batch(0)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="v8").__wrapped__
    jstep = jax.jit(raw).lower(jstate, batch).compile(compiler_options=XLA_OPTS)
    jstate, jmet = jstep(jstate, batch)
    total, items, t32 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float32,
                                         tcfg)
    loss64, items64, t64 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch,
                                            torch.float64, tcfg)
    for loss, parts in ((float(total), items.numpy()), (float(jmet["loss"]), np.asarray(jmet["items"]))):
        np.testing.assert_allclose(loss, float(loss64), rtol=2e-5)
        np.testing.assert_allclose(parts, items64.numpy(), rtol=2e-5)
    np.testing.assert_allclose(float(total), float(jmet["loss"]), rtol=3e-5)
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jstate.opt_state[2].inner_state.trace)})
    for k in ("model.4.conv.weight", "model.5.conv.bias", "model.6.conv.weight",
              "model.3.cv2.0.m.0.cv1.conv1.conv.weight", "model.3.cv2.0.m.0.cv1.conv2.conv.weight"):
        assert float(t64[k].detach().abs().max()) > 0, k
    assert_named_close(t32, t64, 2e-3, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_mini_v9_optimizer_state_matches_jax(mini, opt):
    """On the mini v9 graph: the port decays the kernels only, the JAX mask's leaves (`_decay_mask`), so
    CBLinear's conv bias and every BatchNorm leaf are in the no-decay group, both RepConv branches' kernels in
    the decayed one; a JAX
    TrainState (`opt`, every leaf seeded, as `tests/test_torch_ckpt.py` fills it) loaded into the port's
    TrainState gives back the state dict of a trainer `.ckpt` bit for bit: params, BN statistics, the momentum
    trace or AdamW's moments, and the EMA of every new leaf."""
    d, _, jm, variables = mini
    tm = build_model(d, device="cpu")
    flags = jax.tree.map(lambda m, v: np.full(np.shape(v), m, np.float32), jts._decay_mask(variables["params"]),
                         variables["params"])
    mask = flax_to_state_dict({"params": flags})
    decayed = {k for k, v in mask.items() if bool(v.all())}
    assert decayed == {k for k, p in tm.named_parameters() if p.dim() > 1}
    assert {"model.4.conv.bias", "model.5.conv.bias"} <= set(mask) - decayed
    reps = [n for n, m in tm.named_modules() if isinstance(m, TM.RepConv)]
    assert reps and all({f"{n}.conv1.conv.weight", f"{n}.conv2.conv.weight"} <= decayed for n in reps)
    tcfg = tts.OptConfig(**CFG[opt])
    ref = np_state_dict(filled_jax_state({"jm": jm, "variables": variables}, opt, seed=3))
    state = train_state_from_dict(tm, tcfg, ref, device="cpu")
    assert_trees_equal(train_state_dict(state, tcfg), ref)


def test_narrow_v9c_val_matches_jax(tmp_path, monkeypatch):
    """`YOLO(<narrow yolov9c>).val(data=...)` (conf 0.001, iou 0.7, multi-label NMS, imgsz 64; the serving fold
    of every RepConv) against the JAX facade's `val` on the same weights (with small boxes) and data:
    `assert_val_results_agree`."""
    import lpc_yolo_tpu.engine.model as jax_model

    cfg = tmp_path / "v9c-narrow.yaml"
    cfg.write_text(yaml.safe_dump(narrow_v9("v9/yolov9c.yaml", nc=80)))
    yolo = YOLO(cfg, device="cpu", seed=None)
    jm = jax_graph(yolo.model_yaml, yolo.model.strides)
    variables = small_boxes(random_variables(flax_shapes(yolo.model), seed=0), head=f"model_{len(jm.specs) - 1}")
    yolo.load_flax(variables)
    data = write_dataset(tmp_path / "data", jm, variables)
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: variables)
    ref = jax_model.YOLO(str(cfg)).val(data=str(data), imgsz=S, batch=4, workers=2)
    got = yolo.val(data=str(data), imgsz=S, batch=4, workers=2)
    assert ref["metrics/mAP50(B)"] > 0.3  # the labels are the JAX model's own detections
    assert_val_results_agree(got, ref)
