"""YOLOv8 classification (yolov8n/s/m/l/x-cls, yolov8-cls-resnet50/101) of the port against the JAX package, on the
CPU in f32.

Weights come from `random_variables` over the JAX module's `jax.eval_shape` tree and reach the port through the
weight bridge, whose Dense rule maps a flax (in, out) kernel to a Linear (out, in) weight.

* Each model's graph: the YAML byte for byte, task "classify", the JAX `parse_model`'s specs and save list, the
  JAX parameter count (yolov8n-cls 2,719,288 to yolov8x-cls 57,422,840; resnet50 27,413,032, resnet101
  46,405,160), the variable shapes, a strict load and the bridge's round trip bit for bit, the conv3x3 sites (2
  per C2f bottleneck; the stride-1 3x3 of every ResNet block).
* `Classify` (logits in eval mode, after the serving fold and in train mode with its new BN statistics) and
  `ResNetLayer` (the 7x7/2 stem with its 3x3/2 max-pool, a stride-2 stage, a stride-1 stage; eval, folded, train
  with BN statistics, and the train-mode gradients of the JAX module against the port's f64 run); the max-pool's
  -inf padding against the JAX pool's finfo.min.
* yolov8n-cls through `YOLO.predict` at imgsz 64 against the JAX facade's probabilities; one CE step of
  `tests/assets/tiny-cls.yaml` against JAX `make_cls_train_step`; `train(data=...)` for 2 epochs against JAX
  `train_classifier` (results, `results.csv`, the weights handed back, `last.ckpt` and `.save` files both ways);
  `evaluate_classifier` against JAX's; the refusals (`YOLO.val`, `make_train_step(loss_kind="classify")`,
  `train(batches=...)`).
"""

import csv
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.engine import classify as JCL
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.nn.heads import Classify as JaxClassify
from lpc_yolo_tpu.nn.modules import ResNetLayer as JaxResNetLayer
from lpc_yolo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from lpc_yolo_tpu.utils.torch_port import port_state_dict

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import check_cls_dataset, make_cls_dataset
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.engine.classify import evaluate_classifier, make_cls_train_step
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.compiler import build_model
from lpc_yolo_tpu_torch.nn.fuse import fuse_conv_bn
from lpc_yolo_tpu_torch.nn.heads import Classify
from lpc_yolo_tpu_torch.utils.checkpoint import load_checkpoint
from lpc_yolo_tpu_torch.utils.flax_bridge import (flax_shapes, flax_to_state_dict, load_flax, random_variables,
                                                  state_dict_to_flax, train_state_from_dict)

ROOT = Path(__file__).resolve().parents[1]
JAX_CFG = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v8"
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v8"
TINY = ROOT / "tests" / "assets" / "tiny-cls.yaml"
MODELS = {"n": ("yolov8n-cls.yaml", "yolov8-cls.yaml", 2_719_288, 12),
          "s": ("yolov8s-cls.yaml", "yolov8-cls.yaml", 6_361_736, 12),
          "m": ("yolov8m-cls.yaml", "yolov8-cls.yaml", 17_053_336, 24),
          "l": ("yolov8l-cls.yaml", "yolov8-cls.yaml", 37_480_744, 36),
          "x": ("yolov8x-cls.yaml", "yolov8-cls.yaml", 57_422_840, 36),
          "resnet50": ("yolov8-cls-resnet50.yaml", "yolov8-cls-resnet50.yaml", 27_413_032, 13),
          "resnet101": ("yolov8-cls-resnet101.yaml", "yolov8-cls-resnet101.yaml", 46_405_160, 30)}
S = 64
XLA_OPTS = {"xla_disable_hlo_passes": "fusion"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are small at these sizes: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_shapes(jm, size=S):
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), training=True))


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def flat_shapes(tree):
    return {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda t: isinstance(t, tuple))}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_named_close(named, ref, tol, what, floor=0.0):
    """Each entry within tol of the largest magnitude of its reference leaf (plus floor)."""
    assert named.keys() == ref.keys()
    for k, t in named.items():
        r = np.asarray(ref[k], np.float64)
        np.testing.assert_allclose(np.asarray(t, np.float64), r, rtol=0, atol=tol * np.abs(r).max() + floor,
                                   err_msg=f"{what} {k}")


def stats_of(module):
    return {k: b.detach().numpy() for k, b in module.named_buffers() if k.endswith(("running_mean", "running_var"))}


def jax_stats(mut):
    new = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    return {k: v.numpy() for k, v in new.items() if not k.endswith("num_batches_tracked")}


# -- the graphs ----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(MODELS))
def test_cls_graph_matches_jax(key):
    """`YOLO(<name>)` resolves to the port's copy of the JAX YAML: task "classify", no strides probed; the JAX
    `parse_model`'s specs and save list; the JAX parameter count and variable shapes (the Linear's kernel as a
    flax (in, out) Dense kernel); bridged weights loaded strictly and back to the JAX tree bit for bit; the
    conv3x3 sites."""
    name, file, n_params, sites = MODELS[key]
    assert (PORT_CFG / file).read_bytes() == (JAX_CFG / file).read_bytes()
    yolo = YOLO(name, device="cpu", seed=None)
    assert yolo.task == "classify" and yolo.model.nc == 1000
    specs, save = TC.parse_model(yolo.model_yaml)
    jd = JC.yaml_model_load(JAX_CFG / file)
    jd["scale"] = yolo.model_yaml["scale"]
    jspecs, jsave = JC.parse_model(jd)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    assert specs[-1].module == "Classify" and specs[-1].args[1] == 1000
    tm = yolo.model
    shapes = jax_shapes(jax_build(jd), 32)
    assert sum(p.numel() for p in tm.parameters()) == n_params
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"])) == n_params
    assert sum(isinstance(m, TM.ConvBN) and m.kernel_path for m in tm.modules()) == sites
    for col in ("params", "batch_stats"):
        assert flat_shapes(flax_shapes(tm)[col]) == flat_shapes(shapes[col])
    variables = random_variables(shapes, seed=0)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    back = state_dict_to_flax(tm.state_dict())
    assert tm.model[-1].linear.weight.shape == (1000, 1280)
    for col in ("params", "batch_stats"):
        got, ref = flat(back[col]), flat(variables[col])
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if key == "n":  # the JAX package's own torch -> flax map of the same state_dict agrees
        jb = port_state_dict(tm.state_dict(), variables)
        for col in ("params", "batch_stats"):
            assert all(np.array_equal(flat(jb[col])[k], v) for k, v in flat(variables[col]).items())


# -- the Classify head and the ResNet stages --------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["eval", "folded", "train"])
def test_classify_head_matches_jax(mode):
    """Classify(c1 64, nc 10, c_ 1280) on a (2, 5, 5, 64) map: logits within atol 1e-5 of the JAX head's in eval
    mode, after `fuse_conv_bn` and in train mode, where the new BN statistics also agree (rtol/atol 1e-5)."""
    x = np.random.default_rng(1).standard_normal((2, 5, 5, 64)).astype(np.float32)
    jhead = JaxClassify(nc=10)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x), training=True))
    variables = random_variables(shapes, seed=0)
    head = Classify(64, nc=10)
    head.load_state_dict(flax_to_state_dict(variables), strict=True)
    if mode == "train":
        ref, mut = jhead.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
        got = head.train()(_nchw(x))
        new = jax_stats(mut)
        assert stats_of(head).keys() == new.keys()
        for k, t in stats_of(head).items():
            np.testing.assert_allclose(t, new[k], rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        ref = jhead.apply(variables, jnp.asarray(x), training=False)
        head.eval()
        if mode == "folded":
            fuse_conv_bn(head, torch.float32)
        with torch.no_grad():
            got = head(_nchw(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)


RESNET_CASES = {"stem": dict(c1=3, c2=16, s=1, is_first=True, n=1, hw=21),
                "s2": dict(c1=32, c2=8, s=2, is_first=False, n=2, hw=9),
                "s1": dict(c1=16, c2=8, s=1, is_first=False, n=2, hw=7)}


@pytest.mark.parametrize("case", list(RESNET_CASES))
def test_resnet_layer_matches_jax(case):
    """ResNetLayer against the JAX module on a seeded (2, hw, hw, c1) input: the stem (7x7/2 ConvBN, Mish, 3x3/2
    max-pool, padding 1), a stage of two blocks whose first has stride 2 (a `shortcut.0` ConvBN), a stride-1 stage
    whose first block widens 16 -> 32 (a shortcut) and whose second adds its input. Eval mode and after
    `fuse_conv_bn` (the blocks' stride-1 3x3 then take the conv3x3 path): within atol 1e-5 of the output's largest
    value. Train mode: output and new BN statistics within 1e-5; the gradient of sum(out * r) with respect to
    every parameter, JAX f32 and the port's f32 within 1e-4 of each leaf's largest value of the port's f64 run.
    The JAX stem has no gradient: its pool (`jax.lax.reduce_window` with `jax.lax.max` and a finfo.min init,
    `lpc_yolo_tpu/nn/modules.py:1845-1849`) has no reverse-mode rule, so the JAX package cannot train the ResNet
    classifiers (ROADMAP Queue 3); the port's stem is held to its f64 run alone."""
    c = RESNET_CASES[case]
    x = np.random.default_rng(2).standard_normal((2, c["hw"], c["hw"], c["c1"])).astype(np.float32)
    jm = JaxResNetLayer(c["c2"], s=c["s"], is_first=c["is_first"], n=c["n"])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), training=True))
    variables = random_variables(shapes, seed=3)
    tm = TM.ResNetLayer(c["c1"], c["c2"], s=c["s"], is_first=c["is_first"], n=c["n"])
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    sites = sum(isinstance(m, TM.ConvBN) and m.kernel_path for m in tm.modules())
    assert sites == (0 if c["is_first"] else c["n"] - (c["s"] != 1))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), training=False))
    tm.eval()
    for fold in (False, True):
        if fold:
            fuse_conv_bn(tm, torch.float32)
        with torch.no_grad():
            got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    r = np.random.default_rng(4).standard_normal(ref.shape).astype(np.float32)

    def jloss(params):
        out, mut = jm.apply({**variables, "params": params}, jnp.asarray(x), training=True, mutable=["batch_stats"])
        return (out * r).sum(), (out, mut)

    if c["is_first"]:
        with pytest.raises(ValueError, match="reverse-mode"):
            jax.value_and_grad(jloss, has_aux=True)(variables["params"])
        (_, (jout, mut)), jgrad = jloss(variables["params"]), None
    else:
        (_, (jout, mut)), jgrad = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    grads = {}
    for dtype in (torch.float32, torch.float64):
        tm_t = TM.ResNetLayer(c["c1"], c["c2"], s=c["s"], is_first=c["is_first"], n=c["n"])
        tm_t.load_state_dict(flax_to_state_dict(variables), strict=True)
        tm_t = tm_t.to(dtype).train()
        out = tm_t(_nchw(x).to(dtype))
        (out * _nchw(r).to(dtype)).sum().backward()
        grads[dtype] = {k: p.grad.detach() for k, p in tm_t.named_parameters()}
        if dtype == torch.float32:
            np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jout), rtol=0,
                                       atol=1e-5 * np.abs(np.asarray(jout)).max())
            new = jax_stats(mut)
            for k, t in stats_of(tm_t).items():
                np.testing.assert_allclose(t, new[k], rtol=1e-5, atol=1e-5, err_msg=k)
    if jgrad is not None:
        jg = flax_to_state_dict({"params": jax.tree.map(np.asarray, jgrad)})
        assert_named_close({k: v.numpy() for k, v in jg.items()}, grads[torch.float64], 1e-4, "JAX gradient of",
                           floor=1e-7)
    assert_named_close({k: v.numpy() for k, v in grads[torch.float32].items()}, grads[torch.float64], 1e-4,
                       "f32 gradient of", floor=1e-7)


def test_max_pool_padding_matches_jax():
    """The stem's pool on an all-negative map, where the padding is the largest value of every border window
    unless it is below all of them: F.max_pool2d's -inf and the JAX pool's finfo.min give the same output, in f32
    and bf16."""
    x = -np.abs(np.random.default_rng(5).standard_normal((2, 9, 8, 4))).astype(np.float32) - 1
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(x, jdt)
        neg = jnp.finfo(jdt).min
        ref = jax.lax.reduce_window(xj, jnp.array(neg, jdt), jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                    [(0, 0), (1, 1), (1, 1), (0, 0)])
        got = torch.nn.functional.max_pool2d(_nchw(x).to(tdt), 3, 2, 1).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


# -- yolov8n-cls through the entry points ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v8n_cls():
    """yolov8n-cls (nc 1000): the JAX model and its seeded variables."""
    jm = jax_build(JAX_CFG / "yolov8-cls.yaml")
    return jm, random_variables(jax_shapes(jm), seed=0)


@pytest.fixture
def jax_facade(monkeypatch):
    """The JAX facade, its `_jit_init` returning the variables the test sets in `use`."""
    import lpc_yolo_tpu.engine.model as jax_model

    use = {}
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: use["variables"])
    return jax_model.YOLO, use


def frames(seed=11):
    """Frames that need no resize at imgsz 64 (r = 1), so both letterboxes give byte-equal feeds."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for shape in ((64, 48, 3), (48, 64, 3), (64, 64, 3))]


def test_predict_matches_jax(v8n_cls, jax_facade):
    """YOLO("yolov8n-cls.yaml").predict against the JAX facade's on the same weights at imgsz 64, batch 2 (the
    last batch padded in JAX): each frame's `Results.probs` (1000,) f32 sums to 1 and is within 1e-6 absolute
    (1e-4 relative) of the JAX probabilities; top-1 and top-5 agree where the probabilities' gaps exceed that;
    `speed` has the JAX split, "postprocess" 0; a classify result has no boxes."""
    facade, use = jax_facade
    use["variables"] = v8n_cls[1]
    jy = facade("yolov8n-cls.yaml")
    assert jy.task == "classify"
    im = frames()
    ref = jy.predict(im, imgsz=S, batch=2)
    got = YOLO("yolov8n-cls.yaml", device="cpu", seed=None).load_flax(v8n_cls[1]).predict(im, imgsz=S, batch=2,
                                                                                          device="cpu")
    assert len(got) == len(ref) == 3
    for r, j, f in zip(got, ref, im):
        p, q = np.asarray(r.probs), np.asarray(j.probs)
        assert p.shape == (1000,) and p.dtype == np.float32 and abs(float(p.sum()) - 1) < 1e-5
        np.testing.assert_allclose(p, q, rtol=1e-4, atol=1e-6)
        top = np.sort(q)[::-1]
        if top[0] - top[1] > 2e-6:
            assert r.probs.top1 == j.probs.top1
        if top[4] - top[5] > 2e-6:
            assert set(r.probs.top5) == set(j.probs.top5)
        assert r.probs.top1conf == p.max() and r.boxes is None and len(r) == 0 and r.orig_shape == f.shape[:2]
        assert set(r.speed) == {"preprocess", "inference", "postprocess"} and r.speed["postprocess"] == 0.0
    assert len({r.probs.top1 for r in got}) >= 1


def tiny_batch(seed, b=4, hw=32, nc=4):
    rng = np.random.default_rng(seed)
    return {"img": rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8),
            "label": rng.integers(0, nc, b).astype(np.int32)}


def test_cls_train_step_matches_jax():
    """One CE step of tests/assets/tiny-cls.yaml (nc 4) on a seeded b4 32x32 uint8 BGR batch, with the optimizer
    `train_classifier` builds (AdamW, warmup max(steps, 20)): the loss within rtol 1e-5 and the new BN statistics
    within 1e-5 of the JAX `make_cls_train_step`'s; AdamW's first moment (0.063 of the clipped gradient) and
    second moment, JAX f32 within 1e-3 of each leaf's largest value of the port's f64 run. The first lr is 0
    (warmup from 0), so the parameters and the EMA keep their values in both; the lr of the next step is JAX's."""
    jm = jax_build(TINY)
    variables = random_variables(jax_shapes(jm, 32), seed=0)
    cfg_kw = dict(lr0=0.002, optimizer="adamw", total_steps=40, warmup_steps=20)
    jcfg = jts.OptConfig(**cfg_kw)
    jstate, tx = jts.init_train_state(jm, variables, jcfg)
    batch = tiny_batch(0)
    jstep = jax.jit(JCL.make_cls_train_step(jm, tx, jcfg).__wrapped__).lower(jstate, batch).compile(
        compiler_options=XLA_OPTS)
    jstate, jmet = jstep(jstate, batch)
    adam = jstate.opt_state[1][0]
    ref_mu = flax_to_state_dict({"params": jax.tree.map(np.asarray, adam.mu)})
    ref_nu = flax_to_state_dict({"params": jax.tree.map(np.asarray, adam.nu)})
    out = {}
    for dtype in (torch.float32, torch.float64):
        tm = load_flax(build_model(TINY, device="cpu"), variables).to(dtype)
        cfg = tts.OptConfig(**cfg_kw)
        state = tts.init_train_state(tm, cfg, "cpu")
        step = make_cls_train_step(tm, cfg)
        before = {k: p.detach().clone() for k, p in state.params.items()}
        state, met = step(state, batch)
        out[dtype] = (state, met, before, tm)
    state, met, before, tm = out[torch.float32]
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    assert met["lr"] == 0.0 and float(jmet["lr"]) == 0.0
    new = jax_stats({"batch_stats": jstate.batch_stats})
    for k, t in stats_of(tm).items():
        np.testing.assert_allclose(t, new[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k, p in state.params.items():
        assert torch.equal(p.detach(), before[k]) and torch.equal(state.ema_params[k], before[k]), k
    s64 = out[torch.float64][0]
    assert_named_close({k: v.numpy() for k, v in ref_mu.items()}, s64.momentum, 1e-3, "JAX mu of", floor=1e-9)
    assert_named_close({k: v.numpy() for k, v in ref_nu.items()}, s64.nu, 1e-3, "JAX nu of", floor=1e-12)
    assert_named_close({k: v.numpy() for k, v in state.momentum.items()}, s64.momentum, 1e-4, "f32 mu of",
                       floor=1e-9)
    state, met = make_cls_train_step(tm, cfg)(state, tiny_batch(1))
    assert met["lr"] == pytest.approx(0.002 / 20 * (1 - 0.99 / 40))
    assert all(torch.isfinite(p).all() for p in state.params.values())


@pytest.fixture(scope="module")
def cls_root(tmp_path_factory):
    """A 4-class set of 64x64 and 48x80 colour frames: 3 train and 2 val images a class."""
    return make_cls_dataset(tmp_path_factory.mktemp("cls") / "set", n_train=3, n_val=2, nc=4,
                            shapes=((64, 64), (48, 80)))


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_train_classifier_matches_jax(cls_root, jax_facade, tmp_path):
    """`YOLO("tiny-cls.yaml", nc=4).train(data=<class folders>, epochs=2, batch=4, imgsz=32)` and the JAX facade's
    (`train_classifier`) from the same weights: the same results keys; results.csv's header in the JAX columns and
    its epoch, accuracy and fitness cells equal, train/loss within 1e-4; the weights handed back (the EMA
    parameters with the live BN statistics) within 1e-3 of each leaf's largest value. Each package's
    `weights/last.ckpt` (meta {"epoch": 1}) holds the other's tree: the same keys, and the port reads the JAX
    file back into a TrainState at step 6. `.save` files load both ways with task "classify"."""
    facade, use = jax_facade
    jm = jax_build(TINY)
    variables = random_variables(jax_shapes(jm, 32), seed=0)
    use["variables"] = variables
    kw = dict(data=cls_root, epochs=2, batch=4, imgsz=32, workers=2)
    jy = facade(str(TINY), nc=4)
    ref = jy.train(save_dir=str(tmp_path / "jax"), **kw)
    yolo = YOLO(str(TINY), device="cpu", seed=None, nc=4).load_flax(variables)
    got = yolo.train(save_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert list(got) == list(ref) == ["metrics/accuracy_top1", "metrics/accuracy_top5", "fitness"]
    rows, jrows = read_csv(tmp_path / "port" / "results.csv"), read_csv(tmp_path / "jax" / "results.csv")
    assert rows[0] == jrows[0] == ["epoch", "train/loss", "metrics/accuracy_top1", "metrics/accuracy_top5",
                                   "fitness", "time_s"]
    assert len(rows) == len(jrows) == 3
    for a, b in zip(rows[1:], jrows[1:]):
        assert a[0] == b[0] and a[2:5] == b[2:5]
        assert abs(float(a[1]) - float(b[1])) <= 1e-4
    assert got == ref
    sd = flax_to_state_dict(jax.tree.map(np.asarray, jy.variables))
    assert_named_close({k: v.numpy() for k, v in yolo.model.state_dict().items() if k in sd and v.is_floating_point()},
                       {k: v.numpy() for k, v in sd.items() if v.is_floating_point()}, 1e-3, "weights", floor=1e-6)
    tree, meta = load_checkpoint(tmp_path / "port" / "weights" / "last.ckpt")
    jtree, jmeta = load_checkpoint(tmp_path / "jax" / "weights" / "last.ckpt")
    assert meta == jmeta == {"epoch": 1}
    assert flat_shapes(jax.tree.map(lambda a: tuple(a.shape), tree)) == \
        flat_shapes(jax.tree.map(lambda a: tuple(a.shape), jtree))
    cfg = tts.OptConfig(lr0=0.002, optimizer="adamw", total_steps=6, warmup_steps=20)
    state = train_state_from_dict(build_model(TINY, device="cpu", nc=4), cfg, jtree, "cpu")
    assert state.step == state.opt_step == 6 and state.ema_updates == 6
    jstate, _ = jts.init_train_state(jm, variables, jts.OptConfig(**{**cfg.__dict__}))
    restored, _ = jax_load_checkpoint(tmp_path / "port" / "weights" / "last.ckpt", jstate)
    assert int(restored.step) == 6
    yolo.save(tmp_path / "port.ckpt")
    jback = facade(str(tmp_path / "port.ckpt"))
    assert jback.task == "classify" and jback.model.nc == 4
    jy.save(tmp_path / "jax.ckpt")
    back = YOLO(str(tmp_path / "jax.ckpt"), device="cpu")
    assert back.task == "classify" and back.model.nc == 4


def test_evaluate_classifier_matches_jax(cls_root):
    """`evaluate_classifier` on the val split (both splits hold every class) against the JAX function on the same
    tiny-cls weights, batch 3 (the last batch padded): the same top-1, top-5 and fitness; top-5 of 4 classes is
    1."""
    jm = jax_build(TINY, nc=4)
    variables = random_variables(jax_shapes(jm, 32), seed=1)
    info = check_cls_dataset(cls_root)
    ref = JCL.evaluate_classifier(jm, variables, info["val"], imgsz=32, batch=3, workers=2)
    tm = load_flax(build_model(TINY, device="cpu", nc=4), variables)
    got = evaluate_classifier(tm, info["val"], imgsz=32, batch=3, workers=2, names=info["names"], device="cpu")
    assert got == ref and got["metrics/accuracy_top5"] == 1.0


def test_entry_points_refuse_what_is_not_ported(cls_root):
    """`YOLO.val` of a classify model raises NotImplementedError naming the JAX validator's `out["pred"]`;
    `make_train_step(loss_kind="classify")` keeps refusing, as the JAX `make_train_step` has no such kind; a
    classify model trains from data= only."""
    yolo = YOLO(str(TINY), device="cpu", seed=0, nc=4)
    with pytest.raises(NotImplementedError, match="validator.py:148-150"):
        yolo.val(data=cls_root)
    with pytest.raises(NotImplementedError):
        tts.make_train_step(yolo.model, tts.OptConfig(), loss_kind="classify")
    with pytest.raises(NotImplementedError, match="data="):
        yolo.train(batches=[tiny_batch(0)], device="cpu")
    with pytest.raises(ValueError, match="nc=4"):
        YOLO(str(TINY), device="cpu", nc=3).train(data=cls_root, device="cpu")
