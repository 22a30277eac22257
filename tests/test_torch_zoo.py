"""The other CNN detection YAMLs of the port (v8 P2 / P6 / ghost / seg-P6 / pose-P6, v5 and v5-P6, v3, v3-SPP,
v3-tiny, v6) against the JAX package, on the CPU in f32.

Weights come from `random_variables` and reach both packages through the weight
bridge, as in `tests/test_torch_v8.py` (whose docstring says why the box towers'
last bias falls by 1 a DFL bin for the entry points at imgsz 64).

* Each new block (C3, C2, DWConv, GhostConv, GhostBottleneck at stride 1 and 2,
  C3Ghost, SPP, MaxPool2d, ZeroPad2d, the raw ConvTranspose2d, a ReLU ConvBN)
  against its JAX module, unfolded and folded, atol 1e-5.
* Each of the 13 YAMLs through `YOLO(<name>)` on the meta device (no forward): the
  YAML byte for byte, the JAX `parse_model`'s specs and save list, the strides
  (2 levels for v3-tiny, 4 for P2 and P6), the torch reference's parameter count
  (`tests/test_yaml_zoo.py`, less the DFL's 16), and the port's variable tree
  (`flax_shapes`) equal to the JAX graph's `jax.eval_shape` tree, so every
  state_dict key is the bridge's name. v3's and v6's repeated plain layers are
  `model.<i>.<rep>`, the JAX `model_<i>_<rep>`.
* One narrow variant per family (width 0.125, depth 0.33), eval forward at 64 px
  with XLA's fusion pass off: the decoded `pred` (boxes atol 1e-3 px of values up
  to ~1000 px, scores atol 1e-6), Segment's mask coefficients and prototypes and
  Pose's decoded keypoints (atol 1e-4 of the largest value); `predict` through the
  NMS, unfolded and after the serving fold (conv3x3's plain version), compared
  tie-tolerantly (`utils/compare.py`, box 1e-3, score 1e-6).
* yolov6's `activation: nn.ReLU()`: every conv.py-family ConvBN, the head towers
  included, resolves ReLU in both packages, block.py's keep Mish, and the ReLU
  and SiLU builds give different logits on the same weights. Two JAX-side
  faults the port does not copy: the JAX resolver finds no v3/v5/v6 YAML by
  name, and the JAX graph applies SiLU for `activation: nn.Mish()`.

The losses over 2 and 4 levels, a train step of a narrow yolov8-p2 and `val` of
yolov8n-p6 and yolov3-tiny are in `tests/test_torch_zoo_train.py`.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.ops.postprocess import non_max_suppression as jax_nms

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.fuse import fuse_conv_bn
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_name_to_torch, flax_shapes, load_flax, random_variables
from lpc_yolo_tpu.nn import modules as JM
from test_torch_blocks import _pair, _x
from test_torch_v8 import XLA_OPTS

ROOT = Path(__file__).resolve().parents[1]
JAX_CFG = ROOT / "lpc_yolo_tpu" / "cfg" / "models"
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models"
S = 64
# name given to YOLO -> (the YAML under cfg/models, the torch reference's parameter count less the DFL's 16
# (tests/test_yaml_zoo.py), the strides)
P3_5, P2_5, P3_6 = (8.0, 16.0, 32.0), (4.0, 8.0, 16.0, 32.0), (8.0, 16.0, 32.0, 64.0)
ZOO = {
    "yolov8n-p2.yaml": ("v8/yolov8-p2.yaml", 3_354_128, P2_5),
    "yolov8n-p6.yaml": ("v8/yolov8-p6.yaml", 4_984_336, P3_6),
    "yolov8n-ghost.yaml": ("v8/yolov8-ghost.yaml", 1_865_300, P3_5),
    "yolov8n-ghost-p2.yaml": ("v8/yolov8-ghost-p2.yaml", 2_033_928, P2_5),
    "yolov8n-ghost-p6.yaml": ("v8/yolov8-ghost-p6.yaml", 2_901_084, P3_6),
    "yolov8n-seg-p6.yaml": ("v8/yolov8-seg-p6.yaml", 5_302_800, P3_6),
    "yolov8n-pose-p6.yaml": ("v8/yolov8-pose-p6.yaml", 5_182_136, P3_6),
    "yolov5n.yaml": ("v5/yolov5.yaml", 2_654_800, P3_5),
    "yolov5n-p6.yaml": ("v5/yolov5-p6.yaml", 4_334_880, P3_6),
    "yolov3.yaml": ("v3/yolov3.yaml", 103_754_128, P3_5),
    "yolov3-spp.yaml": ("v3/yolov3-spp.yaml", 104_803_728, P3_5),
    "yolov3-tiny.yaml": ("v3/yolov3-tiny.yaml", 12_173_232, (16.0, 32.0)),
    "yolov6n.yaml": ("v6/yolov6.yaml", 4_500_064, P3_5),
}
TASKS = {"v8/yolov8-seg-p6.yaml": "segment", "v8/yolov8-pose-p6.yaml": "pose"}
# one narrow variant per family
FAMILIES = ["v8/yolov8-p2.yaml", "v8/yolov8-p6.yaml", "v8/yolov8-ghost.yaml", "v8/yolov8-seg-p6.yaml",
            "v8/yolov8-pose-p6.yaml", "v5/yolov5.yaml", "v3/yolov3-spp.yaml", "v3/yolov3-tiny.yaml", "v6/yolov6.yaml"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are small at imgsz 64: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_graph(d: dict, strides, default_act: str = "silu"):
    """The JAX DetectionModel of a YAML dict at the given strides (the JAX `build_model` without its probe)."""
    specs, save = JC.parse_model(d)
    return JC.DetectionModel(specs=specs, save=save, nc=d["nc"], strides=tuple(strides), default_act=default_act)


def jax_shapes(jm):
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def narrow(cfg: str, **kw) -> dict:
    """The YAML dict at width 0.125 and depth 0.33 (a scale of its own, or the flat multipliers of v3)."""
    d = yaml.safe_load((PORT_CFG / cfg).read_text())
    if "scales" in d:
        d.update(scales={"t": [0.33, 0.125, 1024]}, scale="t")
    else:
        d.update(depth_multiple=0.33, width_multiple=0.125)
    d.update(kw)
    return d


# -- the new blocks ------------------------------------------------------------------------------------------------

# (name, factory of (JAX module, port module), input shape): each block these YAMLs add, and the stride-2
# GhostBottleneck (with its DWConvs), which C3Ghost does not build
BLOCKS = [
    ("convbn_relu_3x3", lambda: (JM.ConvBN(24, 3, 1, act="relu"), TM.ConvBN(16, 24, 3, 1, act="relu")), (2, 8, 8, 16)),
    ("c3", lambda: (JM.C3(32, n=2), TM.C3(32, 32, n=2)), (2, 8, 8, 32)),
    ("c3_plain", lambda: (JM.C3(32, n=1, shortcut=False), TM.C3(24, 32, n=1, shortcut=False)), (2, 8, 8, 24)),
    ("c2", lambda: (JM.C2(32, n=2), TM.C2(32, 32, n=2)), (2, 8, 8, 32)),
    ("dwconv", lambda: (JM.ConvBN(32, 3, 2, g=16), TM.DWConv(16, 32, 3, 2)), (2, 8, 8, 16)),
    ("ghostconv_s2", lambda: (JM.GhostConv(32, 3, 2), TM.GhostConv(16, 32, 3, 2)), (2, 8, 8, 16)),
    ("ghostbottleneck", lambda: (JM.GhostBottleneck(32), TM.GhostBottleneck(32, 32)), (2, 8, 8, 32)),
    ("ghostbottleneck_s2", lambda: (JM.GhostBottleneck(32, 3, 2), TM.GhostBottleneck(16, 32, 3, 2)), (2, 8, 8, 16)),
    ("c3ghost", lambda: (JM.C3Ghost(32, n=2), TM.C3Ghost(32, 32, n=2)), (2, 8, 8, 32)),
    ("spp", lambda: (JM.SPP(32, (5, 9, 13)), TM.SPP(48, 32, (5, 9, 13))), (2, 8, 8, 48)),
    ("maxpool_s1", lambda: (JM.MaxPool2d(2, 1, 0), TM.MaxPool2d(2, 1, 0)), (2, 8, 8, 16)),
    ("zeropad", lambda: (JM.ZeroPad2d((0, 1, 0, 1)), TM.ZeroPad2d((0, 1, 0, 1))), (2, 8, 8, 16)),
    ("convtranspose", lambda: (JM.ConvTransposeBN(16, 2, 2, 0, use_bn=False, act=False), TM.ConvTranspose(24, 16)),
     (2, 8, 8, 24)),
]


@pytest.mark.parametrize("mode", ["eval", "folded"])
@pytest.mark.parametrize("name,make,shape", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(name, make, shape, mode):
    """Each block against its JAX module on the same bridged weights (`tests/test_torch_blocks.py`), eval mode,
    f32, atol 1e-5, unfolded and after the serving fold (3x3 s1 convs through conv3x3's plain version)."""
    jmod, tmod = make()
    ref, got = _pair(jmod, tmod, _x(shape))
    if mode == "folded":
        fuse_conv_bn(tmod, torch.float32)
        with torch.no_grad():
            got = tmod(torch.from_numpy(_x(shape).transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# -- the graphs -------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ZOO))
def test_yaml_builds_like_jax(name):
    """`YOLO(<name>)` on the meta device: the YAML is the JAX package's byte for byte; the JAX specs and save
    list; the strides; the torch reference's parameter count; the port's variable tree equal to the JAX graph's
    (every state_dict key the bridge's name). A repeated plain layer (v3's Bottlenecks, v6's Convs) is an
    nn.Sequential whose `model.<i>.<rep>` the bridge maps to the JAX `model_<i>_<rep>` with no rule of its own."""
    cfg, count, strides = ZOO[name]
    assert (PORT_CFG / cfg).read_bytes() == (JAX_CFG / cfg).read_bytes()
    yolo = YOLO(name, device="meta", seed=None)
    tm = yolo.model
    assert yolo.task == TASKS.get(cfg, "v8") and tm.strides == strides
    assert sum(p.numel() for p in tm.parameters()) == count
    specs, save = TC.parse_model(yolo.model_yaml)
    jspecs, jsave = JC.parse_model(yolo.model_yaml)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    shapes = jax_shapes(jax_graph(yolo.model_yaml, strides, tm.default_act))
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                         jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda t: isinstance(t, tuple))}
    port_shapes = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        assert flat(port_shapes[col]) == flat(shapes[col])
    for s in specs:
        if s.n > 1:  # each copy under the JAX name model_<i>_<rep>
            assert isinstance(tm.model[s.i], torch.nn.Sequential) and len(tm.model[s.i]) == s.n
            assert {f"model_{s.i}_{r}" for r in range(s.n)} <= set(shapes["params"])
            assert flax_name_to_torch((f"model_{s.i}_{s.n - 1}",)) == f"model.{s.i}.{s.n - 1}"
    if cfg.startswith(("v3/yolov3.", "v6/")):
        assert any(s.n > 1 for s in specs)


# -- narrow variants against the JAX graph --------------------------------------------------------------------------


def jax_eval(jm, variables, x):
    """The JAX eval-mode outputs (pred, and mc / proto / kpt where the head has them), compiled with XLA's
    fusion pass off."""
    fn = jax.jit(lambda v, t: {k: o for k, o in jm.apply(v, t, training=False).items() if k != "feats"})
    return jax.tree.map(np.asarray, fn.lower(variables, x).compile(compiler_options=XLA_OPTS)(variables, x))


@pytest.mark.parametrize("cfg", FAMILIES, ids=lambda c: Path(c).stem)
def test_narrow_forward_and_predict_match_jax(cfg):
    """A narrow variant's eval forward (batch 2, 64 px, f32) against the JAX graph on the same weights: the decoded
    boxes within 1e-3 px, scores within 1e-6; Segment's mask coefficients and prototypes, Pose's decoded keypoints
    within 1e-4 of the largest value. `predict` through the NMS at conf 0.25 / iou 0.45, unfolded and after the
    serving fold, against the JAX pred through the JAX NMS: as many rows, each matched tie-tolerantly."""
    d = narrow(cfg)
    tm = build_model(d, device="cpu")
    variables = random_variables(flax_shapes(tm), seed=1)
    load_flax(tm, variables)
    jm = jax_graph(d, tm.strides, tm.default_act)
    x = np.random.default_rng(3).random((2, S, S, 3), dtype=np.float32)
    ref = jax_eval(jm, variables, jnp.asarray(x))
    with torch.no_grad():
        out = tm(_nchw(x))
    out = out if isinstance(out, dict) else {"pred": TC.decode_feats(out, tm.strides, tm.nc, tm.reg_max)}
    A = sum((S // int(s)) ** 2 for s in tm.strides)
    assert out["pred"].shape == ref["pred"].shape == (2, A, 4 + tm.nc)
    got = out["pred"].numpy()
    np.testing.assert_allclose(got[..., :4], ref["pred"][..., :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[..., 4:], ref["pred"][..., 4:], rtol=0, atol=1e-6)
    extra = {"segment": ("mc", "proto"), "pose": ("kpt",)}.get(tm.task, ())
    for k in extra:
        r = ref[k] if k != "proto" else ref[k].transpose(0, 3, 1, 2)
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)
    want = np.asarray(jax_nms(jnp.asarray(ref["pred"]), 0.25, 0.45, 300))
    with torch.no_grad():
        dets = [tm.predict(_nchw(x)), fuse_conv_bn(tm, torch.float32).predict(_nchw(x))]
    for det in dets:
        det = (det[0] if isinstance(det, tuple) else det).numpy()
        for i in range(2):
            n = int((want[i, :, 5] >= 0).sum())
            assert n >= 3 and int((det[i, :, 5] >= 0).sum()) == n
            assert_detections_close(det[i, :n], want[i, :n], atol_box=1e-3, atol_score=1e-6)


def test_v6_resolves_relu_like_jax():
    """yolov6's `activation: nn.ReLU()`: in the port every ConvBN of the YAML's Convs and of the Detect towers
    takes ReLU and SPPF's keep Mish, as the JAX `apply_act` resolves them (JAX default_act "relu"); without the
    key they take SiLU. The BN statistics are `random_variables`' (means within 0.2 of 0, variances and scales in
    0.5..1.5, biases within 0.2), which keep every pre-activation within a few units of 0, where ReLU and SiLU
    differ; at init (identity BN, kaiming kernels) the plain-conv chain pushes them out of that range
    (`tests/test_yaml_zoo.py:99-118`). On the same weights the two builds' box and class logits then differ by
    more than 0.1 at every level, and the ReLU build's class scores equal the JAX ReLU graph's within 1e-6."""
    d = narrow("v6/yolov6.yaml")
    relu = build_model(d, device="cpu")
    silu = build_model({k: v for k, v in d.items() if k != "activation"}, device="cpu")
    assert (relu.default_act, silu.default_act) == ("relu", "silu")
    sppf = {id(c) for s in relu.model if isinstance(s, TM.SPPF) for c in s.modules()}
    assert all(m.act == ("mish" if id(m) in sppf else "relu") for m in relu.modules() if isinstance(m, TM.ConvBN))
    assert all(m.act == "relu" for m in relu.model[-1].modules() if isinstance(m, TM.ConvBN))
    assert all(m.act in ("silu", "mish") for m in silu.modules() if isinstance(m, TM.ConvBN))
    variables = random_variables(flax_shapes(relu), seed=2)
    load_flax(relu, variables)
    load_flax(silu, variables)
    x = np.random.default_rng(4).random((2, S, S, 3), dtype=np.float32)
    with torch.no_grad():
        maps = relu(_nchw(x)), silu(_nchw(x))
    for (rb, rc), (sb, sc) in zip(*maps):  # every level's box and class logits
        assert min(float((rb - sb).abs().max()), float((rc - sc).abs().max())) > 0.1
    scores = TC.decode_feats(maps[0], relu.strides, relu.nc)[..., 4:].numpy()
    assert JC.build_model(JAX_CFG / "v6" / "yolov6.yaml").default_act == "relu"
    ref = jax_eval(jax_graph(d, relu.strides, "relu"), variables, jnp.asarray(x))["pred"][..., 4:]
    np.testing.assert_allclose(scores, ref, rtol=0, atol=1e-6)


def test_jax_faults_the_port_does_not_copy():
    """Two JAX-side faults (ROADMAP Queue 3). (1) The JAX facade's resolver searches v10, v8 and v9 only
    (`lpc_yolo_tpu/engine/model.py:45`): `yolov5n.yaml`, `yolov3-tiny.yaml` and `yolov6n.yaml` are not found by
    name, while the port resolves them. (2) A YAML's `activation: nn.Mish()` sets the JAX default_act "mish", but
    `apply_act` resolves a conv.py-family conv to ReLU or else SiLU (`nn/modules.py:214-222`): the JAX graph with
    "mish" equals the one with "silu" bit for bit, where the reference applies Mish. The port's conv.py family
    takes Mish (its box and class logits differ from its SiLU build's by more than 1e-2 at every level), and it
    refuses an activation it has no epilogue for (nn.GELU())."""
    import lpc_yolo_tpu.engine.model as jax_model

    from lpc_yolo_tpu_torch.engine.model import _resolve_yaml

    for name, cfg in (("yolov5n.yaml", "v5/yolov5.yaml"), ("yolov3-tiny.yaml", "v3/yolov3-tiny.yaml"),
                      ("yolov6n.yaml", "v6/yolov6.yaml")):
        with pytest.raises(FileNotFoundError):
            jax_model._resolve_yaml(name)
        assert _resolve_yaml(name) == PORT_CFG / cfg
    d = narrow("v6/yolov6.yaml", activation="nn.Mish()")
    assert JC.build_model(d).default_act == "mish"
    mish = build_model(d, device="cpu")
    silu = build_model({k: v for k, v in d.items() if k != "activation"}, device="cpu")
    assert mish.default_act == "mish" and all(m.act == "mish" for m in mish.model[-1].modules()
                                               if isinstance(m, TM.ConvBN))
    variables = random_variables(flax_shapes(mish), seed=2)
    x = jnp.asarray(np.random.default_rng(4).random((1, S, S, 3), dtype=np.float32))
    jax_mish, jax_silu = (jax_eval(jax_graph(d, mish.strides, act), variables, x)["pred"] for act in ("mish", "silu"))
    np.testing.assert_array_equal(jax_mish, jax_silu)
    load_flax(mish, variables)
    load_flax(silu, variables)
    with torch.no_grad():
        for (mb, mc), (sb, sc) in zip(mish(_nchw(np.asarray(x))), silu(_nchw(np.asarray(x)))):
            assert min(float((mb - sb).abs().max()), float((mc - sc).abs().max())) > 1e-2
    with pytest.raises(NotImplementedError, match="GELU"):
        build_model({**d, "activation": "nn.GELU()"}, device="cpu")
