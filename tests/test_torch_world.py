"""YOLO-World of the port (yolov8-world, yolov8-worldv2, n to x) against the JAX package, on the CPU in f32: the
modules, the graphs, the text routing, `set_classes`, `predict` and `val` (training:
`tests/test_torch_world_train.py`).

Weights come from `random_variables` through the weight bridge; JAX variables are never made by a JAX `init`
(`jax.eval_shape` gives their shapes). Tolerances are absolute unless said otherwise.

* The modules against `lpc_yolo_tpu/nn/modules.py` and `nn/heads.py`: MaxSigmoidAttnBlock without its `ec` conv
  (c1 == ec) and with it, one head and several; C2fAttn; ImagePoolingAttn over levels of 7x5, 3x3 and 2x2 (uneven
  adaptive-pool windows) and of 20x20, 10x10 and 5x5 (640's overlapping P5 windows); ContrastiveHead;
  BNContrastiveHead in eval mode and in train mode (its BatchNorm statistics too); WorldDetect with M text rows
  != nc, with either head: within 1e-5 of the largest value, unfolded and, where ConvBNs fold, after the fold
  (`proj_conv` a conv3x3 site with the `none` epilogue).
* `encode_names` equal to the JAX one bit for bit, `embeddings=` checked and normalised.
* The ten graphs on the meta device (no forward): the YAMLs byte for byte, resolved by name; task "world"; the
  JAX `parse_model` specs (every C2fAttn's `ec` and `nh`, m's 9 and x's 10 heads pinned); the JAX graphs'
  parameter counts; the variable tree equal to the JAX graph's `jax.eval_shape` tree.
* Narrow copies of both YAMLs (scale [0.33, 0.125, 1024], nc 3, 64 px, batch 2, one seeded text a frame of M = 5
  rows): the eval forward's decoded boxes within 1e-3 px and scores within 1e-5 (v1's ImagePoolingAttn computed:
  it is no dead layer), the train-mode maps of the port's f32 run within 1e-4 of the largest value of the port's
  f64 run (batch statistics of 2x2 maps), JAX's maps and BatchNorm statistics within 5e-4 (its CPU BatchNorm
  drifts); a different text changes the scores; the folded serving copy against the unfolded graph.
* `set_classes` + `predict` of a narrow yolov8n-world against the JAX `YOLOWorld` facade on the same frames and
  weights (tie-tolerant: box 1e-3 px, score 1e-5), M = 2 classes on an nc-80 graph; `.ckpt` files keep task
  "world" in both packages.
* `val` with a zero text table (`set_classes(names, embeddings=zeros)`) against the JAX validator, which passes
  no text (`assert_val_results_agree`); with the names' table the port's scores differ from it (the JAX fault:
  ROADMAP Queue 3, shown in `tests/test_torch_world_train.py`).
"""

import dataclasses
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.nn import heads as JH
from lpc_yolo_tpu.nn import modules as JM
from lpc_yolo_tpu.ops.letterbox import letterbox_image
from lpc_yolo_tpu.utils.metrics import box_iou_np
from lpc_yolo_tpu.utils.text_embed import encode_names as jax_encode_names

from lpc_yolo_tpu_torch import YOLO, YOLOWorld
from lpc_yolo_tpu_torch.engine.predictor import serving_model
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import heads as TH
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites, fuse_conv_bn
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close, assert_val_results_agree
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, load_flax, random_variables
from lpc_yolo_tpu_torch.utils.text_embed import encode_names
from test_torch_rtdetr import jax_apply, seeded
from test_torch_v8 import jax_detections, small_boxes
from test_torch_zoo import JAX_CFG, PORT_CFG, S, jax_graph

# name given to YOLO -> (the YAML under cfg/models, the JAX graph's parameter count: 4,204,095 and 3,695,167 are
# tests/test_v9_world.py's and tests/test_yaml_zoo.py's less the DFL's 16, the others the JAX graph's own)
WORLD = {
    "yolov8n-world.yaml": ("v8/yolov8-world.yaml", 4_204_095), "yolov8s-world.yaml": ("v8/yolov8-world.yaml", 13_383_480),
    "yolov8m-world.yaml": ("v8/yolov8-world.yaml", 29_065_294), "yolov8l-world.yaml": ("v8/yolov8-world.yaml", 47_553_954),
    "yolov8x-world.yaml": ("v8/yolov8-world.yaml", 73_690_201),
    "yolov8n-worldv2.yaml": ("v8/yolov8-worldv2.yaml", 3_695_167),
    "yolov8s-worldv2.yaml": ("v8/yolov8-worldv2.yaml", 12_759_864),
    "yolov8m-worldv2.yaml": ("v8/yolov8-worldv2.yaml", 28_376_142),
    "yolov8l-worldv2.yaml": ("v8/yolov8-worldv2.yaml", 46_832_034),
    "yolov8x-worldv2.yaml": ("v8/yolov8-worldv2.yaml", 72_886_361),
}
# each scale's C2fAttn (ec, nh), in layer order: tasks.py:902-906's scaling
ATTN = {"n": [(64, 2), (32, 1), (64, 2), (128, 4)], "s": [(128, 4), (64, 2), (128, 4), (256, 8)],
        "m": [(192, 6), (96, 3), (192, 6), (288, 9)], "l": [(256, 8), (128, 4), (256, 8), (256, 8)],
        "x": [(320, 10), (160, 5), (320, 10), (320, 10)]}
NARROW = [0.33, 0.125, 1024]
M_TEXT = 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are small at imgsz 64: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def narrow(cfg: str, nc: int = 3) -> dict:
    """The YAML dict at scale n = NARROW (every layer kept) and `nc` classes."""
    d = yaml.safe_load((PORT_CFG / cfg).read_text())
    return {**d, "scales": {"n": NARROW}, "scale": "n", "nc": nc}


def texts(seed: int, b: int = 2, m: int = M_TEXT) -> np.ndarray:
    """(b, m, 512) text rows, one table a frame, each row L2-normalised (as `encode_names` gives them)."""
    t = _x((b, m, 512), seed)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


def assert_rel_close(got, ref, tol=1e-5, what=""):
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max(), err_msg=what)


# -- the modules ----------------------------------------------------------------------------------------------------

# (name, JAX module, port module, input shape NHWC)
ATTN_BLOCKS = [
    ("no_ec_one_head", lambda: (JM.MaxSigmoidAttnBlock(32, nh=1, ec=32), TM.MaxSigmoidAttnBlock(32, 32, 1, 32)),
     (2, 6, 5, 32)),
    ("ec_two_heads", lambda: (JM.MaxSigmoidAttnBlock(32, nh=2, ec=32), TM.MaxSigmoidAttnBlock(16, 32, 2, 32)),
     (2, 6, 5, 16)),
    ("no_ec_four_heads", lambda: (JM.MaxSigmoidAttnBlock(64, nh=4, ec=64), TM.MaxSigmoidAttnBlock(64, 64, 4, 64)),
     (2, 5, 7, 64)),
    ("c2fattn", lambda: (JM.C2fAttn(32, n=2, ec=16, nh=2), TM.C2fAttn(24, 32, n=2, ec=16, nh=2)), (2, 6, 5, 24)),
]


@pytest.mark.parametrize("mode", ["eval", "folded"])
@pytest.mark.parametrize("name,make,shape", ATTN_BLOCKS, ids=[b[0] for b in ATTN_BLOCKS])
def test_attention_block_matches_jax(name, make, shape, mode, monkeypatch):
    """MaxSigmoidAttnBlock and C2fAttn against their JAX modules on the same weights, with a text of 5 rows a
    frame (gc 512), eval mode: within 1e-5 of the largest value, unfolded and after `fuse_conv_bn`, where every
    `proj_conv` is a conv3x3 site with the `none` epilogue (act False) and the `ec` conv exists only when c1 != ec."""
    jmod, tmod = make()
    x, t = _x(shape, 1), texts(2)
    variables = seeded(jmod, jnp.asarray(x), jnp.asarray(t), training=True)
    ref = jax_apply(jmod, variables, jnp.asarray(x), jnp.asarray(t), training=False)
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    tmod.eval()
    attn = tmod.attn if isinstance(tmod, TM.C2fAttn) else tmod
    assert (attn.ec is None) == (name != "ec_two_heads")
    acts = []
    if mode == "folded":
        fuse_conv_bn(tmod, torch.float32)
        assert attn.proj_conv in conv3x3_sites(tmod) and attn.proj_conv.folded is not None
        conv3x3 = TM.conv3x3
        monkeypatch.setattr(TM, "conv3x3", lambda x, w, b, act: acts.append(act) or conv3x3(x, w, b, act))
    with torch.no_grad():
        got = tmod(_nchw(x), torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert_rel_close(got, ref)
    if mode == "folded":
        assert acts[-1] is False and len(acts) == len(conv3x3_sites(tmod))


@pytest.mark.parametrize("levels", [[(7, 5), (3, 3), (2, 2)], [(20, 20), (10, 10), (5, 5)]],
                         ids=["uneven", "p5_at_640"])
def test_image_pooling_attn_matches_jax(levels):
    """ImagePoolingAttn over three levels (16, 24 and 32 channels, ec 32, 8 heads, k 3) and a text of 5 rows a frame,
    against the JAX module (whose windows are built by hand): the enhanced text (B, 5, 512) within 1e-5 of the
    largest value, on uneven maps (7x5: windows [0,3) [2,5) [4,7) by [0,2) [1,4) [3,5)) and on 640's P5 size
    (20x20: [0,7) [6,14) [13,20))."""
    xs = [_x((2, h, w, c), 10 + i) for i, ((h, w), c) in enumerate(zip(levels, (16, 24, 32)))]
    t = texts(3)
    jmod, tmod = JM.ImagePoolingAttn(ec=32, ch=(16, 24, 32)), TM.ImagePoolingAttn(32, (16, 24, 32))
    variables = seeded(jmod, [jnp.asarray(a) for a in xs], jnp.asarray(t), training=True)
    ref = jax_apply(jmod, variables, [jnp.asarray(a) for a in xs], jnp.asarray(t), training=False)
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = tmod.eval()([_nchw(a) for a in xs], torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, M_TEXT, 512)
    assert_rel_close(got, ref)


@pytest.mark.parametrize("head,training", [("plain", False), ("bn", False), ("bn", True)])
def test_contrastive_heads_match_jax(head, training):
    """ContrastiveHead and BNContrastiveHead ((B, 32, 6, 5) embeddings, 4 text rows a frame; scalar `bias` and
    `logit_scale` seeded) against their JAX modules: the logits (B, 4, 6, 5) within 1e-5 of the largest value; the
    BN head in train mode normalises by the batch and moves its statistics as the JAX BatchNorm does (5e-6). Init:
    logit_scale log(1 / 0.07) and -1.0, bias 0."""
    x, w = _x((2, 6, 5, 32), 4), _x((2, 4, 32), 5)
    jmod, tmod = (JM.ContrastiveHead(), TM.ContrastiveHead()) if head == "plain" else \
        (JM.BNContrastiveHead(32), TM.BNContrastiveHead(32))
    assert tmod.bias.item() == 0 and tmod.logit_scale.item() == pytest.approx(
        np.log(1 / 0.07) if head == "plain" else -1.0)
    variables = seeded(jmod, jnp.asarray(x), jnp.asarray(w), training=True)
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    tmod.train(training)
    with torch.no_grad():
        got = tmod(_nchw(x), torch.from_numpy(w)).numpy()
    if training:
        ref, mut = jax_apply(jmod, variables, jnp.asarray(x), jnp.asarray(w), training=True, mutable=["batch_stats"])
        stats = flax_to_state_dict({"batch_stats": mut["batch_stats"]})
        for k, v in stats.items():
            np.testing.assert_allclose(tmod.state_dict()[k].numpy(), v.numpy(), rtol=0, atol=5e-6, err_msg=k)
    else:
        ref = jax_apply(jmod, variables, jnp.asarray(x), jnp.asarray(w), training=False)
    assert got.shape == ref.transpose(0, 3, 1, 2).shape == (2, 4, 6, 5)
    assert_rel_close(got, ref.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("with_bn", [False, True])
def test_world_detect_matches_jax(with_bn):
    """WorldDetect (nc 80 for c3, embed 64, three levels of 16, 24 and 32 channels) against the JAX head with 3 text
    rows != nc: per level the box map and the 3 class maps of the JAX (B, H, W, 64 + 3) output within 1e-5 of the
    largest value; the class count follows the text."""
    xs = [_x((2, s, s, c), 20 + i) for i, (s, c) in enumerate(zip((8, 4, 2), (16, 24, 32)))]
    t = _x((2, 3, 64), 6)
    jmod = JH.WorldDetect(nc=80, embed=64, with_bn=with_bn, ch=(16, 24, 32))
    tmod = TH.WorldDetect(nc=80, embed=64, with_bn=with_bn, ch=(16, 24, 32))
    variables = seeded(jmod, [jnp.asarray(a) for a in xs], jnp.asarray(t), training=True)
    ref = jax_apply(jmod, variables, [jnp.asarray(a) for a in xs], jnp.asarray(t), training=False)
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = tmod.eval()([_nchw(a) for a in xs], torch.from_numpy(t))
    for (box, cls), r in zip(got, ref):
        assert cls.shape == (2, 3) + r.shape[1:3] and r.shape[-1] == 64 + 3
        assert_rel_close(torch.cat([box, cls], 1).permute(0, 2, 3, 1).numpy(), r)


def test_encode_names_matches_jax():
    """`encode_names` equals the JAX one bit for bit (SHA-256 seeds, unit rows); given embeddings are checked and
    normalised, zero rows staying zero."""
    names = ["person", "bus", "a red traffic cone"]
    a, b = encode_names(names), jax_encode_names(names)
    assert a.dtype == np.float32 and a.shape == (3, 512) and a.tobytes() == b.tobytes()
    e = _x((3, 512), 7)
    e[1] = 0
    np.testing.assert_array_equal(encode_names(names, embeddings=e), jax_encode_names(names, embeddings=e))
    assert not encode_names(names, embeddings=e)[1].any()
    with pytest.raises(ValueError):
        encode_names(names, embeddings=e[:2])


# -- the graphs -----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(WORLD))
def test_yaml_builds_like_jax(name):
    """`YOLO(<name>)` on the meta device: the YAML is the JAX package's byte for byte and resolves by its name; task
    "world"; the JAX specs and save list, every C2fAttn's (ec, nh) pinned (m's 9 and x's 10 heads); strides (8,
    16, 32); no dead layer (v1's ImagePoolingAttn is read by no layer); the JAX graph's parameter count and its
    `jax.eval_shape` variable tree, leaf by leaf (the contrastive heads' rank-0 `bias` and `logit_scale`, v2's
    `norm` BatchNorm, the LayerNorms and Dense kernels)."""
    cfg, count = WORLD[name]
    assert (PORT_CFG / cfg).read_bytes() == (JAX_CFG / cfg).read_bytes()
    yolo = YOLO(name, device="meta", seed=None)
    tm = yolo.model
    assert Path(yolo.model_yaml["yaml_file"]) == PORT_CFG / cfg
    assert yolo.task == tm.task == "world" and tm.strides == (8.0, 16.0, 32.0) and not tm.dead
    specs, save = TC.parse_model(yolo.model_yaml)
    jspecs, jsave = JC.parse_model(yolo.model_yaml)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    assert [(s.args[3], s.args[4]) for s in specs if s.module == "C2fAttn"] == ATTN[name[6]]
    assert sum(p.numel() for p in tm.parameters()) == count
    jm = jax_graph(yolo.model_yaml, tm.strides)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                         jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda t: isinstance(t, tuple))}
    port = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        assert flat(port[col]) == flat(shapes[col])
    assert sum(int(np.prod(s)) for s in flat(shapes["params"]).values()) == count


def test_yoloworld_facade_and_set_classes():
    """`YOLOWorld()` builds yolov8s-world; its text table is the COCO-80 names' (1, 80, 512); `set_classes` takes
    names and optional embeddings ((M, 512), normalised) and refuses a model that is not World."""
    y = YOLOWorld(device="meta", seed=None)
    assert Path(y.model_yaml["yaml_file"]).name == "yolov8-world.yaml" and y.model_yaml["scale"] == "s"
    assert y.task == "world" and sum(p.numel() for p in y.model.parameters()) == WORLD["yolov8s-world.yaml"][1]
    assert y.txt_feats.shape == (1, 80, 512)
    np.testing.assert_array_equal(y.txt_feats[0], encode_names([y.names[i] for i in range(80)]))
    y.set_classes(["person", "bus"])
    assert y.names == {0: "person", 1: "bus"} and y.txt_feats.shape == (1, 2, 512)
    y.set_classes(["a", "b", "c"], embeddings=np.full((3, 512), 2.0))
    np.testing.assert_allclose(y.txt_feats, np.full((1, 3, 512), 512 ** -0.5), rtol=1e-6)
    with pytest.raises(ValueError, match="world"):
        YOLO("yolov8n.yaml", device="meta", seed=None).set_classes(["person"])


def jax_eval(jm, variables, x, t):
    fn = jax.jit(lambda v, x, t: jm.apply(v, x, training=False, predict_only=True, text=t)["pred"])
    return np.asarray(fn.lower(variables, x, t).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})(
        variables, x, t))


@pytest.fixture(scope="module", params=["v8/yolov8-world.yaml", "v8/yolov8-worldv2.yaml"],
                ids=["world", "worldv2"])
def narrow_graph(request):
    """A narrow copy of the YAML (nc 3), the port's model on its seeded variables, and the JAX graph."""
    d = narrow(request.param)
    tm = build_model(d, device="cpu")
    variables = random_variables(flax_shapes(tm), seed=1)
    load_flax(tm, variables)
    return d, tm, variables, jax_graph(d, tm.strides)


def test_narrow_eval_forward_matches_jax(narrow_graph):
    """The eval forward with one text of 5 rows a frame: the decoded (B, 84, 4 + 5) boxes within 1e-3 px and scores
    within 1e-5 of the JAX graph's `apply(text=...)`. v1's layer 16 (ImagePoolingAttn) is computed: the C2fAttn
    layers after it read its enhanced text, WorldDetect the original. A second text changes the scores."""
    d, tm, variables, jm = narrow_graph
    x = np.random.default_rng(3).random((2, S, S, 3), dtype=np.float32)
    scores = []
    for seed in (8, 9):
        t = texts(seed)
        ref = jax_eval(jm, variables, jnp.asarray(x), jnp.asarray(t))
        with torch.no_grad():
            feats = tm.eval()(_nchw(x), text=torch.from_numpy(t))
        got = TC.decode_feats(feats, tm.strides, M_TEXT, tm.reg_max).numpy()
        assert got.shape == ref.shape == (2, 84, 4 + M_TEXT)
        np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[..., 4:], ref[..., 4:], rtol=0, atol=1e-5)
        scores.append(got[..., 4:])
    assert np.abs(scores[0] - scores[1]).max() > 1e-2
    if any(s.module == "ImagePoolingAttn" for s in tm.specs):
        assert "ImagePoolingAttn" in {tm.specs[i].module for i in range(len(tm.specs)) if i not in tm.dead}


def test_narrow_train_forward_matches_jax(narrow_graph):
    """The train-mode forward (batch statistics) with one text a frame, held to the port's f64 run: the port's f32
    maps within 1e-4 of each level's largest value (batch statistics of 2x2 maps at batch 2, 8 values a channel,
    magnify f32 rounding: the port's own f32 run is 1.1e-5 off) and its BatchNorm statistics within 1e-5; the JAX
    graph's concatenated maps within 5e-4 (1.3e-4 off) and its statistics within 5e-4 (JAX's CPU BatchNorm drifts
    by that much: ROADMAP Queue 3)."""
    d, tm, variables, jm = narrow_graph
    x = np.random.default_rng(4).random((2, S, S, 3), dtype=np.float32)
    t = texts(10)
    fn = jax.jit(lambda v, x, t: jm.apply(v, x, training=True, text=t, mutable=["batch_stats"]))
    ref, mut = jax.tree.map(np.asarray, fn.lower(variables, jnp.asarray(x), jnp.asarray(t)).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion"})(variables, jnp.asarray(x), jnp.asarray(t)))
    runs = {}
    for dtype in (torch.float32, torch.float64):
        m = load_flax(build_model(d, device="cpu"), variables).to(dtype).train()
        with torch.no_grad():
            out = m(_nchw(x).to(dtype), text=torch.from_numpy(t).to(dtype))
        runs[dtype] = ([torch.cat([box, cls], 1).permute(0, 2, 3, 1).double().numpy() for box, cls in out],
                       m.state_dict())
        assert all(cls.shape[1] == M_TEXT for _, cls in out)
    for got, f64, r in zip(runs[torch.float32][0], runs[torch.float64][0], ref):
        assert_rel_close(got, f64, 1e-4, "f32 against f64")
        assert_rel_close(r, f64, 5e-4, "JAX against the port's f64")
    for k, v in flax_to_state_dict({"batch_stats": mut["batch_stats"]}).items():
        np.testing.assert_allclose(runs[torch.float64][1][k].numpy(), v.numpy(), rtol=0, atol=5e-4, err_msg=k)
        np.testing.assert_allclose(runs[torch.float32][1][k].numpy(), runs[torch.float64][1][k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_folded_serving_copy_matches_unfolded(narrow_graph, monkeypatch):
    """`serving_model` (BN folded into every ConvBN, /255 into layer 0; the contrastive heads kept in f32, v2's
    BatchNorm unfolded) fed the 0..255 frame, against the unfolded graph fed the frame / 255: the decoded boxes
    and scores within 1e-4; the forward calls conv3x3 once a site, the `none` epilogue at every `proj_conv`, and
    `predict` decodes M classes through the NMS."""
    d, tm, variables, jm = narrow_graph
    frames = np.random.default_rng(5).integers(0, 256, (2, S, S, 3)).astype(np.float32)
    t = torch.from_numpy(texts(11))
    serving = serving_model(tm, torch.device("cpu"), torch.float32)
    sites = conv3x3_sites(serving)
    projs = [m.attn.proj_conv for m in serving.modules() if isinstance(m, TM.C2fAttn)]
    assert len(projs) == 4 and all(p in sites for p in projs)
    acts, conv3x3 = [], TM.conv3x3
    monkeypatch.setattr(TM, "conv3x3", lambda x, w, b, act: acts.append(act) or conv3x3(x, w, b, act))
    with torch.no_grad():
        got = TC.decode_feats(serving(_nchw(frames), text=t), tm.strides, M_TEXT, tm.reg_max).numpy()
        rows = serving.predict(_nchw(frames), conf=0.0, text=t)
    monkeypatch.undo()
    assert len(acts) == 2 * len(sites) and acts.count(False) == 2 * len(projs)
    with torch.no_grad():
        ref = TC.decode_feats(tm.eval()(_nchw(frames / np.float32(255)), text=t), tm.strides, M_TEXT,
                              tm.reg_max).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert rows.shape == (2, 300, 6) and set(rows[..., 5].unique().tolist()) <= {-1.0, *range(M_TEXT)}


# -- the entry points -----------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def narrow_v1(tmp_path_factory):
    """A narrow yolov8n-world (nc 80, every layer kept) written to a YAML whose name gives scale n, and its seeded
    variables."""
    cfg = tmp_path_factory.mktemp("world") / "yolov8n-world-narrow.yaml"
    cfg.write_text(yaml.safe_dump(narrow("v8/yolov8-world.yaml", nc=80)))
    model = YOLO(cfg, device="meta", seed=None).model
    return cfg, random_variables(flax_shapes(model), seed=6)


def jax_world(monkeypatch, cfg: Path, variables, nc: int = 80):
    """The JAX `YOLOWorld` facade on `cfg` with `variables`, not its init."""
    import lpc_yolo_tpu
    import lpc_yolo_tpu.engine.model as jax_model

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: variables)
    yolo = lpc_yolo_tpu.YOLOWorld(str(cfg))
    assert yolo.task == "world" and yolo.txt_feats.shape == (1, nc, 512)
    return yolo


def frames(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)]


def test_set_classes_predict_matches_jax(narrow_v1, monkeypatch, tmp_path):
    """`set_classes(["person", "bus"])` + `predict` (batch 2, imgsz 64, conf 0.25, the NMS over M = 2 classes of an
    nc-80 graph) against the JAX `YOLOWorld` facade on the same weights and frames: as many rows a frame, each
    matched tie-tolerantly (box 1e-3 px, score 1e-5), labels in {0, 1}, `Results.names` the two names; the default
    COCO-80 table too. `YOLO.save` keeps task "world" in both packages, and in the port the two names and their
    table (the JAX facade renames the classes 0..nc-1 when M != nc)."""
    cfg, variables = narrow_v1
    jy = jax_world(monkeypatch, cfg, variables)
    yolo = YOLO(cfg, device="cpu", seed=None).load_flax(variables)
    im = frames(12)
    for names in (None, ["person", "bus"]):
        if names:
            jy.set_classes(names)
            yolo.set_classes(names)
        ref = jy.predict(im, imgsz=S, batch=2)
        got = yolo.predict(im, imgsz=S, batch=2)
        for a, b in zip(got, ref):
            assert 3 <= len(a) == len(b) and a.names == yolo.names
            assert_detections_close(a.boxes.data, np.asarray(b.boxes.data), atol_box=1e-3, atol_score=1e-5)
    assert set(np.concatenate([r.boxes.data[:, 5] for r in got]).tolist()) <= {0.0, 1.0}
    back = YOLO(yolo.save(tmp_path / "world.ckpt"), device="cpu")
    assert (back.task, back.names, back.model.nc) == ("world", {0: "person", 1: "bus"}, 80)
    np.testing.assert_array_equal(back.txt_feats, yolo.txt_feats)
    import lpc_yolo_tpu.engine.model as jax_model

    jback = jax_model.YOLO(str(tmp_path / "world.ckpt"))  # (its init still the seeded variables: the template)
    assert jback.task == "world" and len(jback.names) == 80  # the JAX facade keeps names only when M == nc
    head = jax.device_get(jback.variables)["params"]["model_23"]
    assert all(np.shape(head[f"cv4_{i}"][k]) == () for i in range(3) for k in ("bias", "logit_scale"))


def write_tied_dataset(root: Path, jm, variables) -> Path:
    """Six noise PNGs no larger than imgsz (only padded by the validator's letterbox), one without a label file,
    nc 3; the labels are boxes of the JAX graph's own zero-text rows (every class of an anchor tied) inside the
    frame and not overlapping another label, up to 3 a frame, their classes 0, 1, 2 in turn."""
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i, (h0, w0) in enumerate(((48, 40), (64, 64), (50, 64), (32, 56), (64, 30), (40, 40))):
        img = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "images" / "val" / f"{i}.png"), img)
        if i == 4:
            continue
        lb, gain, (pw, ph) = letterbox_image(img, (S, S), scaleup=False)
        det = jax_detections(jm, variables, lb[None, ..., ::-1].astype(np.float32) / 255, 0.001, 0.7, True)[0]
        keep = []
        for b in det[det[:, 5] >= 0, :4].astype(np.float64):
            if min(b[2] - b[0], b[3] - b[1]) < 4 or min(b[0] - pw, b[1] - ph, pw + w0 - b[2], ph + h0 - b[3]) < 0:
                continue
            if keep and box_iou_np(np.stack(keep), b[None]).max() > 0.4:
                continue
            keep.append(b)
            if len(keep) == 3:
                break
        lines = [f"{c} {(b[0] + b[2]) / 2 - pw:.6f} {(b[1] + b[3]) / 2 - ph:.6f} {b[2] - b[0]:.6f} {b[3] - b[1]:.6f}"
                 for c, b in enumerate(keep)]
        lines = [" ".join([ln.split()[0]] + [f"{float(v) / n:.6f}" for v, n in zip(ln.split()[1:], (w0, h0, w0, h0))])
                 for ln in lines]
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(lines) + "\n")
    (root / "data.yaml").write_text(yaml.safe_dump({"path": str(root), "val": "images/val", "nc": 3}))
    return root / "data.yaml"


def test_val_matches_jax_with_zero_text(tmp_path, monkeypatch):
    """`val(data=...)` of a narrow yolov8n-world at nc 3 (its boxes made to fit 64 px: `small_boxes`; conf 0.001, iou 0.7, multi-label NMS, batch 4) with the
    dataset's names and a zero text table against the JAX facade's `val`, whose validator passes no text and so
    runs the graph on zeros (every class of a level then scores its contrastive head's bias): the results agree
    (`assert_val_results_agree`). With the names' own table the port's results differ from that; a table whose M
    is not the dataset's nc is refused."""
    cfg = tmp_path / "yolov8n-world-narrow.yaml"
    d = narrow("v8/yolov8-world.yaml", nc=3)
    cfg.write_text(yaml.safe_dump(d))
    yolo = YOLO(cfg, device="cpu", seed=None)
    variables = small_boxes(random_variables(flax_shapes(yolo.model), seed=7), "model_23")
    yolo.load_flax(variables)
    jy = jax_world(monkeypatch, cfg, variables, nc=3)
    data = write_tied_dataset(tmp_path / "data", jax_graph(d, yolo.model.strides), variables)
    ref = jy.val(data=str(data), imgsz=S, batch=4, workers=2)
    names = ["0", "1", "2"]
    got = yolo.set_classes(names, embeddings=np.zeros((3, 512))).val(data=str(data), imgsz=S, batch=4, workers=2)
    assert ref["metrics/mAP50(B)"] > 0  # the labels are rows of the JAX run (all of a level's rows tie: AP is low)
    assert_val_results_agree(got, ref)
    own = yolo.set_classes(names).val(data=str(data), imgsz=S, batch=4, workers=2)
    assert own != got and all(np.isfinite(list(own.values())))
    with pytest.raises(ValueError, match="set_classes"):
        yolo.set_classes(["person", "bus"]).val(data=str(data), imgsz=S, batch=4, workers=2)
