"""RT-DETR of the port (rtdetr-l, rtdetr-x, rtdetr-resnet50, rtdetr-resnet101, yolov8-rtdetr) against the JAX
package, on the CPU in f32: serving and validation (training: `tests/test_torch_rtdetr_train.py`).

Weights come from `random_variables` and reach both packages through the weight bridge; the JAX variables are
never made by a JAX `init` (`jax.eval_shape` gives their shapes). Tolerances are absolute unless said otherwise.

* The blocks (LightConv, HGStem at an odd input size, HGBlock at k=3 and as a light k=5 block with its shortcut,
  RepC3), unfolded and folded, against their JAX modules: atol 1e-5.
* The transformer parts against `lpc_yolo_tpu/nn/transformer.py`: the sin-cos embedding (1e-6) and AIFI (1e-5)
  on a non-square map, the encoder layer, the MLP, `multi_scale_deformable_attn` with sampling points outside
  the map, MSDeformAttn and the decoder layer (1e-5), and RTDETRDecoder's eval branch (1e-4, row by row in
  order) where the top-k cutoff falls inside a group of tied scores: the anchors outside the valid band (whose
  tokens are zero) and those of a constant map score exactly alike, and the port must keep JAX's tie order.
* The bridge: each YAML's variable tree equal to the JAX graph's `jax.eval_shape` tree (LayerNorm, 3-D attention
  kernels, the decoder's `input_proj_<i>_1` BatchNorms, `denoising_class_embed`), and a seeded tree through the
  port's state_dict and back bit for bit; the five parameter counts on the meta device.
* The graphs with a small decoder (hd 64, nq 60, nh 4, ndl 2, as `tests/test_tasks.py` cuts it) at 64 px:
  rtdetr-l's and yolov8n-rtdetr's forward (1e-4), every YAML's folded serving copy (BN folded, RepConvs into
  one conv3x3 site each, /255 into the stem) against the unfolded model (1e-4), `predict` against the JAX
  facade's rows (ties tolerated by `utils/compare.py`: box 1e-3 px, score 1e-5), and `val` against the JAX
  validator (`assert_val_results_agree`).
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
from lpc_yolo_tpu.nn import modules as JM
from lpc_yolo_tpu.nn import transformer as JT
from lpc_yolo_tpu.ops.letterbox import letterbox_image
from lpc_yolo_tpu.utils.metrics import box_iou_np

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine.predictor import serving_model
from lpc_yolo_tpu_torch.engine.train_step import OptConfig, make_train_step
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn import transformer as TT
from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites, frame_readers, fuse_conv_bn
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close, assert_val_results_agree
from lpc_yolo_tpu_torch.utils.flax_bridge import (flax_shapes, flax_to_state_dict, load_flax, random_variables,
                                                  state_dict_to_flax)
from test_torch_blocks import _pair, _x
from test_torch_v8 import XLA_OPTS
from test_torch_zoo import JAX_CFG, PORT_CFG, S, jax_graph

# name given to YOLO -> (the YAML under cfg/models, the JAX graph's parameter count (tests/test_yaml_zoo.py,
# tests/test_tasks.py: yolov8-rtdetr's first scale plus the 80 x 256 denoising table), conv3x3 sites a forward)
DETR = {
    "rtdetr-l.yaml": ("rt-detr/rtdetr-l.yaml", 32_970_476, 24),
    "rtdetr-x.yaml": ("rt-detr/rtdetr-x.yaml", 67_467_852, 30),
    "rtdetr-resnet50.yaml": ("rt-detr/rtdetr-resnet50.yaml", 42_925_132, 25),
    "rtdetr-resnet101.yaml": ("rt-detr/rtdetr-resnet101.yaml", 61_917_260, 42),
    "yolov8n-rtdetr.yaml": ("v8/yolov8-rtdetr.yaml", 9_623_388 + 80 * 256, 20),
}
SMALL_DECODER = [64, 60, 4, 4, 2, 256]  # hd, nq, ndp, nh, ndl, d_ffn


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are small at imgsz 64: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def small(cfg: str, nc: int = 80) -> dict:
    """The YAML dict with the small decoder, every other layer as published."""
    d = yaml.safe_load((PORT_CFG / cfg).read_text())
    assert d["head"][-1][2] == "RTDETRDecoder"
    d["head"][-1][3] = ["nc", *SMALL_DECODER]
    return {**d, "nc": nc}


def jax_apply(jmod, variables, *args, **kw):
    """The JAX module's output as numpy, compiled with XLA's fusion pass off."""
    fn = jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))
    return jax.tree.map(np.asarray, fn.lower(variables, *args).compile(compiler_options=XLA_OPTS)(variables, *args))


def seeded(jmod, *args, seed=0, **kw):
    """Variables for `jmod` from `random_variables` of its `jax.eval_shape` tree (training=True where the module
    takes it, so every parameter exists)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, **kw))
    return random_variables(shapes, seed)


# -- the blocks -----------------------------------------------------------------------------------------------------

# (name, factory of (JAX module, port module), input shape)
BLOCKS = [
    ("lightconv_k5", lambda: (JM.LightConv(24, 5), TM.LightConv(16, 24, 5)), (2, 8, 8, 16)),
    ("hgstem_odd", lambda: (JM.HGStem(16, 24), TM.HGStem(3, 16, 24)), (2, 17, 13, 3)),
    ("hgblock_k3", lambda: (JM.HGBlock(16, 32, k=3, n=3), TM.HGBlock(24, 16, 32, 3, 3)), (2, 8, 8, 24)),
    ("hgblock_light_k5_shortcut", lambda: (JM.HGBlock(16, 32, k=5, n=2, lightconv=True, shortcut=True),
                                           TM.HGBlock(32, 16, 32, 5, 2, lightconv=True, shortcut=True)),
     (2, 8, 8, 32)),
    ("repc3", lambda: (JM.RepC3(32, n=2), TM.RepC3(24, 32, n=2)), (2, 8, 8, 24)),
]


@pytest.mark.parametrize("mode", ["eval", "folded"])
@pytest.mark.parametrize("name,make,shape", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(name, make, shape, mode):
    """Each block against its JAX module on the same bridged weights, eval mode, f32, atol 1e-5, unfolded and
    after the serving fold (RepC3's RepConvs merged; 3x3 s1 convs through conv3x3's plain version). HGStem's
    one-sided pads and its 2x2 stride-1 max-pool over the padded map hold at an odd size (17 x 13); a light
    HGBlock's shortcut needs c1 == c2."""
    jmod, tmod = make()
    ref, got = _pair(jmod, tmod, _x(shape))
    if mode == "folded":
        fuse_conv_bn(tmod, torch.float32)
        with torch.no_grad():
            got = tmod(_nchw(_x(shape))).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    if name == "hgblock_light_k5_shortcut":
        assert tmod.add and not TM.HGBlock(24, 16, 32, 5, 2, lightconv=True, shortcut=True).add


def test_hgblock_and_repc3_sites():
    """An HGBlock of k=3 ConvBNs has n conv3x3 sites (Mish), a light one none (its 1x1s and depthwise 5x5s go to
    F.conv2d); each RepConv of RepC3 (no identity branch) is one site with conv.py's SiLU."""
    assert [m.act for m in conv3x3_sites(TM.HGBlock(24, 16, 32, 3, 3))] == ["mish"] * 3
    assert conv3x3_sites(TM.HGBlock(32, 16, 32, 5, 2, lightconv=True, shortcut=True)) == []
    rep = TM.RepC3(24, 32, n=3)
    assert conv3x3_sites(rep) == list(rep.m) and all(m.bn is None and m.act == "silu" for m in rep.m)


# -- the transformer parts -------------------------------------------------------------------------------------------


def test_sincos_pos_embed_non_square():
    """The embedding of a 5 x 3 map (w x h), dim 32: the JAX one within 1e-6, in its transposed meshgrid order
    (token t = i * h + j takes column i = t // h), which is not the map's own (t = y * w + x)."""
    got = TT.sincos_2d_pos_embed(5, 3, 32).numpy()
    ref = np.asarray(JT.sincos_2d_pos_embed(5, 3, 32))
    assert got.shape == ref.shape == (1, 15, 32)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    column = np.sin(np.arange(15) // 3)  # the first feature is sin(i * omega_0), omega_0 = 1
    np.testing.assert_allclose(got[0, :, 0], column, atol=1e-6)
    assert np.abs(got[0, :, 0] - np.sin(np.arange(15) % 5)).max() > 0.5


def test_aifi_non_square():
    """AIFI over a 3 x 5 map (c 32, cm 64, 4 heads), batch 2: the port's NCHW map flattens h-major as the JAX
    NHWC reshape does, and the result is the JAX module's within 1e-5."""
    ref, got = _pair(JT.AIFI(32, 64, 4), TT.AIFI(32, 64, 4), _x((2, 3, 5, 32)))
    assert got.shape == ref.shape == (2, 3, 5, 32)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_encoder_layer_and_mlp():
    """TransformerEncoderLayer (c 32, cm 64, 4 heads; post-norm, exact GELU, flax's LayerNorm eps and query
    scale) with a position term, and a 3-layer MLP, against the JAX modules within 1e-5."""
    x, pos = _x((2, 7, 32)), _x((1, 7, 32), seed=2)
    jmod = JT.TransformerEncoderLayer(32, 64, 4)
    v = seeded(jmod, jnp.zeros(x.shape), pos=jnp.zeros(pos.shape))
    ref = jax_apply(jmod, v, jnp.asarray(x), jnp.asarray(pos))
    tmod = TT.TransformerEncoderLayer(32, 64, 4)
    tmod.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    jmlp = JT.MLP(48, 4, 3)
    v = seeded(jmlp, jnp.zeros(x.shape))
    tmlp = TT.MLP(32, 48, 4, 3)
    tmlp.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tmlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmlp.apply(v, jnp.asarray(x))), atol=1e-5, rtol=0)


LEVELS = [(6, 5), (3, 3), (2, 1)]


def test_multi_scale_deformable_attn_outside_the_map():
    """The sampler (3 levels, 4 heads of 8, 3 points) at locations in [-0.15, 1.15]: about two fifths of the
    points fall outside the map, where the zero padding reads zeros for the missing neighbours. Within 1e-5 of
    the JAX `multi_scale_deformable_attn`; a point far outside reads nothing at all."""
    rng = np.random.default_rng(4)
    B, len_q, nh, hd, npnt = 2, 7, 4, 8, 3
    value = rng.standard_normal((B, sum(h * w for h, w in LEVELS), nh, hd)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (B, len_q, nh, len(LEVELS), npnt, 2)).astype(np.float32)
    loc[0, 0] = -2.0  # every point of one query far outside
    aw = rng.random((B, len_q, nh, len(LEVELS), npnt)).astype(np.float32)
    assert 0.3 < ((loc < 0) | (loc > 1)).any(-1).mean() < 0.6
    ref = np.asarray(JT.multi_scale_deformable_attn(jnp.asarray(value), LEVELS, jnp.asarray(loc), jnp.asarray(aw)))
    got = TT.multi_scale_deformable_attn(torch.from_numpy(value), LEVELS, torch.from_numpy(loc),
                                         torch.from_numpy(aw)).numpy()
    assert got.shape == ref.shape == (B, len_q, nh * hd)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert np.all(got[0, 0] == 0)


def _decoder_inputs(seed=5):
    """A query set, f32 reference boxes in (0, 1) and a value sequence over LEVELS (c 32)."""
    rng = np.random.default_rng(seed)
    embed = rng.standard_normal((2, 9, 32)).astype(np.float32)
    boxes = rng.uniform(0.05, 0.95, (2, 9, 4)).astype(np.float32)
    feats = rng.standard_normal((2, sum(h * w for h, w in LEVELS), 32)).astype(np.float32)
    return embed, boxes, feats


def test_msdeformattn_and_decoder_layer():
    """MSDeformAttn (d 32, 3 levels, 4 heads, 2 points; the offsets scaled by each box's size * 0.5 / np) and the
    decoder layer's serving branch (self-attention, deformable cross-attention, FFN, three post-norms) against
    the JAX modules within 1e-5."""
    embed, boxes, feats = _decoder_inputs()
    qpos = _x((2, 9, 32), seed=6)
    jattn = JT.MSDeformAttn(32, len(LEVELS), 4, 2)
    args = (jnp.asarray(embed), jnp.asarray(boxes[:, :, None]), jnp.asarray(feats))
    v = seeded(jattn, *args, LEVELS)
    ref = np.asarray(jattn.apply(v, *args, LEVELS))
    tattn = TT.MSDeformAttn(32, len(LEVELS), 4, 2)
    tattn.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tattn(torch.from_numpy(embed), torch.from_numpy(boxes[:, :, None]), torch.from_numpy(feats),
                    LEVELS).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    jlayer = JT.DeformableTransformerDecoderLayer(32, 4, 64, n_levels=len(LEVELS), n_points=2)
    args = (jnp.asarray(embed), jnp.asarray(boxes), jnp.asarray(feats))
    v = seeded(jlayer, *args, LEVELS, query_pos=jnp.asarray(qpos))
    ref = np.asarray(jlayer.apply(v, *args, LEVELS, query_pos=jnp.asarray(qpos)))
    tlayer = TT.DeformableTransformerDecoderLayer(32, 4, 64, len(LEVELS), 2)
    tlayer.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tlayer(torch.from_numpy(embed), torch.from_numpy(boxes), torch.from_numpy(feats), LEVELS,
                     torch.from_numpy(qpos)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# three levels of (h, w): level 0 is wide, so its first and last columns fall outside the anchors' valid band
# (x < 0.01 or > 0.99); level 1 is a constant map
TIE_LEVELS, TIE_CH = [(2, 60), (1, 30), (1, 15)], (16, 24, 32)


def _tie_maps():
    rng = np.random.default_rng(8)
    maps = [rng.standard_normal((2, h, w, c)).astype(np.float32) for (h, w), c in zip(TIE_LEVELS, TIE_CH)]
    maps[1][:] = rng.standard_normal((2, 1, 1, TIE_CH[1])).astype(np.float32)  # every token of level 1 alike
    return maps


def _tie_decoder(nq):
    kw = dict(nc=5, ch=TIE_CH, hd=32, nq=nq, ndp=2, nh=4, ndl=3, d_ffn=64)
    return JT.RTDETRDecoder(**kw), TT.RTDETRDecoder(**kw)


def test_rtdetr_decoder_tie_order_matches_jax():
    """RTDETRDecoder's eval branch (5 classes, hd 32, 3 layers) on maps where two groups of anchors score exactly
    alike: the 4 outside the valid band (zero tokens, +inf anchors: their first boxes saturate at 1) and the 30
    of a constant map. With the top-k cutoff inside each group and with k = A (nq above the anchor count), the
    (B, k, 4 + nc) output equals the JAX one row by row within 1e-4: the port selects the same anchors in the
    same order, ties to the lower index as `jax.lax.top_k` (another anchor's row would differ by ~1e-1).
    Three layers of random weights carry the encoder scores' ~1e-6 into ~1e-5 here. Only the last layer's score head runs; every
    layer's is in the state_dict."""
    maps = _tie_maps()
    jmod, tmod = _tie_decoder(300)
    v = seeded(jmod, [jnp.zeros(m.shape) for m in maps], training=True)
    tmod.load_state_dict(flax_to_state_dict(v), strict=True)
    assert len(tmod.dec_score_head) == 3 and tmod.denoising_class_embed.shape == (5, 32)
    xs = [_nchw(m) for m in maps]
    with torch.no_grad():
        best = tmod.eval().encode(xs)[-1].amax(-1)[0]
    anchors, valid = TT.make_anchors(TIE_LEVELS, "cpu")
    assert int((~valid).sum()) == 4 and torch.isinf(anchors[~valid[:, 0]]).all()
    order = torch.sort(best, descending=True, stable=True)
    groups = {}
    for rank, value in enumerate(order.values.tolist()):
        groups.setdefault(value, []).append(rank)
    invalid_value = best[~valid[:, 0]].unique()
    assert len(invalid_value) == 1  # the four tie exactly
    level1 = best[120:150].unique()
    assert len(level1) == 1  # and so do the 30 of the constant map
    cuts = [groups[invalid_value.item()][0] + 2, groups[level1.item()][0] + 15, len(best) + 10]
    for nq in cuts:
        jmod, tmod = _tie_decoder(nq)
        tmod.load_state_dict(flax_to_state_dict(v), strict=True)
        ref = jax_apply(jmod, v, [jnp.asarray(m) for m in maps], training=False)
        with torch.no_grad():
            got = tmod.eval()(xs).numpy()
        assert got.shape == ref.shape == (2, min(nq, len(best)), 9)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


# -- the graphs -----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(DETR))
def test_yaml_builds_like_jax(name):
    """`YOLO(<name>)` on the meta device: the YAML is the JAX package's byte for byte and resolves by its name; task
    "rtdetr"; the JAX specs and save list; strides (8, 16, 32) with no probe (the JAX probe finds none); the JAX
    graph's parameter count; no dead layer; the conv3x3 sites of a folded forward (rtdetr-l 24: 12 in HGBlocks,
    12 RepConvs; rtdetr-x 30; rtdetr-resnet50 25 and -resnet101 42: 13 and 30 ResNet 3x3s; yolov8n-rtdetr 20:
    its C2f bottlenecks); the frame read by one conv's stem (HGStem's stem1, the ResNet 7x7 or layer 0)."""
    cfg, count, sites = DETR[name]
    assert (PORT_CFG / cfg).read_bytes() == (JAX_CFG / cfg).read_bytes()
    yolo = YOLO(name, device="meta", seed=None)
    tm = yolo.model
    assert Path(yolo.model_yaml["yaml_file"]) == PORT_CFG / cfg
    assert yolo.task == tm.task == "rtdetr" and tm.strides == (8.0, 16.0, 32.0) and not tm.dead
    assert sum(p.numel() for p in tm.parameters()) == count
    specs, save = TC.parse_model(yolo.model_yaml)
    jspecs, jsave = JC.parse_model(yolo.model_yaml)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    assert len(conv3x3_sites(tm)) == sites
    assert len(frame_readers(tm)) == 1


def test_jax_resolver_misses_the_rtdetr_yamls():
    """The port finds `rtdetr-l.yaml` by name (in `cfg/models/rt-detr/`); the JAX facade's resolver searches v10,
    v8 and v9 only (`lpc_yolo_tpu/engine/model.py:37-52`) and raises, so the JAX tests give it the path."""
    import lpc_yolo_tpu.engine.model as jax_model
    from lpc_yolo_tpu_torch.engine.model import _resolve_yaml

    assert _resolve_yaml("rtdetr-l.yaml") == PORT_CFG / "rt-detr" / "rtdetr-l.yaml"
    assert _resolve_yaml("yolov8x-rtdetr.yaml") == PORT_CFG / "v8" / "yolov8-rtdetr.yaml"
    with pytest.raises(FileNotFoundError):
        jax_model._resolve_yaml("rtdetr-l.yaml")


@pytest.mark.parametrize("name", ["rtdetr-l.yaml", "yolov8n-rtdetr.yaml"])
def test_variable_tree_matches_jax_and_round_trips(name):
    """The port's variable tree (`flax_shapes`) equals the JAX graph's `jax.eval_shape` tree at full width, every
    leaf: the decoder's LayerNorms (scale, bias), the attention's 3-D kernels and 2-D biases, the
    `input_proj_<i>_1` BatchNorms (statistics in batch_stats), `denoising_class_embed` (nc, hd) untransposed, all
    six score heads. A seeded tree of the small-decoder graph goes into the port's state_dict and back bit for
    bit."""
    cfg = DETR[name][0]
    yolo = YOLO(name, device="meta", seed=None)
    jm = jax_graph(yolo.model_yaml, yolo.model.strides)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                         jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda t: isinstance(t, tuple))}
    port = flax_shapes(yolo.model)
    for col in ("params", "batch_stats"):
        assert flat(port[col]) == flat(shapes[col])
    head = port["params"][f"model_{len(jm.specs) - 1}"]
    assert head["denoising_class_embed"] == (80, 256) and len([k for k in head if k.startswith("dec_score")]) == 6
    assert head["decoder_layers_0"]["self_attn"]["query"]["kernel"] == (256, 8, 32)
    assert head["decoder_layers_0"]["self_attn"]["out"]["kernel"] == (8, 32, 256)
    tm = build_model(small(cfg), device="cpu")
    variables = random_variables(flax_shapes(tm), seed=2)
    load_flax(tm, variables)
    back = state_dict_to_flax(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)))


@pytest.mark.parametrize("name", ["rtdetr-l.yaml", "yolov8n-rtdetr.yaml"])
def test_small_decoder_forward_matches_jax(name):
    """rtdetr-l (HGStem, HGBlocks, DWConvs, AIFI, RepC3) and yolov8n-rtdetr (the v8 backbone) with the small
    decoder at 64 px, batch 2, f32: the eval forward's (B, 60, 84) boxes and scores within 1e-4 of the JAX graph's
    on the same weights, query by query (84 anchors, 60 kept: the selection agrees)."""
    d = small(DETR[name][0])
    tm = build_model(d, device="cpu")
    variables = random_variables(flax_shapes(tm), seed=1)
    load_flax(tm, variables)
    x = np.random.default_rng(3).random((2, S, S, 3), dtype=np.float32)
    ref = jax_apply(jax_graph(d, tm.strides), variables, jnp.asarray(x), training=False)["pred"]
    with torch.no_grad():
        got = tm(_nchw(x))["pred"].numpy()
    assert got.shape == ref.shape == (2, 60, 84)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(DETR))
def test_folded_serving_copy_matches_unfolded(name, monkeypatch):
    """`serving_model` of each YAML with the small decoder (BN folded into every ConvBN, each RepConv's branches
    into one conv, /255 into the conv that reads the frame: HGStem's stem1, the ResNet stem's 7x7, yolov8's layer
    0), fed the 0..255 frame, against the unfolded model fed the frame / 255: `pred` within 1e-4, query by query.
    The serving forward calls conv3x3 once at each of its sites and F.conv2d at no 3x3 stride-1 groups-1 conv;
    `predict` gives (B, 60, 6) rows [x1, y1, x2, y2, score, label] with no NMS."""
    d = small(DETR[name][0])
    tm = build_model(d, device="cpu")
    load_flax(tm, random_variables(flax_shapes(tm), seed=4))
    frames = np.random.default_rng(5).integers(0, 256, (2, S, S, 3)).astype(np.float32)
    serving = serving_model(tm, torch.device("cpu"), torch.float32)
    sites = conv3x3_sites(serving)
    assert len(sites) == DETR[name][2] and all(m.folded is not None for m in sites)
    conv2d, conv3x3, calls, inside = TM.F.conv2d, TM.conv3x3, [], []

    def spy(x, w, *a, **k):  # F.conv2d outside conv3x3 (whose plain version is an F.conv2d on the CPU)
        stride, groups = (a[1] if len(a) > 1 else k.get("stride", 1)), (a[4] if len(a) > 4 else k.get("groups", 1))
        assert inside or not (tuple(w.shape[2:]) == (3, 3) and stride in (1, (1, 1)) and groups == 1), \
            "a 3x3 s1 g1 conv through F.conv2d"
        return conv2d(x, w, *a, **k)

    def counting(*a):
        calls.append(1)
        inside.append(1)
        try:
            return conv3x3(*a)
        finally:
            inside.pop()

    monkeypatch.setattr(TM.F, "conv2d", spy)
    monkeypatch.setattr(TM, "conv3x3", counting)
    with torch.no_grad():
        got = serving(_nchw(frames))["pred"].numpy()
        rows = serving.predict(_nchw(frames))
    monkeypatch.undo()
    assert len(calls) == 2 * len(sites)
    with torch.no_grad():
        ref = tm(_nchw(frames / np.float32(255)))["pred"].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert rows.shape == (2, 60, 6)
    np.testing.assert_allclose(rows[..., 4].numpy(), ref[..., 4:].max(-1), atol=1e-4)


def _jax_facade(monkeypatch, cfg: Path, variables):
    """The JAX facade on `cfg` (given by path: its resolver has no rt-detr folder) with `variables`, not its init."""
    import lpc_yolo_tpu.engine.model as jax_model

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: variables)
    yolo = jax_model.YOLO(str(cfg))
    assert yolo.task == "rtdetr"
    return yolo


def calm_boxes(variables, head: str):
    """The variables with the last layer of every box MLP (`enc_bbox_head`, `dec_bbox_head_<i>`) scaled by 0.05
    and its bias zeroed: the seeded deltas would squash most boxes to under a pixel, the calmed ones keep each
    query's box near its anchor (3 to 13 px a side at 64 px)."""
    params = jax.tree.map(np.array, variables["params"])
    for name, mlp in params[head].items():
        if name == "enc_bbox_head" or name.startswith("dec_bbox_head_"):
            mlp["layers_2"]["kernel"] *= np.float32(0.05)
            mlp["layers_2"]["bias"][:] = 0
    return {**variables, "params": params}


@pytest.fixture(scope="module")
def small_v8(tmp_path_factory):
    """yolov8n-rtdetr with the small decoder, written to a YAML, and its seeded variables (`calm_boxes`)."""
    cfg = tmp_path_factory.mktemp("rtdetr") / "yolov8n-rtdetr-small.yaml"
    cfg.write_text(yaml.safe_dump(small("v8/yolov8-rtdetr.yaml")))  # scale n, from the name as in JAX
    model = YOLO(cfg, device="meta", seed=None).model
    return cfg, calm_boxes(random_variables(flax_shapes(model), seed=6), f"model_{len(model.specs) - 1}")


def test_predict_matches_jax(small_v8, monkeypatch):
    """`YOLO(<yolov8n-rtdetr, small decoder>).predict` of two frames (48 x 64 and 64 x 40, batch 2, imgsz 64, conf
    0.25) against the JAX facade's `predict` on the same weights: as many rows a frame, each matched
    tie-tolerantly (box 1e-3 px, score 1e-5). The rows are every query above conf: no NMS."""
    cfg, variables = small_v8
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)]
    ref = _jax_facade(monkeypatch, cfg, variables).predict(frames, imgsz=S, batch=2, conf=0.25)
    yolo = YOLO(cfg, device="cpu", seed=None).load_flax(variables)
    got = yolo.predict(frames, imgsz=S, batch=2, conf=0.25)
    for a, b in zip(got, ref):
        assert 5 <= len(a) == len(b) <= 60
        assert_detections_close(a.boxes.data, np.asarray(b.boxes.data), atol_box=1e-3, atol_score=1e-5)


def write_dataset(root: Path, jyolo) -> Path:
    """Six noise PNGs no larger than imgsz (the validator's scaleup=False only pads them), one without a label
    file; the labels are the JAX model's own strongest rows (its random weights favour one class), at least 2 px
    a side, inside the frame and not overlapping another label, up to 3 a frame."""
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i, (h0, w0) in enumerate(((48, 40), (64, 64), (50, 64), (32, 56), (64, 30), (40, 40))):
        img = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "images" / "val" / f"{i}.png"), img)
        if i == 4:
            continue
        lb, gain, (pw, ph) = letterbox_image(img, (S, S), scaleup=False)
        assert gain == 1.0
        det = np.asarray(jyolo.predict(lb, imgsz=S, conf=0.0)[0].boxes.data)  # lb is the frame: pad 0
        keep = []
        for row in det[np.argsort(-det[:, 4], kind="stable")]:
            b, c = row[:4].astype(np.float64), int(row[5])
            if min(b[2] - b[0], b[3] - b[1]) < 2 or min(b[0] - pw, b[1] - ph, pw + w0 - b[2], ph + h0 - b[3]) < 0:
                continue
            if keep and box_iou_np(np.stack([k[0] for k in keep]), b[None]).max() > 0.4:
                continue
            keep.append((b, c))
            if len(keep) == 3:
                break
        lines = []
        for b, c in keep:
            x1, y1, x2, y2 = b - [pw, ph, pw, ph]
            lines.append(f"{c} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} {(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(lines) + "\n")
    (root / "data.yaml").write_text(yaml.safe_dump({"path": str(root), "val": "images/val", "nc": 80}))
    return root / "data.yaml"


def test_val_matches_jax(small_v8, tmp_path, monkeypatch):
    """`YOLO(<yolov8n-rtdetr, small decoder>).val(data=...)` (conf 0.001, imgsz 64, batch 4: every query a row, no
    NMS) against the JAX facade's `val` on the same weights and data: `assert_val_results_agree` (the mAP keys and
    fitness to the last digit, precision and recall within 1e-9 relative)."""
    cfg, variables = small_v8
    jyolo = _jax_facade(monkeypatch, cfg, variables)
    data = write_dataset(tmp_path / "data", jyolo)
    ref = jyolo.val(data=str(data), imgsz=S, batch=4, workers=2)
    got = YOLO(cfg, device="cpu", seed=None).load_flax(variables).val(data=str(data), imgsz=S, batch=4, workers=2)
    assert ref["metrics/mAP50(B)"] > 0.1  # the labels are the JAX model's own rows
    assert_val_results_agree(got, ref)


def test_training_is_refused(small_v8):
    """An RT-DETR model trains through the DETR loss only (`tests/test_torch_rtdetr_train.py` holds it): a train
    step with another head's loss is refused, and the graph in train mode gives the DETR loss's dict (every
    decoder layer's boxes and scores, the encoder's, no denoising group without ground truths), not serving
    rows."""
    cfg, variables = small_v8
    yolo = YOLO(cfg, device="cpu", seed=None)
    for kind in ("v8", "v10"):
        with pytest.raises(ValueError, match="does not train this model's head"):
            make_train_step(yolo.model, OptConfig(), loss_kind=kind)
    out = yolo.model.train()(torch.zeros(1, 3, S, S))
    assert sorted(out) == ["dec_bboxes", "dec_scores", "dn_group", "dn_split", "enc_bboxes", "enc_scores"]
    assert out["dec_scores"].shape == (2, 1, 60, 80) and (out["dn_split"], out["dn_group"]) == (0, 0)
