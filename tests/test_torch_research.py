"""The research zoo's 21 attention modules of the port (`lpc_yolo_tpu_torch/nn/research.py`) against the JAX
package's (`lpc_yolo_tpu/nn/research.py:49-734`), on the CPU in f32.

Each module runs at 32 channels on a (2, 6, 10) map (not square, so a swapped H and W shows) with the weights of
`random_variables` of the JAX shape tree, through the bridge; its bare parameters (ECA's kernel, the gates of
ShuffleAttention and SpatialGroupEnhance, CrissCrossAttention's `gamma`) are drawn from U(+-1), so no gate sits at
its init's constant. Outputs are held at atol 1e-5, in eval mode and in train mode, and in train mode the
BatchNorm statistics too. Gradients (of the output against a fixed random cotangent, in train mode) are held to the
port's own f64 run, as the training tests hold them: the port's f32 ones within 1e-4 and the JAX package's within
1e-3 of each leaf's largest value. ShuffleAttention is held to SA-Net's published forward, written out below, and
a test shows that the JAX module differs from it; another shows that the JAX `fuse_conv_bn` drops a conv's bias,
which the port folds. The parse rules are held to JAX `parse_model` on LPC-YOLO with each module at layer 21, the
shape trees of narrow such graphs to `jax.eval_shape`'s, every other zoo name is still refused, and each
variant's graph round-trips through a reference-layout `.pt`.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.nn import research as JR
from lpc_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse_conv_bn

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.nn import build_model, parse_model
from lpc_yolo_tpu_torch.nn import research as TR
from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites, fuse_conv_bn
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, random_variables, state_dict_to_flax

C = 32
NAMES = sorted(TR.ATTENTION)
WITH_BN = {"CoordAtt", "NAMAttention", "GAMAttention", "SKAttention", "ParNetAttention", "CoTAttention",
           "TripletAttention"}
WITH_CBA = sorted(WITH_BN - {"CoordAtt", "NAMAttention"})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def compiled_args(m: str, c: int = C) -> tuple:
    """The module's args as the parse rules give them at a c-channel input and no YAML args."""
    if m in TR.WIDTH_SCALED:
        return (c, c)
    return () if m in TR.PASSTHROUGH else (c,)


def x_nhwc(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((2, 6, 10, C)).astype(np.float32)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def pair(m: str, seed: int = 0):
    """The JAX module, the port's with the same seeded weights, and the JAX variables."""
    a = compiled_args(m)
    jm = JR.build_research_module(m, a, jnp.float32, "m")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x_nhwc()), training=True))
    variables = random_variables(shapes, seed)
    tm = TR.build_research_module(m, a)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jm, tm, variables


def sa_net_forward(tm, x: torch.Tensor, G: int = 8) -> torch.Tensor:
    """SA-Net's shuffle attention as published (Zhang & Yang, 2021, NCHW), on the port module's parameters."""
    b, c, h, w = x.shape
    cw, cb, sw, sb = (getattr(tm, n).reshape(1, -1, 1, 1) for n in ("cweight", "cbias", "sweight", "sbias"))
    x = x.view(b * G, -1, h, w)
    x_0, x_1 = x.chunk(2, dim=1)
    xn = x_0 * torch.sigmoid(cw * F.adaptive_avg_pool2d(x_0, 1) + cb)
    xs = F.group_norm(x_1, x_1.shape[1], tm.gn.weight, tm.gn.bias, eps=1e-6)
    xs = x_1 * torch.sigmoid(sw * xs + sb)
    out = torch.cat([xn, xs], dim=1).contiguous().view(b, -1, h, w)
    return out.reshape(b, 2, -1, h, w).permute(0, 2, 1, 3, 4).reshape(b, -1, h, w)


def reference(m, jm, tm, variables, x, training: bool):
    """The module's reference output (NHWC) and, in train mode, the JAX run's new batch_stats."""
    if m == "ShuffleAttention":
        with torch.no_grad():
            return nhwc(sa_net_forward(tm, nchw(x))), {}
    if training:
        y, new = jm.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
        return np.asarray(y), jax.tree.map(np.asarray, dict(new))
    return np.asarray(jm.apply(variables, jnp.asarray(x), training=False)), {}


@pytest.mark.parametrize("m", NAMES)
def test_module_matches_jax_in_eval_mode(m):
    jm, tm, variables = pair(m)
    x = x_nhwc(1)
    ref, _ = reference(m, jm, tm, variables, x, training=False)
    with torch.no_grad():
        got = nhwc(tm.eval()(nchw(x)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


ARG_CASES = [("MHSA", (C, 10, 6, 4, True)), ("EffectiveSEModule", (C, True)), ("GatherExcite", (C, 0, True)),
             ("TripletAttention", (True,)), ("SKAttention", (C, [1, 3], 8, 2)), ("SE", (C, 4)),
             ("GAMAttention", (C, C, False)), ("CoordAtt", (C, C, 8)), ("SpatialGroupEnhance", (4,)),
             ("ECA", (C, 3, 2)), ("GlobalContext", (C, 0.25)), ("CoTAttention", (C, 3))]


@pytest.mark.parametrize("m,args", ARG_CASES, ids=[f"{m}-{i}" for i, (m, _) in enumerate(ARG_CASES)])
def test_module_args_match_jax(m, args):
    """The modules' other YAML arguments (MHSA's position embedding over a 10 x 6 table, the max-pooled squeeze,
    Triplet's `no_spatial`, SK's kernels, reduction and groups, GAM without groups, ...) in eval mode, atol 1e-5."""
    jm = JR.build_research_module(m, args, jnp.float32, "m")
    x = x_nhwc(11)
    variables = random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                                training=True)), 3)
    tm = TR.build_research_module(m, args)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), training=False))
    with torch.no_grad():
        got = nhwc(tm.eval()(nchw(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", NAMES)
def test_module_matches_jax_in_train_mode(m):
    """Outputs on batch statistics, and the new running statistics (momentum 0.03, the biased variance)."""
    jm, tm, variables = pair(m)
    x = x_nhwc(2)
    ref, new = reference(m, jm, tm, variables, x, training=True)
    with torch.no_grad():
        got = nhwc(tm.train()(nchw(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    stats = state_dict_to_flax(tm.state_dict())["batch_stats"]
    assert bool(stats) == (m in WITH_BN)
    if m == "ShuffleAttention":
        return
    ref_stats = dict(jax.tree_util.tree_leaves_with_path(new.get("batch_stats", {})))
    got_stats = dict(jax.tree_util.tree_leaves_with_path(stats))
    assert ref_stats.keys() == got_stats.keys()
    for k, v in ref_stats.items():
        np.testing.assert_allclose(got_stats[k], v, rtol=0, atol=1e-5, err_msg=jax.tree_util.keystr(k))


def port_grads(tm, x: torch.Tensor, r: torch.Tensor, dtype: torch.dtype):
    m = copy.deepcopy(tm).to(dtype).train()
    x = x.to(dtype).requires_grad_(True)
    (m(x) * r.to(dtype)).sum().backward()
    out = {k: p.grad.detach().double() for k, p in m.named_parameters()}
    out["input"] = x.grad.detach().double()
    return out


@pytest.mark.parametrize("m", NAMES)
def test_gradients_match_the_f64_run(m):
    """Train-mode gradients of <module(x), r> for every parameter and the input: the port's f32 run within 1e-4
    and the JAX package's within 1e-3 of each leaf's largest value in the port's f64 run, or of a hundredth of the
    largest over all leaves where a leaf's gradient is 0 by structure (a bias before a softmax over the positions
    or before a BatchNorm: its f64 gradient is ~1e-17, its f32 one rounding noise). ShuffleAttention's JAX
    gradients are of another function and are not compared."""
    jm, tm, variables = pair(m)
    x, r = x_nhwc(3), np.random.default_rng(4).standard_normal((2, 6, 10, C)).astype(np.float32)
    g64 = port_grads(tm, nchw(x), nchw(r), torch.float64)
    g32 = port_grads(tm, nchw(x), nchw(r), torch.float32)
    assert g64.keys() == g32.keys()
    top = max(g.abs().max().item() for g in g64.values())
    scale = {k: max(g.abs().max().item(), 1e-2 * top) for k, g in g64.items()}
    for k, ref in g64.items():
        np.testing.assert_allclose(g32[k].numpy(), ref.numpy(), rtol=0, atol=1e-4 * scale[k], err_msg=k)
    if m == "ShuffleAttention":
        return
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params, xj):
        y, _ = jm.apply({"params": params, **rest}, xj, training=True, mutable=["batch_stats"])
        return (y * jnp.asarray(r)).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables.get("params", {}), jnp.asarray(x))
    gj = {k: v.double() for k, v in flax_to_state_dict({"params": jax.tree.map(np.asarray, gp)}).items()}
    gj["input"] = torch.from_numpy(np.asarray(gx).transpose(0, 3, 1, 2).copy()).double()
    assert gj.keys() == g64.keys()
    for k, ref in g64.items():
        np.testing.assert_allclose(gj[k].numpy(), ref.numpy(), rtol=0, atol=1e-3 * scale[k], err_msg=k)


@pytest.mark.parametrize("m", WITH_CBA)
def test_fold_equals_the_unfolded_forward(m):
    """`fuse_conv_bn` folds every CBA of the module (ParNetAttention's conv biases included) and the folded
    forward, its 3x3 s1 g1 CBAs through the conv3x3 wrapper, equals the unfolded one."""
    _, tm, _ = pair(m)
    x = nchw(x_nhwc(5))
    with torch.no_grad():
        ref = tm.eval()(x)
        folded = fuse_conv_bn(copy.deepcopy(tm))
        got = folded(x)
    assert all(c.folded is not None for c in folded.modules() if isinstance(c, TR.CBA))
    sites = {"SKAttention": 1, "ParNetAttention": 1}.get(m, 0)
    assert len(conv3x3_sites(tm)) == sites
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_jax_shuffle_attention_is_not_sa_net():
    """The JAX ShuffleAttention (`research.py:466`) reshapes (B, H, W, C) to (B * G, H, W, C / G): blocks of rows,
    not SA-Net's channel groups. On the same weights it parts from the published forward, which the port runs."""
    jm, tm, variables = pair("ShuffleAttention")
    x = x_nhwc(6)
    jax_out = np.asarray(jm.apply(variables, jnp.asarray(x), training=False))
    with torch.no_grad():
        published = nhwc(sa_net_forward(tm, nchw(x)))
        port = nhwc(tm.eval()(nchw(x)))
    np.testing.assert_allclose(port, published, rtol=0, atol=1e-6)
    assert np.abs(jax_out - published).max() > 0.1


def test_jax_fuse_drops_a_conv_bias():
    """The JAX `fuse_conv_bn` (`nn/fuse.py:39`) writes `{"kernel": ...}` for a CBA's conv, so ParNetAttention's
    conv biases are lost and applying the fused variables fails; the port's fold keeps them in the bias."""
    jm, tm, variables = pair("ParNetAttention")
    fused = jax_fuse_conv_bn(variables)
    for cba in ("conv1x1", "conv3x3"):
        assert "bias" in variables["params"][cba]["conv"] and "bias" not in fused["params"][cba]["conv"]
    with pytest.raises(Exception, match="bias"):
        jm.apply(fused, jnp.asarray(x_nhwc(7)), training=False)
    with torch.no_grad():
        x = nchw(x_nhwc(7))
        ref = tm.eval()(x)
        folded = copy.deepcopy(tm)
        for cba in (folded.conv1x1, folded.conv3x3):  # the facade's fuse(): BN left as identity + folded bias
            f = cba.bn.weight / torch.sqrt(cba.bn.running_var + cba.bn.eps)
            cba.conv.weight.mul_(f[:, None, None, None])
            cba.bn.bias.copy_(cba.bn.bias - (cba.bn.running_mean - cba.conv.bias) * f)
            cba.conv.bias.zero_()
            cba.bn.weight.fill_(1.0)
            cba.bn.running_mean.zero_()
            cba.bn.running_var.fill_(1.0 - cba.bn.eps)
        np.testing.assert_allclose(folded(x).numpy(), ref.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", NAMES)
def test_parse_matches_jax_at_layer_21(m):
    """LPC-YOLO at its s scale with `CBAM [7]` replaced: the same LayerSpecs as JAX `parse_model`, the module at
    the 64-channel site with the args the JAX rules give (c1 prepended, c1 only, passed through, or width-scaled
    from 128)."""
    d = TR.lpc_attention_cfg(m)
    specs, save = parse_model(dict(d))
    jd = dict(d)
    jd["scale"] = "s"
    jspecs, jsave = JC.parse_model(jd)
    assert [(s.i, s.f, s.n, s.module, s.args, s.c2) for s in specs] == \
        [(s.i, s.f, s.n, s.module, s.args, s.c2) for s in jspecs] and save == jsave
    layer = specs[TR.LPC_ATTENTION_LAYER]
    assert layer.module == m and layer.c2 == 64 and layer.args == compiled_args(m, 64)


def narrow_cfg(m: str) -> dict:
    d = TR.lpc_attention_cfg(m)
    d.update(nc=4, scales={"t": [0.33, 0.25, 512]}, scale="t")
    return d


@pytest.fixture(scope="module")
def narrow_cbam_tree():
    """JAX `eval_shape`'s tree of the narrow LPC-YOLO as published (CBAM at layer 21)."""
    jm = jax_build(JC.yaml_model_load(TR.LPC_YAML) | {"nc": 4, "scales": {"t": [0.33, 0.25, 512]}, "scale": "t"})
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True))


@pytest.mark.parametrize("m", NAMES)
def test_narrow_graph_shape_tree_matches_jax(m, narrow_cbam_tree):
    """A narrow LPC-YOLO (width 0.25, 32 channels at layer 21) with the module: the port's `flax_shapes` is the
    JAX tree leaf for leaf, that is the published graph's with `model_21` the JAX module's own `eval_shape` tree
    at the args JAX `parse_model` gives it (each whole graph's trace takes ~5 s; the slice tests build a few)."""
    jspecs, _ = JC.parse_model(narrow_cfg(m))
    spec = jspecs[TR.LPC_ATTENTION_LAYER]
    jmod = JR.build_research_module(m, spec.args, jnp.float32, "model_21")
    sub = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 32)), training=True))
    tree = {col: dict(narrow_cbam_tree.get(col, {})) for col in ("params", "batch_stats")}
    for col in tree:
        tree[col].pop("model_21", None)
        if sub.get(col):
            tree[col]["model_21"] = sub[col]
    tm = build_model(narrow_cfg(m), device="meta")
    assert type(tm.model[TR.LPC_ATTENTION_LAYER]).__name__ == m
    flat = lambda t: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t, is_leaf=lambda q: isinstance(q, tuple))}
    port = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        assert flat(port[col]) == flat(tree[col]), col


# each backbone-family name's YAML args at a 16-channel input (width 1), and its repeats
BACKBONE_ARGS = {
    "G_bneck": [16, 16, 3, 1], "SGBlock": [16, 1, 6], "DepthSepConv": [32, 3, 1, True], "CBRM": [16],
    "Shuffle_Block": [16, 1], "stem": [16], "MBConvBlock": [16, 3, 1, 6, 0.0, True], "Conv_BN_HSwish": [16, 1],
    "MobileNetV3_InvertedResidual": [16, 32, 3, 1, 1, 1], "mn_conv": [16, 3, 1], "InvertedBottleneck": [16, 3, 32],
    "MobileNetV3_BLOCK": [16, 3, 32], "PatchEmbed": [32, 4], "PatchMerging": [32], "SwinStage": [16, 2, 2, 7],
    "VanillaBlock": [32, 3, 2], "ConvNeXt_Stem": [32, 4, 4], "ConvNeXt_Downsample": [32, 2, 2], "ConvNeXt_Block": [16],
    "StarBlock": [3], "BasicStage": [2], "PatchEmbed_FasterNet": [32, 4, 4], "PatchMerging_FasterNet": [32, 2, 2]}


@pytest.mark.parametrize("m", sorted(JR.ALL_RESEARCH - TR.ATTENTION - TR.NECK))
def test_other_zoo_names_are_refused(m):
    """The zoo's other names, its 23 backbone-family modules, were refused until they were ported: each now builds
    through the port's compiler (`tests/test_torch_backbone.py` holds their forwards), its LayerSpecs JAX
    `parse_model`'s (ConvNeXt_Block's and StarBlock's two repeats folded into the module) and the layer's flax-shape
    tree the JAX module's `eval_shape` tree. No research-zoo name is refused; a name no package defines is
    (`tests/test_torch_train.py::test_entry_points_refuse_what_is_not_ported`)."""
    assert m in TR.BACKBONE and m in TR.PORTED
    n = 2 if m in ("ConvNeXt_Block", "StarBlock") else 1
    d = {"nc": 4, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, n, m, BACKBONE_ARGS[m]]], "head": []}
    specs, _ = parse_model(dict(d))
    jspecs, _ = JC.parse_model(dict(d))
    assert [(s.f, s.n, s.module, s.args, s.c2) for s in specs] == [(s.f, s.n, s.module, s.args, s.c2) for s in jspecs]
    assert specs[1].n == 1
    tm = build_model(d, device="meta")
    assert type(tm.model[1]).__name__ == m
    jmod = JR.build_research_module(m, jspecs[1].args, jnp.float32, "model_1")
    sub = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16)), training=True))
    flat = lambda t: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t, is_leaf=lambda q: isinstance(q, tuple))}
    port = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        assert flat(port[col].get("model_1", {})) == flat(dict(sub.get(col, {}))), col
    assert TR.PORTED == JR.ALL_RESEARCH


@pytest.mark.parametrize("m", NAMES)
def test_port_loads_the_pt_of_every_variant(tmp_path, m):
    """Every variant round-trips through a reference-layout `.pt` (`YOLO.save_pt`: the fp16 module under `model`,
    `ema` None) in the port, which the JAX `port_state_dict` cannot do for the bare leaves (ECA's `conv`): the
    narrow graph's weights come back as written, rounded to fp16, and it predicts."""
    path = tmp_path / f"yolov10-{m}.yaml"
    path.write_text(yaml.safe_dump(narrow_cfg(m)))
    yolo = YOLO(path, device="cpu", seed=0)
    pt = yolo.save_pt(tmp_path / f"{path.stem}.pt")
    loaded = YOLO(pt, device="cpu")
    assert type(loaded.model.model[TR.LPC_ATTENTION_LAYER]).__name__ == m and loaded.task == "v10"
    got, ref = loaded.model.state_dict(), yolo.model.state_dict()
    assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k].half().float()) for k in got)
    frame = np.random.default_rng(10).integers(0, 256, (64, 48, 3), dtype=np.uint8)
    results = loaded.predict([frame], imgsz=64, conf=0.0, device="cpu")
    assert len(results[0]) > 0 and np.isfinite(results[0].boxes.data).all()
