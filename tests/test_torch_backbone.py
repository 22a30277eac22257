"""The research zoo's backbone families in the port (`lpc_yolo_tpu_torch/nn/research.py`) against the JAX package's
(`lpc_yolo_tpu/nn/research.py:163`, `:777-1412`), on the CPU in f32.

Each of the 23 YAML-level modules, with SeBlock, WindowAttention and SwinTransformerBlock, runs at 16 channels on a
(2, 12, 20) map (not square, so a swapped H and W shows; Swin's patch embedding on 14 x 22, which it pads) with the
weights of `random_variables` of the JAX shape tree, through the bridge. Outputs are held within 1e-4 in eval mode
and in train mode, and in train mode the BatchNorm statistics too; the flax-shape trees are identical. Against JAX
two port functions are swapped for the JAX package's in the test only (`jax_semantics`): StarBlock's forward for
the JAX one residual around its n blocks, and SGBlock's ReLU6 for the JAX ConvBN's "relu6", which applies none. The
port's own StarBlock and SGBlock are then held to the published blocks, and three tests show the JAX faults. The
parse rules are held to JAX `parse_model` on the twelve LPC-YOLO variants of `lpc_backbone_cfg`, their shape trees
to `jax.eval_shape`'s (`tests/test_torch_backbone_slice.py` serves each one and round-trips it through a `.pt`).
"""

import copy

import numpy as np
import pytest
import torch
import yaml

import flax
import jax
import jax.numpy as jnp
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.nn import modules as JM
from lpc_yolo_tpu.nn import research as JR

from lpc_yolo_tpu_torch.nn import build_model, parse_model
from lpc_yolo_tpu_torch.nn import research as TR
from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites, folded_convs, fold_preprocess, fuse_conv_bn
from lpc_yolo_tpu_torch.utils.flax_bridge import (flax_shapes, flax_to_state_dict, random_variables,
                                                  state_dict_to_flax)

C = 16
HW = (12, 20)
# the modules' args as the parse rules give them at a C-channel input (the internal three as their JAX fields), and
# each one's input: "map" an NCHW / NHWC map of HW, "embed" one of 14 x 22, "nhwc" an NHWC map for both packages,
# "tokens" (B * nW, ws², C) windows
CASES = {
    "SeBlock": ((C,), "map"), "WindowAttention": ((C, 3, 2), "tokens"),
    "SwinTransformerBlock": ((C, 2, 3, 1), "nhwc"),
    "G_bneck": ((C, C, C, 3, 1), "map"), "SGBlock": ((C, C, 1, 6), "map"), "DepthSepConv": ((C, 32, 3, 1, True), "map"),
    "CBRM": ((C, C), "map"), "Shuffle_Block": ((C, C, 1), "map"), "stem": ((C, C), "map"),
    "MBConvBlock": ((C, C, 3, 1, 6, 0.0, True), "map"), "Conv_BN_HSwish": ((C, C, 1), "map"),
    "MobileNetV3_InvertedResidual": ((C, C, 48, 3, 1, True, True), "map"), "mn_conv": ((C, C, 3, 1, "HS"), "map"),
    "InvertedBottleneck": ((C, C, 3, 32, "None", "RE", 1), "map"),
    "MobileNetV3_BLOCK": ((C, C, 3, 32, "None", "HS", 1), "map"), "PatchEmbed": ((C, 32, 4), "embed"),
    "PatchMerging": ((C, 32), "map"), "SwinStage": ((C, C, 2, 2, 3), "map"), "VanillaBlock": ((C, 32, 3, 2), "map"),
    "ConvNeXt_Stem": ((C, 32, 4, 4), "map"), "ConvNeXt_Downsample": ((C, 32, 2, 2), "map"),
    "ConvNeXt_Block": ((C, C, 2), "map"), "StarBlock": ((C, 3, 2), "map"), "BasicStage": ((C, 2), "map"),
    "PatchEmbed_FasterNet": ((C, 32, 4, 4), "map"), "PatchMerging_FasterNet": ((C, 32, 2, 2), "map"),
}
NAMES = sorted(CASES)
INTERNAL = {"SeBlock", "WindowAttention", "SwinTransformerBlock"}
NO_BN = {"SeBlock", "WindowAttention", "SwinTransformerBlock", "SwinStage", "PatchEmbed", "PatchMerging",
         "ConvNeXt_Stem", "ConvNeXt_Downsample", "ConvNeXt_Block"}
# conv3x3 sites at these args: Conv_BN_HSwish's and mn_conv's 3x3 stride-1 CBA (hard-swish after the kernel), each of
# BasicStage's two partial convs
SITES = {"Conv_BN_HSwish": 1, "mn_conv": 1, "BasicStage": 2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_star_forward(self, x: torch.Tensor) -> torch.Tensor:
    """The JAX StarBlock (`research.py:1339-1350`) on the port module's weights: one residual around all n blocks."""
    inp = x
    for i in range(self.n):
        x = self.star(i, x)
    return inp + x


@pytest.fixture
def jax_semantics(monkeypatch):
    """The two JAX-side behaviours swapped into the port, for the comparisons with the JAX package: StarBlock's one
    residual, and SGBlock's "relu6" ConvBNs, which the JAX `apply_act` runs as no activation."""
    monkeypatch.setattr(TR.StarBlock, "forward", jax_star_forward)
    monkeypatch.setattr(TR, "SANDGLASS_ACT", "none")


def make_input(kind: str, c: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = {"map": (2, *HW, c), "nhwc": (2, 7, 10, c), "embed": (2, 14, 22, c), "tokens": (8, 9, c)}[kind]
    return rng.standard_normal(shape).astype(np.float32)


def to_port(x: np.ndarray, kind: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.permute(0, 3, 1, 2).contiguous() if kind in ("map", "embed") else t


def from_port(t: torch.Tensor, kind: str) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if kind in ("map", "embed") else t).numpy()


def jax_module(m: str, a: tuple):
    if m in INTERNAL:
        return getattr(JR, m)(*a, dtype=jnp.float32, name="m")
    return JR.build_research_module(m, a, jnp.float32, "m")


def port_module(m: str, a: tuple):
    return getattr(TR, m)(*a) if m in INTERNAL else TR.build_research_module(m, a)


def swin_mask(m: str, x: np.ndarray):
    """WindowAttention's mask: the shifted windows' of a 6 x 6 map in 3 x 3 windows (four windows, of 8 tokens a
    window batch of 2)."""
    return JR._swin_attn_mask(6, 6, 3, 1) if m == "WindowAttention" else None


def pair(m: str, args: tuple = None, seed: int = 0):
    """The JAX module, the port's with the same seeded weights, the JAX variables, the args and the input kind."""
    a, kind = CASES[m] if args is None else (args, CASES[m][1])
    jm = jax_module(m, a)
    x = make_input(kind, a[0], 0)
    extra = (jnp.asarray(swin_mask(m, x)),) if m == "WindowAttention" else ()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), *extra, training=True))
    variables = random_variables(shapes, seed)
    tm = port_module(m, a)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jm, tm, variables, a, kind


def jax_run(m, jm, variables, x, training: bool):
    extra = (jnp.asarray(swin_mask(m, x)),) if m == "WindowAttention" else ()
    if training:
        y, new = jm.apply(variables, jnp.asarray(x), *extra, training=True, mutable=["batch_stats"])
        return np.asarray(y), jax.tree.map(np.asarray, dict(new))
    return np.asarray(jm.apply(variables, jnp.asarray(x), *extra, training=False)), {}


def port_run(m, tm, x, kind):
    xt = to_port(x, kind)
    with torch.no_grad():
        if m == "WindowAttention":
            return from_port(tm(xt, torch.from_numpy(swin_mask(m, x))), kind)
        return from_port(tm(xt), kind)


@pytest.mark.parametrize("m", NAMES)
def test_module_matches_jax(m, jax_semantics):
    """Eval mode on the running statistics and train mode on the batch's (with the new running statistics, momentum
    0.03, the biased variance) within 1e-4, and the port's flax-shape tree is the JAX `eval_shape` tree."""
    jm, tm, variables, a, kind = pair(m)
    x = make_input(kind, a[0], 1)
    ref, _ = jax_run(m, jm, variables, x, training=False)
    got = port_run(m, tm.eval(), x, kind)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    ref, new = jax_run(m, jm, variables, x, training=True)
    got = port_run(m, tm.train(), x, kind)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()))
    stats = state_dict_to_flax(tm.state_dict())["batch_stats"]
    assert bool(stats) == (m not in NO_BN)
    ref_stats = dict(jax.tree_util.tree_leaves_with_path(new.get("batch_stats", {})))
    got_stats = dict(jax.tree_util.tree_leaves_with_path(stats))
    assert ref_stats.keys() == got_stats.keys()
    for k, v in ref_stats.items():
        np.testing.assert_allclose(got_stats[k], v, rtol=0, atol=1e-5, err_msg=jax.tree_util.keystr(k))
    shape = lambda t: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                       jax.tree_util.tree_leaves_with_path(t, is_leaf=lambda q: isinstance(q, tuple))}
    port = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        assert shape(port[col]) == shape(variables.get(col, {})), col


ARG_CASES = [
    ("G_bneck", (C, 24, 32, 3, 2, True)), ("G_bneck", (C, 24, C, 5, 1)),
    ("SGBlock", (C, 32, 2, 2)), ("SGBlock", (C, 24, 1, 6)), ("SGBlock", (C, 32, 2, 6)), ("SGBlock", (C, C, 1, 6, True)),
    ("DepthSepConv", (C, C, 5, 2)), ("Shuffle_Block", (C, 32, 2)),
    ("CBRM", (C, 32)), ("MBConvBlock", (C, 24, 5, 2, 1)), ("MBConvBlock", (C, C, 3, 1, 1)),
    ("Conv_BN_HSwish", (C, 32, 2)), ("MobileNetV3_InvertedResidual", (C, 24, C, 5, 2, True, False)),
    ("MobileNetV3_InvertedResidual", (C, C, 32, 3, 1, False, False)),
    ("mn_conv", (C, 24, 2, 2, "RE")), ("mn_conv", (C, C, 3, 1, "GE")), ("mn_conv", (C, C, 1, 1, "SI")),
    ("mn_conv", (C, C, 3, 2, "EL")), ("InvertedBottleneck", (C, 24, 5, None, "None", "HS", 2, False)),
    ("MobileNetV3_BLOCK", (C, C, 3, None, "None", "RE", 1, False)), ("PatchMerging", (32, 64)),
    ("VanillaBlock", (C, C, 1, 1)), ("ConvNeXt_Block", (C, C, 1, 0.0)),
    ("StarBlock", (C, 2, 1)), ("BasicStage", (C, 1, 4, 3)), ("WindowAttention", (C, 3, 4)),
    ("SwinTransformerBlock", (C, 4, 3, 0)), ("SeBlock", (C, 8)),
]


@pytest.mark.parametrize("m,args", ARG_CASES, ids=[f"{m}-{i}" for i, (m, _) in enumerate(ARG_CASES)])
def test_module_args_match_jax(m, args, jax_semantics):
    """The modules' other arguments (G_bneck's stride 2 with SE and its c1 != c2 shortcut, SGBlock's four layouts,
    DepthSepConv's 5x5 stride 2, Shuffle_Block's stride 2, MBConv's stride 2 and expansion 1, MobileNetV3's
    depthwise-only branch, mn_conv's VALID k == s and its GELU, SiLU and ELU, InvertedBottleneck without its
    pointwise conv, PatchMerging of an odd map, the window attention's and the Swin block's window 4 and heads,
    VanillaBlock's stride 1, ConvNeXt without layer scale, StarBlock's ratio, BasicStage's ratio) in eval mode within
    1e-4."""
    jm, tm, variables, a, kind = pair(m, args, seed=3)
    x = make_input(kind, a[0], 11)
    if m == "PatchMerging":  # an odd map, padded by one row and column
        x = x[:, :11, :19]
    ref, _ = jax_run(m, jm, variables, x, training=False)
    np.testing.assert_allclose(port_run(m, tm.eval(), x, kind), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw,ws,shift", [((6, 9), 3, 1), ((7, 10), 3, 1), ((5, 5), 7, 3)])
def test_swin_shift_mask_and_block(hw, ws, shift):
    """The shifted windows' mask and index (JAX `_swin_attn_mask`, `_relative_position_index`) where the window
    divides the map (6 x 9 in 3 x 3 windows) and where the block pads it first (7 x 10; 5 x 5 in the variants'
    7 x 7 windows, the map smaller than a window): the port's arrays are the JAX ones, and a shifted
    SwinTransformerBlock on such a map matches the JAX block within 1e-4."""
    hp, wp = (-(-hw[0] // ws) * ws, -(-hw[1] // ws) * ws)
    np.testing.assert_array_equal(TR._swin_attn_mask(hp, wp, ws, shift), JR._swin_attn_mask(hp, wp, ws, shift))
    np.testing.assert_array_equal(TR._relative_position_index(ws), JR._relative_position_index(ws))
    jm, tm, variables, _, _ = pair("SwinTransformerBlock", (C, 2, ws, shift), seed=5)
    x = np.random.default_rng(6).standard_normal((2, *hw, C)).astype(np.float32)
    ref, _ = jax_run("SwinTransformerBlock", jm, variables, x, training=False)
    np.testing.assert_allclose(port_run("SwinTransformerBlock", tm.eval(), x, "nhwc"), ref, rtol=0, atol=1e-4)


def test_swin_trains_after_serving_in_inference_mode():
    """The window index and the shifted windows' masks are made once a shape (cached): made under
    torch.inference_mode() by a serving forward, they still take part in a later training forward's graph."""
    tm = TR.SwinStage(C, C, 2, 2, 3)
    x = torch.from_numpy(make_input("map", C, 12)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        tm.eval()(x[:, :, :5, :7])  # a map of its own, so the cached tensors are made here
    tm.train()(x[:, :, :5, :7].clone()).square().sum().backward()
    assert tm.blocks[1].attn.relative_position_bias_table.grad.abs().sum() > 0


@pytest.mark.parametrize("m", sorted(set(NAMES) - INTERNAL - {"PatchMerging", "SwinStage"}))
def test_fold_equals_the_unfolded_forward(m):
    """`fuse_conv_bn` folds every ConvBN, CBA and BiasConv of the module (a separate BatchNorm after a conv:
    InvertedBottleneck's biased `proj` and `bn`, FasterNet's `proj` / `reduction` and `norm`) and the folded forward,
    its 3x3 s1 g1 convs through the conv3x3 wrapper (hard-swish after Conv_BN_HSwish's and mn_conv's, BasicStage's
    bias-free partial convs with a zero bias), equals the unfolded one; the sites are the ones listed; a stem takes
    /255 in the conv it names `frame_conv`. The folded biases stay f32 when the serving copy is cast to bf16."""
    _, tm, _, a, kind = pair(m)
    x = to_port(make_input(kind, a[0], 5), kind)
    with torch.no_grad():
        ref = tm.eval()(x)
        folded = fuse_conv_bn(copy.deepcopy(tm))
        got = folded(x)
    convs = folded_convs(folded)
    assert convs and all(c.folded is not None for c in convs)
    assert len(conv3x3_sites(tm)) == SITES.get(m, 0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    if hasattr(tm, "frame_conv"):
        fc = folded.frame_conv
        fc.fold(torch.float32, in_scale=1.0 / 255.0)
        with torch.no_grad():
            np.testing.assert_allclose(folded(x * 255.0).numpy(), ref.numpy(), rtol=0, atol=1e-4)
    folded.to(torch.bfloat16)
    assert all(c.folded[1].dtype == torch.float32 for c in conv3x3_sites(folded))


# -- the published blocks, and the JAX faults -------------------------------------------------------------------------


def test_port_starblock_adds_a_residual_per_block():
    """The port's StarBlock of n = 2 is two published StarNet blocks in sequence (Ma et al., 2024: each `x = input +
    drop_path(dwconv2(g(act(f1(x)) * f2(x))))`); the JAX StarBlock (`research.py:1341-1350`) adds one residual around
    both: the two part by more than 0.1 on the same weights."""
    jm, tm, variables, a, kind = pair("StarBlock", (C, 3, 2))
    x = make_input(kind, C, 7)
    xt = to_port(x, kind)
    with torch.no_grad():
        tm.eval()
        y = xt
        for i in range(2):
            y = y + tm.star(i, y)
        np.testing.assert_allclose(from_port(tm(xt), kind), from_port(y, kind), rtol=0, atol=0)
    jax_out, _ = jax_run("StarBlock", jm, variables, x, training=False)
    assert np.abs(jax_out - from_port(y, kind)).max() > 0.1


def test_jax_sgblock_runs_no_relu6():
    """The JAX SGBlock's "relu6" ConvBNs (`research.py:829-845`) go through `apply_act` (`nn/modules.py:214`), which
    has no ReLU6 and returns its input: the JAX block is the port's with its ReLU6s removed, and not the published
    MobileNeXt sandglass (Zhou et al., 2020), whose depthwise and expanding convs end in ReLU6; the port runs them."""
    assert np.array_equal(np.asarray(JM.apply_act(jnp.asarray([-3.0, 7.0]), "relu6")), [-3.0, 7.0])
    jm, tm, variables, a, kind = pair("SGBlock", (C, 32, 2, 2))
    x = make_input(kind, C, 8)
    jax_out, _ = jax_run("SGBlock", jm, variables, x, training=False)
    got = port_run("SGBlock", tm.eval(), x, kind)
    assert isinstance(tm.pw2, TR.CBA) and tm.pw2.post_act == "relu6" and got.min() < 0 < got.max()
    assert np.abs(jax_out - got).max() > 0.1


def test_drop_connect_zeroes_whole_samples_from_a_seeded_generator():
    """MBConvBlock's drop-connect in training: each sample's branch is kept (divided by the keep rate) or dropped
    whole, by draws from the block's CPU generator (seeded 0), so two blocks drop the same samples; in eval mode
    and at rate 0 nothing is dropped. The JAX block draws from a flax "dropout" stream that neither the JAX
    `build_model` (its stride probe runs in training) nor its train step provides: it cannot build one of rate > 0."""
    rate, b = 0.5, 16
    x = torch.from_numpy(make_input("map", C, 9)).permute(0, 3, 1, 2).repeat(8, 1, 1, 1)[:b]
    blocks = [TR.MBConvBlock(C, C, 3, 1, 1, rate) for _ in range(2)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    with torch.no_grad():
        branch = blocks[0].train().project(blocks[0].dw(x))
        outs = [blk.train()(x) for blk in blocks]
        kept = [((o - x) - branch / (1 - rate)).flatten(1).abs().amax(1) < 1e-5 for o in outs]
        dropped = [(o - x).flatten(1).abs().amax(1) == 0 for o in outs]
    assert torch.equal(outs[0], outs[1]) and torch.equal(kept[0], kept[1])
    assert bool((kept[0] ^ dropped[0]).all()) and 0 < int(dropped[0].sum()) < b
    again = blocks[0](x)  # the next draws
    assert not torch.equal(again, outs[0])
    with torch.no_grad():
        blk = blocks[0].eval()
        np.testing.assert_allclose(blk(x).numpy(), (blk.project(blk.dw(x)) + x).numpy(), rtol=0, atol=1e-5)
    jm = JR.MBConvBlock(C, C, 3, 1, 1, rate, name="m")
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    variables = jm.init(jax.random.PRNGKey(0), xj)
    with pytest.raises(flax.errors.InvalidRngError):
        jm.apply(variables, xj, training=True, mutable=["batch_stats"])


@pytest.mark.parametrize("m", ["WindowAttention", "ConvNeXt_Block", "InvertedBottleneck", "PatchEmbed_FasterNet"])
def test_bridge_round_trips_the_new_leaves(m):
    """JAX variables -> the port's state_dict -> JAX variables is the identity: the f32 bias table, ConvNeXt's
    `m_<i>_gamma` and `m_<i>_dwconv`, the biased `proj` before its own `bn`, the BatchNorm named `norm`."""
    _, tm, variables, _, _ = pair(m)
    back = state_dict_to_flax(tm.state_dict())
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    for col in ("params", "batch_stats"):
        ref, got = flat(variables.get(col, {})), flat(back[col])
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=jax.tree_util.keystr(k))


# -- the twelve LPC-YOLO variants ------------------------------------------------------------------------------------


VARIANTS = sorted(TR.BACKBONE_VARIANTS)


def narrow_cfg(v: str) -> dict:
    """The variant at width 0.25 (nc 4)."""
    d = TR.lpc_backbone_cfg(v)
    d.update(nc=4, scales={"t": [0.33, 0.25, 512]}, scale="t")
    return d


@pytest.mark.parametrize("v", VARIANTS)
def test_parse_and_shape_tree_match_jax(v):
    """LPC-YOLO at its s scale with the variant's backbone: the same LayerSpecs as JAX `parse_model` (the widths,
    LeYOLO's expansions, ConvNeXt's and StarBlock's folded repeats), the head reading the PSA and the family's
    stride-8 and stride-16 outputs, strides 8, 16, 32; and the port's flax-shape tree of the backbone (layers 0 to
    the PSA) is the JAX backbone's `eval_shape` tree leaf for leaf (a headless JAX graph of those LayerSpecs). The
    LPC neck and head after it are LayerSpecs equal to JAX's of modules whose trees the earlier slices hold, so the
    whole graphs' parameter counts agree (`chip_smoke.py` asserts them at the s width: BACKBONE_PARAMS)."""
    d = TR.lpc_backbone_cfg(v)
    specs, save = parse_model(dict(d))
    jspecs, jsave = JC.parse_model(dict(d, scale="s"))
    assert [(s.i, s.f, s.n, s.module, s.args, s.c2) for s in specs] == \
        [(s.i, s.f, s.n, s.module, s.args, s.c2) for s in jspecs] and save == jsave
    nb = len(d["backbone"])
    assert {s.module for s in specs[:nb - 2]} <= TR.BACKBONE | {"Conv"}
    assert [s.module for s in specs[nb - 2:nb]] == ["SPPF", "PSA"] and specs[-1].module == "v10Detect"
    reads = {j for s in specs[nb:] for j in s.f if 0 <= j < nb}
    assert reads == {TR.BACKBONE_VARIANTS[v]["p3"], TR.BACKBONE_VARIANTS[v]["p4"], nb - 1}
    tm = build_model(d, device="meta")
    assert tm.strides == (8.0, 16.0, 32.0)
    jm = JC.DetectionModel(specs=jspecs[:nb], save=jsave, nc=d["nc"], dtype=jnp.float32)  # the backbone, headless
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), training=True))
    flat = lambda t: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t, is_leaf=lambda q: isinstance(q, tuple))}
    port = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        mine = {k: t for k, t in port[col].items() if int(k.split("_")[1]) < nb}
        assert flat(mine) == flat(dict(tree.get(col, {}))), col
