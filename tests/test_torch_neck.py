"""The research zoo's 15 neck blocks of the port (`lpc_yolo_tpu_torch/nn/research.py`) against the JAX package's
(`lpc_yolo_tpu/nn/research.py:734-777`, `:1420-2003`), on the CPU in f32.

Each block runs at 32 channels on a (2, 12, 20) map (not square, so a swapped H and W shows; ASFF on three levels
of 16 x 24, 8 x 12 and 4 x 6) with the weights of `random_variables` of the JAX shape tree, through the bridge.
Outputs are held at atol 1e-5 in eval mode and in train mode, and in train mode the BatchNorm statistics too.
Gradients (of the output against a fixed random cotangent, in train mode) are held to the port's own f64 run: the
port's f32 ones within 1e-4 and the JAX package's within 1e-3 of each leaf's largest value. Against JAX, two
functions of the port are swapped for the JAX package's in the test only: `gsconv_shuffle` for the JAX interleave
(GSConv and every block that holds one), and DySample's forward for a torch statement of the JAX module (its
transposed initial offsets and its sampler's clamped taps). The port's own GSConv and DySample are then held to the
published forwards, and three tests show the JAX faults. The parse rules are held to JAX `parse_model` on the
twelve LPC-YOLO variants of `lpc_neck_cfg`, the narrow graphs' shape trees to `jax.eval_shape`'s, and each variant's
graph round-trips through a reference-layout `.pt`.
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

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.nn import build_model, parse_model
from lpc_yolo_tpu_torch.nn import research as TR
from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites, folded_convs, fuse_conv_bn
from lpc_yolo_tpu_torch.utils.flax_bridge import (flax_shapes, flax_to_state_dict, random_variables,
                                                  state_dict_to_flax)

C = 32
HW = (12, 20)
LEVELS = ((16, 24), (8, 12), (4, 6))
NAMES = sorted(TR.NECK)
WITH_BN = set(NAMES) - {"DySample", "SCSA", "FGFP", "FGFP_Head", "AxialImageTransformer"}
# conv3x3 sites at the default args: the GS bottlenecks' gs2.cv1, RFB's four undilated 3x3s, ASFF's conv, PPA's c1 to
# c3, FGFP's two refines, FGFP_Head's conv2, the axial transformer's four FFN convs
SITES = {"VoVGSCSP": 1, "VoVGSCSPC": 1, "BasicRFB": 4, "ASFF2": 1, "ASFF3": 1, "PPA": 3, "FGFP": 2, "FGFP_Head": 1,
         "AxialImageTransformer": 4}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def compiled_args(m: str, c: int = C) -> tuple:
    """The block's args as the parse rules give them at a c-channel input and no YAML args (ASFF3's levels c, 2c,
    4c at level 1, ASFF2's c, 2c at level 0)."""
    if m == "ASFF3":
        return ((c, 2 * c, 4 * c), c, 1)
    if m == "ASFF2":
        return ((c, 2 * c), c, 0)
    if m in TR.WIDTH_REPEAT:
        return (c, c, 1)
    if m in TR.WIDTH_SCALED:
        return (c, c)
    return (c,)


def inputs_nhwc(m: str, args: tuple, seed: int = 0):
    """The block's NHWC input: one map, or ASFF's list of levels."""
    rng = np.random.default_rng(seed)
    if m in TR.MULTI_INPUT:
        return [rng.standard_normal((2, *LEVELS[j], c)).astype(np.float32) for j, c in enumerate(args[0])]
    return rng.standard_normal((2, *HW, args[0])).astype(np.float32)


def nchw(x):
    if isinstance(x, list):
        return [nchw(t) for t in x]
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_in(x):
    return [jnp.asarray(t) for t in x] if isinstance(x, list) else jnp.asarray(x)


def jax_interleave(y: torch.Tensor) -> torch.Tensor:
    """The JAX GSConv's shuffle (`research.py:1439-1441`): the two halves interleaved, [a0, b0, a1, b1, ...]."""
    b, c, h, w = y.shape
    return y.reshape(b, 2, c // 2, h, w).transpose(1, 2).reshape(b, c, h, w)


def jax_grid_sample(x: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """The JAX `_grid_sample_border` (`research.py:1673`) in torch: x (B, C, H, W) at normalised (B, h', w')
    coordinates, the integer taps clamped to the map but their weights kept from the unclamped coordinate."""
    b, c, h, w = x.shape
    fx = (cx + 1.0) * 0.5 * w - 0.5
    fy = (cy + 1.0) * 0.5 * h - 0.5
    x0, y0 = fx.floor(), fy.floor()
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
    x0i, y0i = x0.long().clamp(0, w - 1), y0.long().clamp(0, h - 1)
    x1i, y1i = (x0i + 1).clamp(0, w - 1), (y0i + 1).clamp(0, h - 1)
    flat = x.flatten(2)

    def gather(yi, xi):
        idx = (yi * w + xi).flatten(1)[:, None].expand(b, c, -1)
        return flat.gather(2, idx).view(b, c, *yi.shape[1:])

    return (gather(y0i, x0i) * (1 - wx) * (1 - wy) + gather(y0i, x1i) * wx * (1 - wy)
            + gather(y1i, x0i) * (1 - wx) * wy + gather(y1i, x1i) * wx * wy)


def jax_dysample_forward(self, x: torch.Tensor) -> torch.Tensor:
    """The JAX DySample (`research.py:1701`) in torch on the port module's weights (its `offset` channels in the
    published (2, groups * s²) order): the JAX initial offsets, x following the subpixel's row and y its column, and
    the JAX sampler."""
    b, c, h, w = x.shape
    s, g = self.scale, self.groups
    n = g * s * s
    v = (torch.arange(s, dtype=x.dtype) - (s - 1) / 2) / s
    init_x = v[:, None].expand(s, s).reshape(-1).repeat(g)[None, :, None, None]
    init_y = v[None, :].expand(s, s).reshape(-1).repeat(g)[None, :, None, None]
    off = self.offset(x) * 0.25
    cx = 2 * (torch.arange(w, dtype=x.dtype) + 0.5 + off[:, :n] + init_x) / w - 1
    cy = 2 * (torch.arange(h, dtype=x.dtype)[:, None] + 0.5 + off[:, n:] + init_y) / h - 1

    def shuffle(t):  # (B, g * s * s, H, W) -> (B * g, sH, sW)
        return t.view(b, g, s, s, h, w).permute(0, 1, 4, 2, 5, 3).reshape(b * g, s * h, s * w)

    out = jax_grid_sample(x.reshape(b * g, c // g, h, w), shuffle(cx), shuffle(cy))
    return out.reshape(b, c, s * h, s * w)


@pytest.fixture
def jax_semantics(monkeypatch):
    """The two JAX-side functions swapped into the port, for the comparisons with the JAX package."""
    monkeypatch.setattr(TR, "gsconv_shuffle", jax_interleave)
    monkeypatch.setattr(TR.DySample, "forward", jax_dysample_forward)


def pair(m: str, args: tuple = None, seed: int = 0):
    """The JAX block, the port's with the same seeded weights, and the JAX variables."""
    a = compiled_args(m) if args is None else args
    jm = JR.build_research_module(m, a, jnp.float32, "m")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jax_in(inputs_nhwc(m, a)), training=True))
    variables = random_variables(shapes, seed)
    tm = TR.build_research_module(m, a)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jm, tm, variables, a


def jax_run(jm, variables, x, training: bool):
    if training:
        y, new = jm.apply(variables, jax_in(x), training=True, mutable=["batch_stats"])
        return np.asarray(y), jax.tree.map(np.asarray, dict(new))
    return np.asarray(jm.apply(variables, jax_in(x), training=False)), {}


@pytest.mark.parametrize("m", NAMES)
def test_block_matches_jax_in_eval_mode(m, jax_semantics):
    jm, tm, variables, a = pair(m)
    x = inputs_nhwc(m, a, 1)
    ref, _ = jax_run(jm, variables, x, training=False)
    with torch.no_grad():
        got = nhwc(tm.eval()(nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


ARG_CASES = [("GSConv", (C, 16, 3, 2)), ("GSConv", (C, C, 3, 1, 4)), ("GSConvns", (C, 16, 3, 2)),
             ("VoVGSCSP", (C, 16, 2)), ("VoVGSCSPC", (C, 16)), ("BasicRFB", (C, 16, 2)),
             ("BasicRFB", (C, C, 1, 0.5, 4, 2)),
             ("MSBlock", (C, 16, (1, 3, 5))), ("MSBlock", (C, C, (3, 3), 2.0, 1.0, 2)), ("C2f_MSBlock", (C, 16, 2)),
             ("ASFF3", ((C, 2 * C, 4 * C), C, 0)), ("ASFF3", ((C, 2 * C, 4 * C), C, 2)), ("ASFF2", ((C, 2 * C), C, 1)),
             ("DySample", (C, 2, "lp", 2)), ("DySample", (C, 4)), ("PPA", (C, 16)), ("SCSA", (C, 4)),
             ("SCSA", (C, 8, 4)), ("FGFP", (C, 24, 4)), ("AxialImageTransformer", (C, 2, 4))]


@pytest.mark.parametrize("m,args", ARG_CASES, ids=[f"{m}-{i}" for i, (m, _) in enumerate(ARG_CASES)])
def test_block_args_match_jax(m, args, jax_semantics):
    """The blocks' other arguments (GSConv's 3x3 stride 2 and groups, VoVGSCSP's two bottlenecks, RFB's stride,
    scale, reduction and vision, MSBlock's kernel sizes and ratios, ASFF's other levels, DySample's groups and x4,
    SCSA's heads and window, FGFP's width and ratio, two axial depths) in eval mode, atol 1e-5."""
    jm, tm, variables, a = pair(m, args, seed=3)
    x = inputs_nhwc(m, a, 11)
    ref, _ = jax_run(jm, variables, x, training=False)
    with torch.no_grad():
        got = nhwc(tm.eval()(nchw(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", NAMES)
def test_block_matches_jax_in_train_mode(m, jax_semantics):
    """Outputs on batch statistics within 1e-5 of the larger of 1 and the output's largest value (MSBlock's nine
    BatchNorms on batch statistics in a chain part by up to 1.8e-5 on outputs of up to 5.8: f32 rounding, which the
    per-batch normalisations carry to every element), and the new running statistics (momentum 0.03, the biased
    variance) within 1e-5."""
    jm, tm, variables, a = pair(m)
    x = inputs_nhwc(m, a, 2)
    ref, new = jax_run(jm, variables, x, training=True)
    with torch.no_grad():
        got = nhwc(tm.train()(nchw(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
    stats = state_dict_to_flax(tm.state_dict())["batch_stats"]
    assert bool(stats) == (m in WITH_BN)
    ref_stats = dict(jax.tree_util.tree_leaves_with_path(new.get("batch_stats", {})))
    got_stats = dict(jax.tree_util.tree_leaves_with_path(stats))
    assert ref_stats.keys() == got_stats.keys()
    for k, v in ref_stats.items():
        np.testing.assert_allclose(got_stats[k], v, rtol=0, atol=1e-5, err_msg=jax.tree_util.keystr(k))


def port_grads(tm, x, r, dtype: torch.dtype):
    m = copy.deepcopy(tm).to(dtype).train()
    xs = [t.to(dtype).requires_grad_(True) for t in (x if isinstance(x, list) else [x])]
    y = m(xs if isinstance(x, list) else xs[0])
    (y * r.to(dtype)).sum().backward()
    out = {k: p.grad.detach().double() for k, p in m.named_parameters()}
    for j, t in enumerate(xs):
        out[f"input{j}"] = t.grad.detach().double()
    return out


@pytest.mark.parametrize("m", NAMES)
def test_gradients_match_the_f64_run(m, monkeypatch):
    """Train-mode gradients of <block(x), r> for every parameter and input: the port's own f32 run within 1e-4 of
    its f64 run, and the JAX package's within 1e-3 of the port's f64 run with the JAX functions swapped in, of each
    leaf's largest value (or of a hundredth of the largest over all leaves where a leaf's gradient is 0 by structure:
    a bias before a BatchNorm or a softmax)."""
    jm, tm, variables, a = pair(m)
    x = inputs_nhwc(m, a, 3)
    y = jax_run(jm, variables, x, training=False)[0]
    r = np.random.default_rng(4).standard_normal(y.shape).astype(np.float32)

    def scaled(g64):
        top = max(g.abs().max().item() for g in g64.values())
        return {k: max(g.abs().max().item(), 1e-2 * top) for k, g in g64.items()}

    g64, g32 = (port_grads(tm, nchw(x), nchw(r), dt) for dt in (torch.float64, torch.float32))
    assert g64.keys() == g32.keys()
    scale = scaled(g64)
    for k, ref in g64.items():
        np.testing.assert_allclose(g32[k].numpy(), ref.numpy(), rtol=0, atol=1e-4 * scale[k], err_msg=k)

    monkeypatch.setattr(TR, "gsconv_shuffle", jax_interleave)
    monkeypatch.setattr(TR.DySample, "forward", jax_dysample_forward)
    g64 = port_grads(tm, nchw(x), nchw(r), torch.float64)
    scale = scaled(g64)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params, xj):
        out, _ = jm.apply({"params": params, **rest}, xj, training=True, mutable=["batch_stats"])
        return (out * jnp.asarray(r)).sum()

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables.get("params", {}), jax_in(x))
    gj = {k: v.double() for k, v in flax_to_state_dict({"params": jax.tree.map(np.asarray, gp)}).items()}
    for j, g in enumerate(gx if isinstance(gx, list) else [gx]):
        gj[f"input{j}"] = torch.from_numpy(np.asarray(g).transpose(0, 3, 1, 2).copy()).double()
    assert gj.keys() == g64.keys()
    for k, ref in g64.items():
        np.testing.assert_allclose(gj[k].numpy(), ref.numpy(), rtol=0, atol=1e-3 * scale[k], err_msg=k)


@pytest.mark.parametrize("m", sorted(set(NAMES) - {"DySample"}))
def test_fold_equals_the_unfolded_forward(m):
    """`fuse_conv_bn` folds every ConvBN, CBA and BiasConv of the block (PPA's and the biased CBAs' conv biases
    included, SCSA's BN-free q, k, v) and the folded forward, its 3x3 s1 g1 convs through the conv3x3 wrapper,
    equals the unfolded one; the sites are the ones listed. The folded biases stay f32 when the serving copy is
    then cast to bf16, as the kernel takes them."""
    _, tm, _, a = pair(m)
    x = nchw(inputs_nhwc(m, a, 5))
    with torch.no_grad():
        ref = tm.eval()(x)
        folded = fuse_conv_bn(copy.deepcopy(tm))
        got = folded(x)
    assert folded_convs(folded) and all(c.folded is not None for c in folded_convs(folded))
    assert len(conv3x3_sites(tm)) == SITES.get(m, 0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    folded.to(torch.bfloat16)
    assert all(c.folded[1].dtype == torch.float32 for c in conv3x3_sites(folded))


# -- the published forwards, and the JAX faults --------------------------------------------------------------------


def published_gsconv(tm, x: torch.Tensor) -> torch.Tensor:
    """The published slim-neck `GSConv.forward` (Li et al., 2022), on the port module's convs."""
    x1 = tm.cv1(x)
    x2 = torch.cat((x1, tm.cv2(x1)), 1)
    b, n, h, w = x2.size()
    y = x2.reshape(b * n // 2, 2, h * w).permute(1, 0, 2).reshape(2, -1, n // 2, h, w)
    return torch.cat((y[0], y[1]), 1)


@pytest.mark.parametrize("c2", [8, 16])
def test_port_gsconv_is_the_published_forward(c2):
    _, tm, _, a = pair("GSConv", (C, c2, 3, 1))
    x = nchw(inputs_nhwc("GSConv", a, 6))
    with torch.no_grad():
        np.testing.assert_allclose(tm.eval()(x).numpy(), published_gsconv(tm, x).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("c2", [4, 8])
def test_jax_gsconv_interleaves(c2):
    """The JAX GSConv (`research.py:1439-1441`) interleaves its halves where the published forward takes the even
    channels, then the odd ones: the two agree at c2 = 4 and part from c2 = 8 on, on the same weights."""
    jm, tm, variables, a = pair("GSConv", (C, c2, 3, 1))
    x = inputs_nhwc("GSConv", a, 7)
    jax_out = jax_run(jm, variables, x, training=False)[0]
    with torch.no_grad():
        published = nhwc(published_gsconv(tm.eval(), nchw(x)))
    if c2 == 4:
        np.testing.assert_allclose(jax_out, published, rtol=0, atol=1e-5)
    else:
        assert np.abs(jax_out - published).max() > 0.1


def zero_offsets(tm):
    with torch.no_grad():
        tm.offset.weight.zero_()
        tm.offset.bias.zero_()
    return tm


@pytest.mark.parametrize("scale", [2, 4])
def test_port_dysample_at_zero_offset_is_the_bilinear_upsample(scale):
    """With its offset conv at zero the published DySample ("lp") is F.interpolate's half-pixel bilinear upsample."""
    tm = zero_offsets(TR.DySample(C, scale))
    x = nchw(inputs_nhwc("DySample", (C,), 8))
    with torch.no_grad():
        ref = F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)
        np.testing.assert_allclose(tm.eval()(x).numpy(), ref.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="pl"):
        TR.DySample(C, 2, "pl")


def test_jax_dysample_offsets_are_transposed():
    """At zero offsets the JAX DySample (`research.py:1718-1722`) samples a ramp in x at 0.75, 0.75, 1.75, 1.75, 2.75,
    2.75 over output columns 2 to 7 of an even row, where the bilinear x2 upsample (and the port) samples 0.75, 1.25,
    1.75, 2.25, 2.75, 3.25: its x offset follows the output's row subpixel, its y offset the column's (a ramp in y
    down an even column alike). On noise the two part by more than 0.2."""
    jm = JR.DySample(16, 2, groups=4)
    h = w = 8
    ramp_x = np.broadcast_to(np.arange(w, dtype=np.float32)[None, None, :, None], (1, h, w, 16)).copy()
    ramp_y = np.ascontiguousarray(ramp_x.transpose(0, 2, 1, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(ramp_x)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = zero_offsets(TR.DySample(16, 2))
    for ramp, axis in ((ramp_x, 2), (ramp_y, 1)):
        jax_out = np.asarray(jm.apply(variables, jnp.asarray(ramp)))
        with torch.no_grad():
            port = nhwc(tm(nchw(ramp)))
        line = (lambda a: a[0, 2, :, 0]) if axis == 2 else (lambda a: a[0, :, 2, 0])
        np.testing.assert_allclose(line(port)[2:8], [0.75, 1.25, 1.75, 2.25, 2.75, 3.25], atol=1e-6)
        np.testing.assert_allclose(line(jax_out)[2:8], [0.75, 0.75, 1.75, 1.75, 2.75, 2.75], atol=1e-6)
    noise = np.random.default_rng(9).standard_normal((1, h, w, 16)).astype(np.float32)
    jax_out = np.asarray(jm.apply(variables, jnp.asarray(noise)))
    bilinear = nhwc(F.interpolate(nchw(noise), scale_factor=2, mode="bilinear", align_corners=False))
    assert np.abs(jax_out - bilinear).max() > 0.2


def test_jax_dysample_border_is_not_grid_sample():
    """The JAX sampler (`_grid_sample_border`, `research.py:1673`) clamps the integer taps but keeps the weight of the
    unclamped coordinate: at x = -0.25 (pixels) it returns 0.25 v[0] + 0.75 v[1], where grid_sample's border mode
    returns v[0]; inside the map the two agree."""
    v = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1) ** 1.5
    xs = np.array([-0.25, 0.4, 1.6, 3.3], np.float32)  # pixel coordinates along x, at row 1
    cx = jnp.asarray(((xs + 0.5) * 2 / 4 - 1)[None, None])
    cy = jnp.full_like(cx, (1 + 0.5) * 2 / 4 - 1)
    jax_out = np.asarray(JR._grid_sample_border(jnp.asarray(v), cx, cy))[0, 0, :, 0]
    grid = torch.stack([torch.from_numpy(np.asarray(cx)), torch.from_numpy(np.asarray(cy))], -1)
    torch_out = F.grid_sample(nchw(v), grid, mode="bilinear", padding_mode="border", align_corners=False)[0, 0, 0]
    row = v[0, 1, :, 0]
    np.testing.assert_allclose(torch_out[0].item(), row[0], rtol=1e-6)
    np.testing.assert_allclose(jax_out[0], 0.25 * row[0] + 0.75 * row[1], rtol=1e-6)
    np.testing.assert_allclose(jax_out[1:3], torch_out[1:3].numpy(), rtol=1e-6)
    assert abs(jax_out[0] - torch_out[0].item()) > 0.5


def test_helpers_match_jax():
    """`resize_bilinear` and `resize_nearest` against `jax.image.resize` at the slice's ratios (x2 and x4 up, as
    LocalGlobalAttention and FGFP take them, from square and non-square maps); `max_pool` and `avg_pool` against
    the JAX helpers, padded and not."""
    x = np.random.default_rng(12).standard_normal((2, 5, 3, 4)).astype(np.float32)
    for f in (2, 4):
        h, w = 5 * f, 3 * f
        for method, port in (("bilinear", TR.resize_bilinear), ("nearest", TR.resize_nearest)):
            ref = np.asarray(jax.image.resize(x, (2, h, w, 4), method=method))
            np.testing.assert_allclose(nhwc(port(nchw(x), h, w)), ref, rtol=0, atol=1e-6, err_msg=method)
    y = np.random.default_rng(13).standard_normal((2, 9, 7, 4)).astype(np.float32)
    for k, s, p in ((2, 2, 0), (3, 1, 1), (7, 7, 0), (3, 2, 1)):
        for jf, tf in ((JR.max_pool, TR.max_pool), (JR.avg_pool, TR.avg_pool)):
            np.testing.assert_allclose(nhwc(tf(nchw(y), k, s, p)), np.asarray(jf(jnp.asarray(y), k, s, p)), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("m", ["ASFF3", "DySample", "MSBlock", "SCSA", "PPA"])
def test_bridge_round_trips_the_new_leaves(m):
    """JAX variables -> the port's state_dict -> JAX variables is the identity, ASFF's flipped ConvTranspose kernels,
    DySample's permuted offsets, MSBlock's `mid_<i>_<j>_in`, SCSA's bare 1-D kernels and PPA's `prompt` included."""
    _, tm, variables, _ = pair(m)
    back = state_dict_to_flax(tm.state_dict())
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    for col in ("params", "batch_stats"):
        ref, got = flat(variables.get(col, {})), flat(back[col])
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=jax.tree_util.keystr(k))


# -- the twelve LPC-YOLO variants ----------------------------------------------------------------------------------


VARIANTS = sorted(TR.NECK_VARIANTS)


@pytest.mark.parametrize("v", VARIANTS)
def test_parse_matches_jax(v):
    """LPC-YOLO at its s scale with the variant's neck blocks: the same LayerSpecs as JAX `parse_model` (the widths,
    VoVGSCSP's and C2f_MSBlock's repeats folded in, ASFF's level widths), no layer index before the change moved,
    and the head reading 64, 192 and 384 channels as in the published graph."""
    d = TR.lpc_neck_cfg(v)
    specs, save = parse_model(dict(d))
    jspecs, jsave = JC.parse_model(dict(d, scale="s"))
    assert [(s.i, s.f, s.n, s.module, s.args, s.c2) for s in specs] == \
        [(s.i, s.f, s.n, s.module, s.args, s.c2) for s in jspecs] and save == jsave
    assert {s.module for s in specs} >= set(TR.NECK_VARIANTS[v])
    head = specs[-1]
    assert head.module == "v10Detect" and head.args[-1] == (64, 192, 384)
    base, _ = parse_model(yaml.safe_load(TR.LPC_YAML.read_text()))
    first = min(s.i for s, b in zip(specs, base) if (s.module, s.args) != (b.module, b.args))
    assert [(s.f, s.c2) for s in specs[:first]] == [(b.f, b.c2) for b in base[:first]]


def narrow_cfg(v: str = None) -> dict:
    """LPC-YOLO at width 0.25 (nc 4), with the variant's neck blocks, or as published."""
    d = TR.lpc_neck_cfg(v) if v else yaml.safe_load(TR.LPC_YAML.read_text())
    d.update(nc=4, scales={"t": [0.33, 0.25, 512]}, scale="t")
    return d


S_TREE = 32  # the input side of the shape trees


@pytest.fixture(scope="module")
def narrow_lpc_tree():
    """JAX `eval_shape`'s tree of the narrow LPC-YOLO as published, and its LayerSpecs."""
    d = narrow_cfg()
    jm = jax_build(d)
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S_TREE, S_TREE, 3)), training=True))
    return {col: dict(tree.get(col, {})) for col in ("params", "batch_stats")}, JC.parse_model(d)[0]


def layer_inputs(tm, layers):
    """The NHWC shapes that reach `layers` of the port's graph in a train-mode forward on the meta device (a
    list for ASFF)."""
    seen = {}
    hooks = [tm.model[i].register_forward_pre_hook(
        lambda mod, a, i=i: seen.__setitem__(i, a[0])) for i in layers]
    tm.train()(torch.zeros(1, 3, S_TREE, S_TREE, device="meta"))
    for h in hooks:
        h.remove()
    shape = lambda t: jnp.zeros((t.shape[0], *t.shape[2:], t.shape[1]))  # noqa: E731
    return {i: [shape(t) for t in x] if isinstance(x, list) else shape(x) for i, x in seen.items()}


@pytest.mark.parametrize("v", VARIANTS)
def test_narrow_graph_shape_tree_matches_jax(v, narrow_lpc_tree):
    """A narrow LPC-YOLO (width 0.25) of each variant: the port's `flax_shapes` is the JAX tree leaf for leaf, that
    is the published graph's with each neck layer `model_<i>` the JAX block's own `eval_shape` tree at the args JAX
    `parse_model` gives it and the input the graph gives it (the head at its new index after ASFF's layers; each
    whole graph's trace would take ~6 s)."""
    base, base_specs = narrow_lpc_tree
    jspecs, _ = JC.parse_model(narrow_cfg(v))
    tm = build_model(narrow_cfg(v), device="meta")
    changed = [s.i for s in jspecs[:-1] if s.i >= len(base_specs) - 1 or
               (s.module, s.args) != (base_specs[s.i].module, base_specs[s.i].args)]
    assert changed and all(jspecs[i].module in TR.NECK for i in changed)
    tree = {col: dict(t) for col, t in base.items()}
    head = len(base_specs) - 1
    for col in tree:
        tree[col][f"model_{len(jspecs) - 1}"] = tree[col].pop(f"model_{head}")
    for i, x in layer_inputs(tm, changed).items():
        spec = jspecs[i]
        jmod = JR.build_research_module(spec.module, spec.args, jnp.float32, f"model_{i}")
        sub = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, training=True))
        for col in tree:
            tree[col].pop(f"model_{i}", None)
            if sub.get(col):
                tree[col][f"model_{i}"] = sub[col]
    flat = lambda t: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t, is_leaf=lambda q: isinstance(q, tuple))}
    port = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        assert flat(port[col]) == flat(tree[col]), col


@pytest.mark.parametrize("v", VARIANTS)
def test_port_loads_the_pt_of_every_variant(tmp_path, v):
    """Every variant round-trips through a reference-layout `.pt` (`YOLO.save_pt`): the narrow graph's weights come
    back as written, rounded to fp16, and it predicts."""
    path = tmp_path / f"yolov10-{v}.yaml"
    path.write_text(yaml.safe_dump(narrow_cfg(v)))
    yolo = YOLO(path, device="cpu", seed=0)
    pt = yolo.save_pt(tmp_path / f"{path.stem}.pt")
    loaded = YOLO(pt, device="cpu")
    assert {type(m).__name__ for m in loaded.model.model} >= set(TR.NECK_VARIANTS[v]) and loaded.task == "v10"
    got, ref = loaded.model.state_dict(), yolo.model.state_dict()
    assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k].half().float()) for k in got)
    frame = np.random.default_rng(10).integers(0, 256, (64, 48, 3), dtype=np.uint8)
    results = loaded.predict([frame], imgsz=64, conf=0.0, device="cpu")
    assert len(results[0]) > 0 and np.isfinite(results[0].boxes.data).all()
