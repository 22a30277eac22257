"""YOLOv9 (yolov9c, yolov9e) of the port against the JAX package, on the CPU in f32: the blocks, the graphs and
the forwards (training and validation are in `tests/test_torch_v9_train.py`).

Weights come from `random_variables` and reach both packages through the weight bridge, as in
`tests/test_torch_zoo.py`.

* Each v9 block (RepConv with and without its identity branch and at stride 2, RepBottleneck, RepCSP,
  RepNCSPELAN4, ADown at an even and an odd size, SPPELAN, CBLinear's tuple, CBFuse at resize ratios 1, 2, 4
  and 2.6, Silence) against its JAX module, unfolded and folded, atol 1e-5. The JAX package serves RepConv's
  branches unfolded; the port folds them into one 3x3 conv, the same function within f32 rounding.
* Both YAMLs through `YOLO(<name>)` on the meta device (no forward): the YAML byte for byte, the JAX
  `parse_model`'s specs and save list, the strides, the JAX graphs' parameter counts (the torch reference's
  less the DFL's 16, `tests/test_v9_world.py`), the port's variable tree equal to the JAX graph's
  `jax.eval_shape` tree, and the conv3x3 sites of a folded forward (60 and 132).
* A narrow copy of each YAML (every channel argument of 64 or more divided by 8, every layer kept, nc 3) at
  64 px, batch 2, XLA's fusion pass off: the decoded `pred` (boxes atol 1e-3 px, scores atol 1e-6), and
  `predict` through the NMS, unfolded and after `serving_model` (the RepConv fold and the /255 fold, on
  yolov9e into both convs that read the frame through `Silence`), compared tie-tolerantly with
  `utils/compare.py` (box 1e-3, score 1e-6).
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
from lpc_yolo_tpu.nn import modules as JM
from lpc_yolo_tpu.ops.postprocess import non_max_suppression as jax_nms

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine.predictor import serving_model
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites, frame_readers, fuse_conv_bn
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, load_flax, random_variables
from test_torch_blocks import _pair, _x
from test_torch_zoo import JAX_CFG, PORT_CFG, S, jax_eval, jax_graph, jax_shapes

# name given to YOLO -> (the YAML under cfg/models, the JAX graph's parameter count, conv3x3 sites a forward)
V9 = {"yolov9c.yaml": ("v9/yolov9c.yaml", 25_590_896, 60), "yolov9e.yaml": ("v9/yolov9e.yaml", 58_206_576, 132)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are small at imgsz 64: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def narrow_v9(cfg: str, nc: int = 3) -> dict:
    """The YAML dict with every channel argument of 64 or more divided by 8 (CBLinear's widths included), every
    layer and repeat kept, and `nc` classes."""
    d = yaml.safe_load((PORT_CFG / cfg).read_text())
    cut = lambda a: a // 8 if isinstance(a, int) and a >= 64 else a  # noqa: E731
    for layer in d["backbone"] + d["head"]:
        layer[3] = [[cut(c) for c in a] if layer[2] == "CBLinear" and isinstance(a, list) else cut(a)
                    for a in layer[3]]
    return {**d, "nc": nc}


# -- the blocks -----------------------------------------------------------------------------------------------------

# (name, factory of (JAX module, port module), input shape)
BLOCKS = [
    ("repconv_identity", lambda: (JM.RepConv(16), TM.RepConv(16, 16)), (2, 8, 8, 16)),
    ("repconv_no_identity", lambda: (JM.RepConv(16, use_identity=False), TM.RepConv(16, 16, use_identity=False)),
     (2, 8, 8, 16)),
    ("repconv_widen", lambda: (JM.RepConv(24), TM.RepConv(16, 24)), (2, 8, 8, 16)),
    ("repconv_s2", lambda: (JM.RepConv(16, 3, 2), TM.RepConv(16, 16, 3, 2)), (2, 9, 8, 16)),
    ("repbottleneck", lambda: (JM.RepBottleneck(16, e=1.0), TM.RepBottleneck(16, 16, e=1.0)), (2, 8, 8, 16)),
    ("repbottleneck_widen", lambda: (JM.RepBottleneck(24), TM.RepBottleneck(16, 24)), (2, 8, 8, 16)),
    ("repcsp", lambda: (JM.RepCSP(32, n=2), TM.RepCSP(24, 32, n=2)), (2, 8, 8, 24)),
    ("repncspelan4", lambda: (JM.RepNCSPELAN4(32, 32, 16, 1), TM.RepNCSPELAN4(24, 32, 32, 16, 1)), (2, 8, 8, 24)),
    ("repncspelan4_n2", lambda: (JM.RepNCSPELAN4(40, 48, 16, 2), TM.RepNCSPELAN4(16, 40, 48, 16, 2)), (2, 8, 6, 16)),
    ("adown_even", lambda: (JM.ADown(32), TM.ADown(16, 32)), (2, 8, 8, 16)),
    ("adown_odd", lambda: (JM.ADown(32), TM.ADown(16, 32)), (2, 9, 7, 16)),
    ("sppelan", lambda: (JM.SPPELAN(32, 16), TM.SPPELAN(24, 32, 16)), (2, 8, 8, 24)),
    ("silence", lambda: (JM.Silence(), TM.Silence()), (2, 8, 8, 16)),
]


@pytest.mark.parametrize("mode", ["eval", "folded"])
@pytest.mark.parametrize("name,make,shape", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(name, make, shape, mode):
    """Each block against its JAX module on the same bridged weights (`tests/test_torch_blocks.py`), eval mode,
    f32, atol 1e-5, unfolded and after the serving fold (RepConv's branches merged; 3x3 s1 convs through
    conv3x3's plain version)."""
    jmod, tmod = make()
    ref, got = _pair(jmod, tmod, _x(shape))
    if mode == "folded":
        fuse_conv_bn(tmod, torch.float32)
        with torch.no_grad():
            got = tmod(torch.from_numpy(_x(shape).transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("identity", [True, False])
def test_folded_repconv_is_one_conv3x3_site(identity, monkeypatch):
    """A folded stride-1 RepConv runs one conv3x3 call with the SiLU epilogue on its input and nothing else (no
    F.conv2d, no add): the 1x1 branch in the centre tap, the identity BN (when there is one) on the diagonal of
    the centre tap. Its branches are not folded on their own, and `conv3x3_sites` lists the RepConv, not them.
    At stride 2 it is no site. In train mode the fold is dropped."""
    calls = []

    def counting(x, w, b, act):
        calls.append((tuple(x.shape), tuple(w.shape), act))
        return x.new_zeros(x.shape[:3] + w.shape[3:])

    monkeypatch.setattr(TM, "conv3x3", counting)
    monkeypatch.setattr(TM.F, "conv2d", lambda *a, **k: pytest.fail("F.conv2d on a folded RepConv site"))
    m = TM.RepConv(16, 16, use_identity=identity).eval()
    assert (m.bn is not None) == identity
    fuse_conv_bn(m, torch.float32)
    assert m.conv1.folded is None and m.conv2.folded is None and conv3x3_sites(m) == [m]
    with torch.no_grad():
        m(torch.zeros(2, 16, 8, 8))
    assert calls == [((2, 8, 8, 16), (3, 3, 16, 16), "silu")]
    assert not TM.RepConv(16, 16, 3, 2).kernel_path
    assert m.train().folded is None


def test_cblinear_tuple_matches_jax():
    """CBLinear's 1x1 biased conv split into a tuple of maps (16, 24, 8 channels), each within atol 1e-5 of the
    JAX module's, unfolded and after `fuse_conv_bn` (which leaves it alone: it has no BN)."""
    jmod, tmod = JM.CBLinear((16, 24, 8)), TM.CBLinear(32, (16, 24, 8))
    x = _x((2, 8, 8, 32))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    variables = random_variables(shapes, 0)
    ref = [np.asarray(r) for r in jmod.apply(variables, jnp.asarray(x))]
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    for m in (tmod.eval(), fuse_conv_bn(tmod, torch.float32)):
        with torch.no_grad():
            got = m(_nchw(x))
        assert isinstance(got, tuple) and [g.shape[1] for g in got] == [16, 24, 8]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [(8, 8), (4, 8), (2, 8), (5, 13)], ids=["ratio1", "ratio2", "ratio4", "ratio2.6"])
def test_cbfuse_matches_jax(src, dst):
    """CBFuse of two CBLinear-like tuples and a target map at dst x dst: the selected maps of src x src (and of
    src x 2src) resized to the target and summed in the JAX order, within atol 1e-5 of the JAX module (whose
    `jax.image.resize(..., "nearest")` is torch's "nearest-exact", also at the non-integer ratio 13 / 5)."""
    rng = np.random.default_rng(5)
    a = tuple(rng.standard_normal((2, src, src, c)).astype(np.float32) for c in (6, 8))
    b = tuple(rng.standard_normal((2, src, 2 * src, 8)).astype(np.float32) for _ in range(3))
    t = rng.standard_normal((2, dst, 2 * dst, 8)).astype(np.float32)
    idx = (1, 2)
    ref = np.asarray(JM.CBFuse(idx).apply({}, [tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)),
                                                jnp.asarray(t)]))
    with torch.no_grad():
        got = TM.CBFuse(idx)([tuple(map(_nchw, a)), tuple(map(_nchw, b)), _nchw(t)]).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == t.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# -- the graphs -----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(V9))
def test_yaml_builds_like_jax(name):
    """`YOLO(<name>)` on the meta device: the YAML is the JAX package's byte for byte and resolves by its name (no
    scale letter: `guess_model_scale` reads none); the JAX specs and save list; strides (8, 16, 32); the JAX
    graph's parameter count; the port's variable tree equal to the JAX graph's (RepConv's conv1 / conv2 / bn,
    CBLinear's biased conv, RepNCSPELAN4's cv2.0 ... cv3.1 under the bridge's names); no layer left out of an
    eval forward (every CBLinear feeds a CBFuse); the conv3x3 sites a folded forward runs (RepNCSPELAN4's
    4n + 2 each, RepConvs folded, and the Detect towers' 12)."""
    cfg, count, sites = V9[name]
    assert (PORT_CFG / cfg).read_bytes() == (JAX_CFG / cfg).read_bytes()
    assert TC.guess_model_scale(name) == ""
    yolo = YOLO(name, device="meta", seed=None)
    tm = yolo.model
    assert Path(yolo.model_yaml["yaml_file"]) == PORT_CFG / cfg
    assert yolo.task == "v8" and tm.strides == (8.0, 16.0, 32.0) and not tm.dead
    assert sum(p.numel() for p in tm.parameters()) == count
    specs, save = TC.parse_model(yolo.model_yaml)
    jspecs, jsave = JC.parse_model(yolo.model_yaml)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    shapes = jax_shapes(jax_graph(yolo.model_yaml, tm.strides))
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                         jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda t: isinstance(t, tuple))}
    port_shapes = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        assert flat(port_shapes[col]) == flat(shapes[col])
    assert len(conv3x3_sites(tm)) == sites
    assert all(isinstance(m, (TM.RepConv, TM.ConvBN)) for m in conv3x3_sites(tm))
    reps = [m for m in tm.modules() if isinstance(m, TM.RepConv)]
    assert reps and all(m.bn is None and m.kernel_path for m in reps)  # RepBottleneck's: no identity branch
    readers = frame_readers(tm)
    if name == "yolov9e.yaml":  # layer 0 is Silence: layers 1 and 15 read the frame
        assert specs[0].module == "Silence" and readers == [tm.model[1], tm.model[15]]
    else:
        assert readers == [tm.model[0]]


def test_yaml_repconv_keeps_its_identity():
    """A YAML-level `RepConv` takes the JAX default use_identity=True (JAX `compiler.py:647-648`): with c1 == c2
    and stride 1 it has the identity BN; the parse and the variable tree equal the JAX graph's."""
    d = {"nc": 2, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "RepConv", [16, 3, 1]],
                               [-1, 1, "RepConv", [32, 3, 2]]],
         "head": [[[0, 1, 2], 1, "Detect", ["nc"]]]}
    tm = build_model(d, device="cpu")
    assert tm.model[1].bn is not None and tm.model[2].bn is None
    specs, save = TC.parse_model(d)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in JC.parse_model(d)[0]]
    shapes = jax_shapes(jax_graph(d, tm.strides))
    assert flax_shapes(tm)["params"]["model_1"].keys() == shapes["params"]["model_1"].keys() == {"bn", "conv1",
                                                                                                 "conv2"}


# -- the narrow copies against the JAX graph ------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(V9))
def test_narrow_forward_and_predict_match_jax(name):
    """A narrow copy (channel args >= 64 divided by 8, nc 3) at 64 px, batch 2, f32, against the JAX graph on the
    same weights: the eval forward's decoded boxes within 1e-3 px and scores within 1e-6; `predict` through the
    NMS at conf 0.25 / iou 0.45, unfolded and through `serving_model` (every RepConv folded into one conv3x3
    site, /255 folded into each conv that reads the frame: layer 0 of yolov9c, layers 1 and 15 of yolov9e,
    through `Silence`; fed the 0..255 frame), against the JAX pred of the /255 frame through the JAX NMS: as many
    rows, each matched tie-tolerantly (box 1e-3, score 1e-6)."""
    cfg, _, sites = V9[name]
    d = narrow_v9(cfg)
    tm = build_model(d, device="cpu")
    variables = random_variables(flax_shapes(tm), seed=1)
    load_flax(tm, variables)
    jm = jax_graph(d, tm.strides)
    frames = np.random.default_rng(3).integers(0, 256, (2, S, S, 3)).astype(np.float32)
    x = frames / np.float32(255)
    ref = jax_eval(jm, variables, jnp.asarray(x))["pred"]
    with torch.no_grad():
        pred = TC.decode_feats(tm(_nchw(x)), tm.strides, tm.nc, tm.reg_max).numpy()
    assert pred.shape == ref.shape == (2, 84, 4 + 3)
    np.testing.assert_allclose(pred[..., :4], ref[..., :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(pred[..., 4:], ref[..., 4:], rtol=0, atol=1e-6)
    want = np.asarray(jax_nms(jnp.asarray(ref), 0.25, 0.45, 300))
    serving = serving_model(tm, torch.device("cpu"), torch.float32)
    assert len(conv3x3_sites(serving)) == sites and all(m.folded is not None for m in conv3x3_sites(serving))
    assert len(frame_readers(serving)) == (2 if name == "yolov9e.yaml" else 1)
    with torch.no_grad():
        dets = [tm.predict(_nchw(x)), serving.predict(_nchw(frames))]
    for det in dets:
        det = det.numpy()
        for i in range(2):
            n = int((want[i, :, 5] >= 0).sum())
            assert n >= 3 and int((det[i, :, 5] >= 0).sum()) == n
            assert_detections_close(det[i, :n], want[i, :n], atol_box=1e-3, atol_score=1e-6)
