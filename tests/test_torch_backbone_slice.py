"""LPC-YOLO with a backbone family of the research zoo (`nn/research.py::lpc_backbone_cfg`) end to end against the JAX
package, on the CPU in f32.

The graphs are narrow (width 0.25), nc 4, imgsz 64, batch 2, weights from `random_variables` of JAX `eval_shape`'s
tree. SGBlock's ReLU6 is the JAX "relu6" ConvBN's identity throughout this file (`SANDGLASS_ACT` swapped in the test
only; `tests/test_torch_backbone.py` holds the port's own to the published block). Detections are compared
tie-tolerantly (`utils/compare.py`): scores within 1e-5, boxes within 1e-3. All twelve variants serve and round-trip a
`.pt` in the port alone. The train step of one graph that holds
all 23 backbone-family modules (`combined_rows`) before LPC-YOLO's SPPF, PSA, neck and head is held as
`tests/test_torch_research_slice.py` holds the GAM variant's, with its tolerances: JAX's first step (lr 0) leaves the
clipped gradient in the momentum trace, held to the port's f64 run (the port's f32 trace within 5e-4, JAX's within
1e-2, floor 1e-5); its second step, taken by both from the JAX state carried across the bridge, gives params and
EMA within 2e-4, momentum within 1e-2 and BN statistics within 5e-5. The loss items of both steps are held to the
port's f64 run as the traces are (`assert_items_close`): this graph's f32 items part by up to 2.4e-4 from it in JAX.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.nn import compiler as JC

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.engine.predictor import serving_model
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import research as TR
from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites, fold_preprocess, fuse_conv_bn
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_to_state_dict, load_flax, random_variables, train_state_from_flax

from test_torch_research_slice import assert_named_close, first_trace, make_batch, np_tree

B, S = 2, 64
XLA_OPTS = {"xla_disable_hlo_passes": "fusion"}
CFG = dict(warmup_steps=2, total_steps=10)
# conv3x3 sites a narrow eval forward runs: LPC-YOLO's neck and head (12; its backbone's 16 are gone) plus the
# family's own (FasterNet's 13 partial convs; the combined graph's Conv_BN_HSwish, mn_conv and BasicStage ones)
FORWARD_SITES = {"swin": 12, "fasternet": 25, "mobilenetv3": 12, "combined": 15}
VARIANTS = sorted(TR.BACKBONE_VARIANTS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_sandglass():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR, "SANDGLASS_ACT", "none")
        yield


def narrow(d: dict) -> dict:
    d.update(nc=4, scales={"t": [0.33, 0.25, 512]}, scale="t")
    return d


def combined_rows():
    """Every backbone-family module in one stride-32 backbone (at 64 px: 8 x 8 from layer 1 to 9, 4 x 4 from 10 to
    19, 2 x 2 after), the stride-8 read at layer 9 and the stride-16 one at 19; stems of stride 1 where the module
    takes one, Swin's window 3 over an 8 x 8 map (padded to 9, the second block shifted)."""
    return [
        [-1, 1, "stem", [32]], [-1, 1, "CBRM", [64]], [-1, 1, "ConvNeXt_Stem", [64, 1, 1]],
        [-1, 1, "PatchEmbed", [64, 1]], [-1, 1, "SwinStage", [64, 2, 2, 3]], [-1, 1, "ConvNeXt_Block", [64]],
        [-1, 1, "ConvNeXt_Downsample", [64, 1, 1]], [-1, 1, "VanillaBlock", [64, 3, 1]], [-1, 1, "StarBlock", [3]],
        [-1, 1, "BasicStage", [1]],
        [-1, 1, "PatchMerging", [128]], [-1, 1, "PatchEmbed_FasterNet", [128, 1, 1]],
        [-1, 1, "Conv_BN_HSwish", [128, 1]], [-1, 1, "MobileNetV3_InvertedResidual", [128, 64, 3, 1, 1, 1]],
        [-1, 1, "mn_conv", [128, 3, 1, "HS"]], [-1, 1, "InvertedBottleneck", [128, 3, 64, "None", "RE", 1]],
        [-1, 1, "G_bneck", [128, 64, 3, 1, True]], [-1, 1, "SGBlock", [128, 1, 6]],
        [-1, 1, "DepthSepConv", [128, 3, 1, True]], [-1, 1, "MBConvBlock", [128, 3, 1, 6, 0.0, True]],
        [-1, 1, "PatchMerging_FasterNet", [256, 2, 2]], [-1, 1, "MobileNetV3_BLOCK", [256, 3, 128, "None", "HS", 1]],
        [-1, 1, "Shuffle_Block", [256, 1]]]


def combined_cfg() -> dict:
    return narrow(TR.lpc_cfg_with_backbone(combined_rows(), 9, 19))


def jax_pair(d: dict, seed: int = 0):
    """The JAX graph, its seeded variables and the port's graph on them. The JAX graph is the package's
    DetectionModel built with its strides given (8, 16, 32, as the port's probe finds them), which is what its
    `build_model` returns after a stride probe of a few seconds."""
    specs, save = JC.parse_model(dict(d))
    jm = JC.DetectionModel(specs=specs, save=save, nc=d["nc"], strides=(8.0, 16.0, 32.0), dtype=jnp.float32)
    assert build_model(d, device="meta").strides == (8.0, 16.0, 32.0)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))
    variables = random_variables(shapes, seed)
    tm = load_flax(build_model(d, device="cpu"), variables)
    return jm, variables, tm


def forward_sites(model, x) -> int:
    calls = []
    hooks = [m.register_forward_pre_hook(lambda *a: calls.append(1)) for m in conv3x3_sites(model)]
    with torch.no_grad():
        model.predict(x)
    for h in hooks:
        h.remove()
    return len(calls)


@pytest.mark.parametrize("v", ["swin", "fasternet", "mobilenetv3"])
def test_predict_matches_the_jax_graph(v):
    """The JAX graph's eval-mode detections (the v10 top-k) against the port's, unfolded and on the BN-folded serving
    copy (the raw 0..255 frame, /255 in the stem's `frame_conv`: Swin's and FasterNet's patch embeddings,
    MobileNetV3's hard-swish stem), whose conv3x3 sites include FasterNet's partial convs."""
    jm, variables, tm = jax_pair(narrow(TR.lpc_backbone_cfg(v)))
    x = np.random.default_rng(8).random((B, S, S, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, training=False, predict_only=True)["det"])(
        variables, jnp.asarray(x)))  # jitted: Swin's windows take ~40 s op by op
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    serving = serving_model(tm, torch.device("cpu"), torch.float32)
    with torch.no_grad():
        got = tm.predict(xt).numpy()
        folded = serving.predict(xt * 255.0).numpy()
    assert forward_sites(serving, xt) == FORWARD_SITES[v]
    assert got.shape == ref.shape == (B, 300, 6)
    for i in range(B):
        assert_detections_close(got[i], ref[i], atol_box=1e-3, atol_score=1e-5)
        assert_detections_close(folded[i], ref[i], atol_box=1e-3, atol_score=1e-5)


@pytest.mark.parametrize("v", VARIANTS)
def test_variant_serves_and_round_trips_a_pt(tmp_path, v):
    """Every variant, narrow, in the port alone: its serving copy (BN folded, /255 in the stem's `frame_conv`)
    predicts what the unfolded model predicts on the same frame, and the graph round-trips through a reference-layout
    `.pt` (`YOLO.save_pt`): its weights come back as written, rounded to fp16, and it predicts."""
    path = tmp_path / f"yolov10-bb-{v}.yaml"
    path.write_text(yaml.safe_dump(narrow(TR.lpc_backbone_cfg(v))))
    yolo = YOLO(path, device="cpu", seed=0)
    x = torch.rand(2, 3, 64, 64)
    serving = fold_preprocess(fuse_conv_bn(copy.deepcopy(yolo.model).eval()))
    with torch.no_grad():
        ref = yolo.model.eval().predict(x)
        got = serving.predict(x * 255.0)
    np.testing.assert_allclose(got[..., 4].numpy(), ref[..., 4].numpy(), rtol=0, atol=1e-4)
    pt = yolo.save_pt(tmp_path / f"{path.stem}.pt")
    loaded = YOLO(pt, device="cpu")
    names = {row[2] for row in TR.BACKBONE_VARIANTS[v]["rows"]} - {"Conv"}
    assert {type(m).__name__ for m in loaded.model.model} >= names and loaded.task == "v10"
    got, ref = loaded.model.state_dict(), yolo.model.state_dict()
    assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k].half().float()) for k in got)
    frame = np.random.default_rng(10).integers(0, 256, (64, 48, 3), dtype=np.uint8)
    results = loaded.predict([frame], imgsz=64, conf=0.0, device="cpu")
    assert len(results[0]) > 0 and np.isfinite(results[0].boxes.data).all()


# -- one train step of the combined graph (last: its JAX step compiles while the tests above run) ------------------


@pytest.fixture(scope="module", autouse=True)
def backbone_world(one_torch_thread, jax_sandglass):
    """The narrow combined graph's JAX train step, lowered here and compiled with XLA's fusion pass off in a thread
    while the tests before the step tests run (XLA compiles outside the interpreter lock)."""
    d = combined_cfg()
    jm, variables, _ = jax_pair(d)
    jcfg = jts.OptConfig(**CFG)
    state0, tx = jts.init_train_state(jm, variables, jcfg)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="v10").__wrapped__
    lowered = jax.jit(raw).lower(state0, make_batch(0))
    with ThreadPoolExecutor(1) as pool:
        compiling = pool.submit(lowered.compile, compiler_options=XLA_OPTS)
        yield {"yaml": d, "variables": variables, "state0": state0, "step": compiling.result}


@pytest.fixture(scope="module")
def backbone_steps(backbone_world):
    """JAX's two steps of the combined graph, on batches 0 and 1."""
    step = backbone_world["step"]()
    state1, met1 = step(backbone_world["state0"], make_batch(0))
    state2, met2 = step(state1, make_batch(1))
    return {**backbone_world, "states": (state1, state2), "mets": (met1, met2)}


def test_combined_graph_holds_every_module():
    tm = build_model(combined_cfg(), device="cpu")
    names = [type(m).__name__ for m in tm.model]
    assert set(names[:23]) == TR.BACKBONE and names[23:25] == ["SPPF", "PSA"] and names[-1] == "V10Detect"
    assert forward_sites(serving_model(tm, torch.device("cpu"), torch.float32), torch.rand(1, 3, S, S)) == \
        FORWARD_SITES["combined"]


def assert_items_close(port32, jax32, port64):
    """The six loss items: the port's f32 ones within 1e-4 of its f64 run, and the JAX package's within 5e-4 of it.
    This graph's 23 modules before LPC-YOLO's 2 x 2 stride-32 BatchNorms leave the JAX f32 items 2.4e-4 from the f64
    ones on the box losses, and the port's f32 ones 6e-5 (the two f32 runs can part by more than 1e-4)."""
    ref = port64.double().numpy()
    np.testing.assert_allclose(port32.double().numpy(), ref, rtol=1e-4)
    np.testing.assert_allclose(jax32, ref, rtol=5e-4)


def test_combined_first_step_matches_jax(backbone_steps):
    cfg = tts.OptConfig(**CFG)
    (state1, _), (met1, _) = backbone_steps["states"], backbone_steps["mets"]
    total, items, t32 = first_trace(backbone_steps, torch.float32, cfg)
    _, items64, t64 = first_trace(backbone_steps, torch.float64, cfg)
    np.testing.assert_allclose(float(total), float(met1["loss"]), rtol=1e-4)
    assert_items_close(items, np.asarray(met1["items"]), items64)
    ref = flax_to_state_dict({"params": np_tree(state1.opt_state[2].inner_state.trace)})
    assert any(k.startswith("model.4.blocks.1.attn.relative_position_bias_table") for k in ref)
    assert any(k.startswith("model.5.m_0_gamma") for k in ref)
    assert_named_close(t32, t64, 5e-4, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)


def test_combined_second_step_from_the_bridged_state_matches_jax(backbone_steps):
    cfg = tts.OptConfig(**CFG)
    (state1, state2), (_, met2) = backbone_steps["states"], backbone_steps["mets"]
    runs = {}
    for dtype in (torch.float32, torch.float64):
        tm = build_model(backbone_steps["yaml"], device="cpu").to(dtype)
        tstate = train_state_from_flax(tm, cfg, np_tree(state1.params), np_tree(state1.batch_stats),
                                       np_tree(state1.opt_state[2].inner_state.trace), np_tree(state1.ema_params),
                                       step=int(state1.step), ema_updates=float(state1.ema_updates), device="cpu")
        batch = tts.to_device(make_batch(1), torch.device("cpu"))
        batch["img"] = batch["img"].to(dtype)
        runs[dtype] = tts.make_train_step(tm, cfg)(tstate, batch)
    tstate, tmet = runs[torch.float32]
    assert tmet["skipped"] is False and not bool(met2["skipped"]) and tmet["lr"] > 0
    np.testing.assert_allclose(float(tmet["loss"]), float(met2["loss"]), rtol=1e-4)
    assert_items_close(tmet["items"], np.asarray(met2["items"]), runs[torch.float64][1]["items"])
    params = flax_to_state_dict({"params": np_tree(state2.params)})
    assert_named_close(tstate.params, params, 2e-4, "param")
    assert_named_close(tstate.ema_params, flax_to_state_dict({"params": np_tree(state2.ema_params)}), 2e-4, "EMA")
    assert_named_close(tstate.momentum, flax_to_state_dict({"params": np_tree(state2.opt_state[2].inner_state.trace)}),
                       1e-2, "momentum", floor=1e-6)
    stats = flax_to_state_dict({"batch_stats": np_tree(state2.batch_stats)})
    assert any(k.startswith("model.21.proj") for k in tm.state_dict()) and "model.21.bn.running_mean" in stats
    for k, v in tstate.batch_stats.items():
        np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-5, atol=5e-5, err_msg=k)
