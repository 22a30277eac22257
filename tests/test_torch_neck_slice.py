"""LPC-YOLO with the research zoo's neck blocks (`nn/research.py::lpc_neck_cfg`) end to end against the JAX package,
on the CPU in f32.

The graphs are narrow (LPC-YOLO's layers at width 0.25), nc 4, imgsz 64, batch 2, weights from `random_variables` of
JAX `eval_shape`'s tree. GSConv's shuffle is the JAX interleave throughout this file (`gsconv_shuffle` swapped in the
test only, `tests/test_torch_neck.py` holds the port's own to the published forward). Detections are compared
tie-tolerantly (`utils/compare.py`): scores within 1e-5, boxes within 1e-3. The train step of one graph that holds
the slim neck (VoVGSCSP at 17/20/24/27, GSConv at 22/25), BasicRFB at 13 and ASFF3 at 28-30 is held as
`tests/test_torch_research_slice.py` holds the GAM variant's, with its tolerances: JAX's first step (lr 0) leaves the
clipped gradient in the momentum trace, held to the port's f64 run (the port's f32 trace within 5e-4, JAX's within
1e-2, floor 1e-5); its second step, taken by both from the JAX state carried across the bridge, gives items within
1e-4, params and EMA within 2e-4, momentum within 1e-2 and BN statistics within 5e-5.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.nn import build_model as jax_build

from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.engine.predictor import serving_model
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import research as TR
from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_to_state_dict, load_flax, random_variables, train_state_from_flax

from test_torch_neck import jax_interleave
from test_torch_research_slice import assert_named_close, first_trace, make_batch, np_tree

B, S = 2, 64
XLA_OPTS = {"xla_disable_hlo_passes": "fusion"}
CFG = dict(warmup_steps=2, total_steps=10)
# conv3x3 sites a narrow eval forward runs: LPC-YOLO's 28 less what a variant takes out, plus its blocks' own
FORWARD_SITES = {"slimneck": 25, "rfb": 32, "asff3": 31, "FGFP": 30, "combined": 32}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_interleave_in_gsconv():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR, "gsconv_shuffle", jax_interleave)
        yield


def narrow(d: dict) -> dict:
    d.update(nc=4, scales={"t": [0.33, 0.25, 512]}, scale="t")
    return d


def combined_cfg() -> dict:
    """The slim neck, BasicRFB at layer 13 and ASFF3 before the head, in one graph (layers 0 to 27 from the slimneck
    variant but 13 from the rfb one, the head's from asff3's)."""
    d, slim, rfb = (TR.lpc_neck_cfg(v) for v in ("asff3", "slimneck", "rfb"))
    nb = len(d["backbone"])
    d["backbone"] = [*slim["backbone"][:13], rfb["backbone"][13], *slim["backbone"][14:]]
    d["head"] = [*slim["head"][:28 - nb], *d["head"][28 - nb:]]
    return d


def jax_pair(d: dict, seed: int = 0):
    jm = jax_build(d)
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


@pytest.mark.parametrize("v", ["slimneck", "rfb", "asff3", "FGFP"])
def test_predict_matches_the_jax_graph(v):
    """The JAX graph's eval-mode detections (the v10 top-k) against the port's, unfolded and on the BN-folded serving
    copy (the raw 0..255 frame, /255 in the stem), whose conv3x3 sites include the variant's: GSBottleneck's
    `gs2.cv1`, RFB's undilated 3x3s, ASFF's `conv`, FGFP's biased refines."""
    jm, variables, tm = jax_pair(narrow(TR.lpc_neck_cfg(v)))
    x = np.random.default_rng(8).random((B, S, S, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, training=False, predict_only=True)["det"])(
        variables, jnp.asarray(x)))  # jitted: op by op, the JAX graph takes ~20 s more
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


# -- one train step of the combined graph (last: its JAX step compiles while the tests above run) ------------------


@pytest.fixture(scope="module", autouse=True)
def neck_world(one_torch_thread):
    """The narrow combined graph's JAX train step, lowered here and compiled with XLA's fusion pass off in a thread
    while the tests before the step tests run (XLA compiles outside the interpreter lock)."""
    d = narrow(combined_cfg())
    jm, variables, _ = jax_pair(d)
    jcfg = jts.OptConfig(**CFG)
    state0, tx = jts.init_train_state(jm, variables, jcfg)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="v10").__wrapped__
    lowered = jax.jit(raw).lower(state0, make_batch(0))
    with ThreadPoolExecutor(1) as pool:
        compiling = pool.submit(lowered.compile, compiler_options=XLA_OPTS)
        yield {"yaml": d, "variables": variables, "state0": state0, "step": compiling.result}


@pytest.fixture(scope="module")
def neck_steps(neck_world):
    """JAX's two steps of the combined graph, on batches 0 and 1."""
    step = neck_world["step"]()
    state1, met1 = step(neck_world["state0"], make_batch(0))
    state2, met2 = step(state1, make_batch(1))
    return {**neck_world, "states": (state1, state2), "mets": (met1, met2)}


def test_combined_graph_holds_the_blocks():
    tm = build_model(narrow(combined_cfg()), device="meta")
    names = [type(m).__name__ for m in tm.model]
    assert names[13] == "BasicRFB" and names[17] == names[20] == names[24] == names[27] == "VoVGSCSP"
    assert names[22] == names[25] == "GSConv" and names[28:31] == ["ASFF3"] * 3 and names[31] == "V10Detect"
    x = torch.rand(1, 3, S, S)
    assert forward_sites(serving_model(build_model(narrow(combined_cfg()), device="cpu"), torch.device("cpu"),
                                       torch.float32), x) == FORWARD_SITES["combined"]


def test_combined_first_step_matches_jax(neck_steps):
    cfg = tts.OptConfig(**CFG)
    (state1, _), (met1, _) = neck_steps["states"], neck_steps["mets"]
    total, items, t32 = first_trace(neck_steps, torch.float32, cfg)
    _, _, t64 = first_trace(neck_steps, torch.float64, cfg)
    np.testing.assert_allclose(float(total), float(met1["loss"]), rtol=1e-4)
    np.testing.assert_allclose(items.numpy(), np.asarray(met1["items"]), rtol=1e-4)
    ref = flax_to_state_dict({"params": np_tree(state1.opt_state[2].inner_state.trace)})
    assert any(k.startswith("model.28.up2.cv1.") for k in ref) and any(k.startswith("model.13.b2.") for k in ref)
    assert_named_close(t32, t64, 5e-4, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)


def test_combined_second_step_from_the_bridged_state_matches_jax(neck_steps):
    cfg = tts.OptConfig(**CFG)
    (state1, state2), (_, met2) = neck_steps["states"], neck_steps["mets"]
    tm = build_model(neck_steps["yaml"], device="cpu")
    tstate = train_state_from_flax(tm, cfg, np_tree(state1.params), np_tree(state1.batch_stats),
                                   np_tree(state1.opt_state[2].inner_state.trace), np_tree(state1.ema_params),
                                   step=int(state1.step), ema_updates=float(state1.ema_updates), device="cpu")
    tstate, tmet = tts.make_train_step(tm, cfg)(tstate, make_batch(1))
    assert tmet["skipped"] is False and not bool(met2["skipped"]) and tmet["lr"] > 0
    np.testing.assert_allclose(float(tmet["loss"]), float(met2["loss"]), rtol=1e-4)
    np.testing.assert_allclose(tmet["items"].numpy(), np.asarray(met2["items"]), rtol=1e-4)
    params = flax_to_state_dict({"params": np_tree(state2.params)})
    assert_named_close(tstate.params, params, 2e-4, "param")
    assert_named_close(tstate.ema_params, flax_to_state_dict({"params": np_tree(state2.ema_params)}), 2e-4, "EMA")
    assert_named_close(tstate.momentum, flax_to_state_dict({"params": np_tree(state2.opt_state[2].inner_state.trace)}),
                       1e-2, "momentum", floor=1e-6)
    stats = flax_to_state_dict({"batch_stats": np_tree(state2.batch_stats)})
    assert any(k.startswith("model.27.gsb.0.") for k in tstate.batch_stats)
    for k, v in tstate.batch_stats.items():
        np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-5, atol=5e-5, err_msg=k)
