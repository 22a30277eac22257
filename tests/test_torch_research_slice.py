"""LPC-YOLO with its layer-21 CBAM replaced by a research-zoo attention module, end to end against the JAX package,
and reference-layout `.pt` checkpoints, on the CPU in f32.

The graphs are narrow (LPC-YOLO's layers at width 0.25: 32 channels at layer 21, where the published `s` width
has 64), nc 4, imgsz 64, batch 2, weights from `random_variables` of JAX `eval_shape`'s tree. Detections are
compared tie-tolerantly (`utils/compare.py`): scores within 1e-5, boxes within 1e-3. The train step of the GAM
variant (two grouped 7x7 CBAs with BatchNorm inside the module) is held as `tests/test_torch_train.py` holds
LPC-YOLO's, with its tolerances: JAX's first step (lr 0) leaves the clipped gradient in the momentum trace, held
to the port's f64 run (the port's f32 trace within 5e-4, JAX's within 1e-2, floor 1e-5); its second step, taken
by both from the JAX state carried across the bridge, gives items within 1e-4, params and EMA within 2e-4,
momentum within 1e-2 and BN statistics within 5e-5. A `.pt` is written in the reference trainer's layout (the
fp16 module under `model` with `ema` None, as `strip_optimizer` leaves it; or under `ema`, `model` then holding
other weights) and read by both facades; the JAX one is built with `_jit_init` replaced by `eval_shape`, whose
every leaf `port_state_dict` fills.
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
from lpc_yolo_tpu.nn import build_model as jax_build

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch import cfg as tcfg
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.engine.predictor import serving_model
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import research as TR
from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_to_state_dict, load_flax, random_variables, train_state_from_flax

B, S = 2, 64
XLA_OPTS = {"xla_disable_hlo_passes": "fusion"}
CFG = dict(warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def narrow_cfg(m=None) -> dict:
    """LPC-YOLO at width 0.25 (nc 4), with `m` at layer 21, or as published."""
    d = TR.lpc_attention_cfg(m) if m else yaml.safe_load(TR.LPC_YAML.read_text())
    d.update(nc=4, scales={"t": [0.33, 0.25, 512]}, scale="t")
    return d


def jax_pair(d: dict, seed: int = 0):
    jm = jax_build(d)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))
    variables = random_variables(shapes, seed)
    tm = load_flax(build_model(d, device="cpu"), variables)
    return jm, variables, tm


def frames(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for shape in ((64, 48, 3), (80, 60, 3))]


@pytest.mark.parametrize("m", ["SKAttention", "ParNetAttention", "CrissCrossAttention"])
def test_predict_matches_the_jax_graph(m):
    """The JAX graph's eval-mode detections (the v10 top-k) against the port's, unfolded and on the BN-folded
    serving copy (the raw 0..255 frame, /255 in the stem), whose conv3x3 sites include SKAttention's `conv_1` and
    ParNetAttention's `conv3x3` (a conv bias folded in). GAMAttention's graph is held through the `.pt` test below,
and every variant's module in `tests/test_torch_research.py`."""
    d = narrow_cfg(m)
    jm, variables, tm = jax_pair(d)
    x = np.random.default_rng(8).random((B, S, S, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, training=False, predict_only=True)["det"])(
        variables, jnp.asarray(x)))  # jitted: op by op, the JAX graph takes ~20 s more
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    serving = serving_model(tm, torch.device("cpu"), torch.float32)
    with torch.no_grad():
        got = tm.predict(xt).numpy()
        folded = serving.predict(xt * 255.0).numpy()
    attn_sites = [c for c in conv3x3_sites(tm.model[TR.LPC_ATTENTION_LAYER])]
    assert len(attn_sites) == (m in ("SKAttention", "ParNetAttention"))
    assert all(c.folded is not None for c in serving.model[TR.LPC_ATTENTION_LAYER].modules() if isinstance(c, TR.CBA))
    assert got.shape == ref.shape == (B, 300, 6)
    for i in range(B):
        assert_detections_close(got[i], ref[i], atol_box=1e-3, atol_score=1e-5)
        assert_detections_close(folded[i], ref[i], atol_box=1e-3, atol_score=1e-5)


# -- reference-layout .pt checkpoints ----------------------------------------------------------------------------


def write_reference_pt(tmp_path, m, layout: str):
    """A narrow model (seed 0) written as a reference `.pt`; with layout "ema" the `model` key holds other
    weights (seed 1), so a loader that reads the wrong key shows. Returns (path, the seed-0 state rounded to
    fp16)."""
    path = tmp_path / f"yolov10-{m or 'LPC'}-{layout}.yaml"
    path.write_text(yaml.safe_dump(narrow_cfg(m)))
    yolo = YOLO(path, device="cpu", seed=0)
    pt = yolo.save_pt(tmp_path / f"{path.stem}.pt", ema=layout == "ema")
    ckpt = torch.load(pt, map_location="cpu", weights_only=False)
    held = ckpt["ema"] if layout == "ema" else ckpt["model"]
    assert (ckpt["ema"] is None) == (layout == "model") and held.model[0].conv.weight.dtype == torch.float16
    assert held.yaml["head"] == narrow_cfg(m)["head"] and held.names == yolo.names
    assert "model.28.dfl.conv.weight" in held.state_dict()
    if layout == "ema":
        other = copy.deepcopy(held)
        other.load_state_dict(YOLO(path, device="cpu", seed=1).model.half().state_dict(), strict=False)
        ckpt["model"] = other
        torch.save(ckpt, pt)
    rounded = {k: v.half().float() for k, v in yolo.model.state_dict().items()}
    return pt, rounded


@pytest.mark.parametrize("m", [None, "GAMAttention"], ids=["LPC", "GAMAttention"])
@pytest.mark.parametrize("layout", ["model", "ema"])
def test_pt_loads_through_both_facades(tmp_path, monkeypatch, m, layout):
    """`YOLO(x.pt)` of the port and of the JAX package on the same file: the port's weights are the written
    ones rounded to fp16, its task "v10" and its names the file's, and both facades' detections agree."""
    import lpc_yolo_tpu.engine.model as jax_model

    pt, rounded = write_reference_pt(tmp_path, m, layout)
    port = YOLO(pt, device="cpu")
    assert port.task == "v10" and port.names == {i: str(i) for i in range(4)}
    got = port.model.state_dict()
    assert got.keys() == rounded.keys() and all(torch.equal(got[k], rounded[k]) for k in got)
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True)))
    jy = jax_model.YOLO(pt)
    assert jy.task == "v10" and jy.names == port.names
    ref = jy.predict(frames(9), imgsz=S, conf=0.0, batch=2)
    results = port.predict(frames(9), imgsz=S, conf=0.0, batch=2, device="cpu")
    for r, j in zip(results, ref):
        assert len(r) > 0
        assert_detections_close(r.boxes.data, np.asarray(j.boxes.data), atol_box=1e-3, atol_score=1e-5)


def test_pt_refuses_a_model_it_does_not_fit(tmp_path):
    """A state_dict with a key the model lacks, or without one it has, raises naming the keys."""
    from lpc_yolo_tpu_torch.utils.pt_checkpoint import load_pt_state

    tm = build_model(narrow_cfg("SE"), device="cpu")
    state = dict(tm.state_dict())
    state.pop("model.21.l1.weight")
    with pytest.raises(KeyError, match="model.21.l1.weight"):
        load_pt_state(tm, state)
    state = {**tm.state_dict(), "model.21.extra": torch.zeros(1)}
    with pytest.raises(KeyError, match="model.21.extra"):
        load_pt_state(tm, state)


def test_cli_predicts_from_a_pt(tmp_path):
    """`yolo predict model=<x>.pt` builds the model from the file and gives `YOLO(x.pt).predict`'s results."""
    from PIL import Image

    pt, _ = write_reference_pt(tmp_path, "SKAttention", "model")
    src = tmp_path / "src"
    src.mkdir()
    for i, im in enumerate(frames(11)):
        Image.fromarray(im[..., ::-1]).save(src / f"{i}.png")
    results = tcfg.entrypoint(["predict", f"model={pt}", f"source={src}", f"imgsz={S}", "conf=0", "save=False",
                               "device=cpu"])
    ref = YOLO(pt, device="cpu").predict(str(src), imgsz=S, conf=0.0)
    assert len(results) == len(ref) == 2
    for a, b in zip(results, ref):
        assert a.path == b.path and len(a) > 0
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)


# -- one train step of the GAM variant (last: its JAX step compiles while the tests above run) -----------------


def make_batch(seed: int) -> dict:
    """A batch as the JAX step takes it in f32: RGB frames in [0, 1], padded gts."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 30, (B, 4, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (B, 4, 2))], -1).astype(np.float32)
    mask = np.array([[True, True, True, False], [True, False, False, False]])
    return {"img": rng.random((B, S, S, 3), dtype=np.float32), "cls": rng.integers(0, 4, (B, 4)).astype(np.int32),
            "bboxes": boxes * mask[..., None], "mask": mask}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_named_close(named, ref, tol, what, floor=0.0):
    assert named.keys() == ref.keys()
    for k, t in named.items():
        r = ref[k].detach().double().numpy()
        np.testing.assert_allclose(t.detach().double().numpy(), r, rtol=0, atol=tol * np.abs(r).max() + floor,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module", autouse=True)
def gam_world(one_torch_thread):
    """The narrow GAM variant's JAX train step, lowered here and compiled with XLA's fusion pass off in a
    thread while the tests before the step tests run (XLA compiles outside the interpreter lock)."""
    d = narrow_cfg("GAMAttention")
    jm, variables, _ = jax_pair(d)
    jcfg = jts.OptConfig(**CFG)
    state0, tx = jts.init_train_state(jm, variables, jcfg)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="v10").__wrapped__
    lowered = jax.jit(raw).lower(state0, make_batch(0))
    with ThreadPoolExecutor(1) as pool:
        compiling = pool.submit(lowered.compile, compiler_options=XLA_OPTS)
        yield {"yaml": d, "variables": variables, "state0": state0, "step": compiling.result}


@pytest.fixture(scope="module")
def gam_steps(gam_world):
    """JAX's two steps of the GAM variant, on batches 0 and 1."""
    step = gam_world["step"]()
    state1, met1 = step(gam_world["state0"], make_batch(0))
    state2, met2 = step(state1, make_batch(1))
    return {**gam_world, "states": (state1, state2), "mets": (met1, met2)}


def first_trace(w, dtype, cfg):
    """The port's loss on batch 0 and what one update from zero momentum leaves in the trace."""
    tm = load_flax(build_model(w["yaml"], device="cpu"), w["variables"]).to(dtype).train()
    batch = tts.to_device(make_batch(0), torch.device("cpu"))
    batch["img"] = batch["img"].to(dtype)
    total, items = tts.make_loss_fn(tm)(batch)
    total.backward()
    named = dict(tm.named_parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in named.values()]
    gnorm = tts.global_norm(grads)
    decay = tts.decayed(tuple((k, tuple(p.shape)) for k, p in named.items()))
    trace = {k: g * (cfg.grad_clip / gnorm.clamp(min=cfg.grad_clip)) + (cfg.weight_decay * p if i in decay else 0)
             for i, ((k, p), g) in enumerate(zip(named.items(), grads))}
    return total.detach(), items, trace


def test_gam_variant_first_step_matches_jax(gam_steps):
    cfg = tts.OptConfig(**CFG)
    (state1, _), (met1, _) = gam_steps["states"], gam_steps["mets"]
    total, items, t32 = first_trace(gam_steps, torch.float32, cfg)
    _, _, t64 = first_trace(gam_steps, torch.float64, cfg)
    np.testing.assert_allclose(float(total), float(met1["loss"]), rtol=1e-4)
    np.testing.assert_allclose(items.numpy(), np.asarray(met1["items"]), rtol=1e-4)
    ref = flax_to_state_dict({"params": np_tree(state1.opt_state[2].inner_state.trace)})
    assert any(k.startswith("model.21.sa1.") for k in ref)
    assert_named_close(t32, t64, 5e-4, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)


def test_gam_variant_second_step_from_the_bridged_state_matches_jax(gam_steps):
    cfg = tts.OptConfig(**CFG)
    (state1, state2), (_, met2) = gam_steps["states"], gam_steps["mets"]
    tm = build_model(gam_steps["yaml"], device="cpu")
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
    assert any(k.startswith("model.21.sa2.bn.") for k in tstate.batch_stats)
    for k, v in tstate.batch_stats.items():
        np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-5, atol=5e-5, err_msg=k)
