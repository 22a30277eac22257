"""The serving slice of the port end to end against the JAX package, on the CPU.

The full LPC-YOLO YAML at full width, imgsz 64, batch 2, f32. One JAX build
is shared by the module: its variable shapes come from `jax.eval_shape`
(no init FLOPs) and are filled from a numpy seed; the port gets the same
numbers through the weight bridge.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.utils.torch_port import port_state_dict

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, load_flax, random_variables

ROOT = Path(__file__).resolve().parents[1]
YAML = "v10/yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
JAX_YAML = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / YAML
PORT_YAML = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / YAML


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(JAX_YAML)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True))
    variables = random_variables(shapes, seed=0)
    tm = build_model(PORT_YAML, device="cpu")
    load_flax(tm, variables)
    return jm, shapes, variables, tm


def _x(seed=2):
    return np.random.default_rng(seed).random((2, 64, 64, 3), dtype=np.float32)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def test_bridge_round_trip_bit_identical(pair):
    """JAX variables -> port state_dict -> JAX `port_state_dict` gives the same bits back."""
    _, _, variables, tm = pair
    back = port_state_dict(tm.state_dict(), variables)
    for col in ("params", "batch_stats"):
        flat_a = jax.tree_util.tree_leaves_with_path(variables[col])
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        assert len(flat_a) == len(flat_b)
        for path, arr in flat_a:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), arr)


def test_param_count_and_strict_load(pair):
    _, shapes, _, tm = pair
    assert sum(p.numel() for p in tm.parameters()) == 3_968_338
    assert tm.strides == (8.0, 16.0, 32.0)
    # the port's own shape tree equals the JAX one, so seeded weights agree without JAX
    port_shapes = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        a = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in jax.tree_util.tree_leaves_with_path(shapes[col])}
        b = {jax.tree_util.keystr(p): tuple(s) for p, s in
             jax.tree_util.tree_leaves_with_path(port_shapes[col], is_leaf=lambda t: isinstance(t, tuple))}
        assert a == b
    missing = tm.load_state_dict(flax_to_state_dict(random_variables(port_shapes, 0)), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys


def test_layer_specs_and_kernel_sites(pair):
    """Layer 27 is dead, the head reads (20, 23, 26) at ch (64, 192, 384), and
    28 ConvBNs per forward take the conv3x3 kernel path (30 with layer 27)."""
    from lpc_yolo_tpu_torch.nn.modules import ConvBN

    jm, _, _, tm = pair
    head = tm.specs[-1]
    assert head.f == (20, 23, 26) and head.args[-1] == (64, 192, 384)
    assert tm.specs[27].module == "C2f" and tm.specs[27].args[:2] == (384, 256)
    assert tm.dead == {27}
    assert [(s.i, s.f, s.module, s.c2) for s in tm.specs] == [(s.i, s.f, s.module, s.c2) for s in jm.specs]

    def sites(mod):
        return sum(isinstance(m, ConvBN) and m.kernel_path for m in mod.modules())

    live = sum(sites(m) for s, m in zip(tm.specs[:-1], tm.model) if s.i not in tm.dead)
    o2o = sites(tm.model[28].one2one_cv2) + sites(tm.model[28].one2one_cv3)
    assert (live, o2o, sites(tm.model[27])) == (22, 6, 2)


def test_one2one_maps_match_jax(pair):
    jm, _, variables, tm = pair
    x = _x()
    ref = jax.jit(lambda v, t: jm.apply(v, t, training=False)["one2one"])(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x), branches="one2one")["one2one"]
    for r, (box, cls) in zip(ref, got):
        g = torch.cat([box, cls], 1).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4)


def test_detections_match_jax(pair):
    jm, _, variables, tm = pair
    x = _x(3)
    ref = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, training=False, predict_only=True)["det"])(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.predict(_nchw(x)).numpy()
    assert got.shape == ref.shape == (2, 300, 6) and np.isfinite(got).all()
    for i in range(2):
        # row sets compared after a lexsort, as tests/test_models.py does: ties may permute
        sa, sb = got[i][np.lexsort(got[i].T[::-1])], ref[i][np.lexsort(ref[i].T[::-1])]
        np.testing.assert_array_equal(sa[:, 5], sb[:, 5])
        np.testing.assert_allclose(sa[:, :4], sb[:, :4], atol=1e-4, rtol=0)
        np.testing.assert_allclose(sa[:, 4], sb[:, 4], atol=1e-6, rtol=0)


def test_decode_feats_matches_jax(pair):
    """decode_feats over the one2one maps equals the JAX eval-mode 'pred'."""
    from lpc_yolo_tpu_torch.nn.heads import decode_feats

    jm, _, variables, tm = pair
    x = _x(4)
    ref = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, training=False)["pred"])(variables, jnp.asarray(x)))
    with torch.no_grad():
        pairs = tm(_nchw(x), branches="one2one")["one2one"]
        got = decode_feats([torch.cat(p, 1) for p in pairs], tm.strides, tm.nc).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_predict_matches_jax_pipeline(pair, monkeypatch):
    """YOLO(...).predict against the JAX facade's own `YOLO.predict` on the same bridged weights, at
    imgsz 64, conf 0, both feeding uint8 letterboxed frames to a stem with /255 folded in.

    Frames that need no resize (64x48, 48x64: r = 1) give byte-equal uint8 feeds: scores within 1e-6
    (tie-tolerant), boxes within 1e-3. Frames that are resized (96x128, 80x60) are not byte-equal: the
    letterbox kernel follows the TPU kernel's f32 bilinear, which is 1 LSB off cv2's fixed point on a
    share of the pixels, and those 1-LSB input steps move the scores by more than f32 rounding but, on
    these random weights, by well under 1e-5: scores within 1e-5, boxes within 1e-3. The JAX facade is
    built with its `_jit_init` replaced by the shared variables (the same weights, without compiling
    the init)."""
    import lpc_yolo_tpu.engine.model as jax_model

    _, _, variables, _ = pair
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: variables)
    jy = jax_model.YOLO("yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml")
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for shape in
              ((64, 48, 3), (48, 64, 3), (96, 128, 3), (80, 60, 3))]
    ref = jy.predict(frames, imgsz=64, conf=0.0, batch=4)
    yolo = YOLO("yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml", device="cpu", seed=None).load_flax(variables)
    results = yolo.predict(frames, device="cpu", imgsz=64, conf=0.0, batch=4)
    assert len(results) == len(ref) == 4
    for i, (r, j, im) in enumerate(zip(results, ref, frames)):
        assert r.orig_shape == im.shape[:2] and len(r) > 0
        assert set(r.speed) == {"preprocess", "inference", "postprocess"}
        atol_score = 1e-6 if i < 2 else 1e-5
        assert_detections_close(r.boxes.data, np.asarray(j.boxes.data), atol_box=1e-3, atol_score=atol_score)


def test_seeded_yolo_equals_bridged_weights(pair):
    """YOLO(seed=0) builds the same weights the JAX package gets from seed 0."""
    _, _, _, tm = pair
    y = YOLO("yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml", device="cpu", seed=0)
    a, b = y.model.state_dict(), tm.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_boxes_match_jax():
    """The port's Boxes reads the same columns and geometry as the JAX package's."""
    from lpc_yolo_tpu.engine.results import Boxes as JaxBoxes

    from lpc_yolo_tpu_torch import Boxes

    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 50, (7, 2))
    data = np.concatenate([xy, xy + rng.uniform(1, 30, (7, 2)), rng.random((7, 1)), rng.integers(0, 80, (7, 1))], 1)
    a, b = Boxes(data, (60, 80)), JaxBoxes(data, (60, 80))
    for got, ref in ((a, b), (a[2:5], b[2:5]), (a[3], b[3])):
        assert len(got) == len(ref)
        for attr in ("xyxy", "xywh", "xyxyn", "xywhn", "conf", "cls"):
            np.testing.assert_array_equal(getattr(got, attr), getattr(ref, attr))


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLO("yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(PORT_YAML)


def test_import_hygiene():
    """Importing the port (the validation and training-data modules too), building the model and
    rendering a training sample pulls in no jax, flax, optax or JAX package module."""
    code = (
        "import sys, lpc_yolo_tpu_torch as p\n"
        "import lpc_yolo_tpu_torch.data, lpc_yolo_tpu_torch.engine.validator, lpc_yolo_tpu_torch.engine.trainer\n"
        "import lpc_yolo_tpu_torch.data.cvops, lpc_yolo_tpu_torch.data.augment, lpc_yolo_tpu_torch.data.synthetic\n"
        "import lpc_yolo_tpu_torch.utils.metrics, lpc_yolo_tpu_torch.utils.cocoeval, lpc_yolo_tpu_torch.nn.fuse\n"
        "import numpy as np, tempfile\n"
        "from lpc_yolo_tpu_torch.data import YOLODataset, TrainTransforms, check_det_dataset, make_synthetic_dataset\n"
        "tmp = tempfile.TemporaryDirectory()\n"
        "info = check_det_dataset(make_synthetic_dataset(tmp.name, n_train=2, n_val=1, imgsz=32))\n"
        "ds = YOLODataset(info['train'], cache=False, cache_images='disk')\n"
        "TrainTransforms(32)(ds, 0, np.random.RandomState(0))\n"
        "tmp.cleanup()\n"
        "p.YOLO('yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml', device='cpu', nc=3)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'lpc_yolo_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]
