"""The facade's remainder (`embed`, `fuse`, `n_params`, `reset_weights`, `device`, `task_map`) against the JAX
`YOLO`, on the CPU.

A narrow LPC-YOLO (the YAML's layers at widths 8-32, nc 3) with the same seeded weights in both packages. The
JAX facades are made without their `__init__` (which would compile an init): `embed`, `fuse` and `n_params`
read only the graph and the variables.

- `embed`: one L2-normalised vector an image, against the JAX `embed` at f32 within rtol 1e-4 (and 1e-6
  absolute), on frames of three sizes at imgsz 64 and batch 2.
- `fuse`: the port's folded state equals the JAX `fuse_conv_bn` of the same variables within 1e-6 of each
  leaf's largest value, and the predictions before and after agree tie-tolerantly (`utils/compare.py`).
- `n_params` equals the JAX count; `reset_weights` draws the seeded weights again bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.engine.model import YOLO as JaxYOLO
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse_conv_bn

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_to_state_dict, random_variables

ROOT = Path(__file__).resolve().parents[1]
PORT_YAML = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v10" / "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
S = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("facade")
    d = yaml.safe_load(PORT_YAML.read_text())
    d.update(nc=3, scales={"t": [0.1, 0.0625, 512]}, scale="t")
    path = tmp / "narrow.yaml"
    path.write_text(yaml.safe_dump(d))
    jm = jax_build(path)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))
    variables = random_variables(shapes, seed=0)
    ref = JaxYOLO.__new__(JaxYOLO)
    ref.model, ref.variables = jm, variables
    return YOLO(path, device="cpu", seed=0), ref, path


def frames(n: int = 5):
    rng = np.random.default_rng(4)
    shapes = [(48, 80), (64, 64), (90, 70), (48, 80), (33, 64)]
    return [rng.integers(0, 256, shapes[i % len(shapes)] + (3,), dtype=np.uint8) for i in range(n)]


def test_embed_matches_jax(pair):
    port, ref, _ = pair
    ims = frames()
    got = port.embed(ims, imgsz=S, batch=2)
    want = ref.embed(ims, imgsz=S, batch=2)
    assert len(got) == len(want) == len(ims)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.ndim == 1 and g.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(g), 1.0, rtol=1e-6)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


def test_n_params_device_and_task_map_match_jax(pair):
    port, ref, _ = pair
    assert port.n_params == ref.n_params
    assert port.device == "cpu"
    assert set(port.task_map) == set(JaxYOLO.task_map.fget(ref))
    assert all(set(v) == {"trainer", "validator", "predictor"} for v in port.task_map.values())


def test_fuse_matches_jax_and_keeps_the_predictions(pair):
    _, ref, path = pair
    port = YOLO(path, device="cpu", seed=0)
    ims = frames(4)
    before = port.predict(ims, imgsz=S, conf=0.0, batch=4)
    assert port.fuse() is port
    want = flax_to_state_dict(jax.tree.map(np.asarray, jax_fuse_conv_bn(ref.variables)))
    got = port.model.state_dict()
    folded = 0
    for k, w in want.items():
        g, w = got[k].detach().numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * max(np.abs(w).max(), 1e-30), err_msg=k)
        folded += k.endswith("bn.running_var") and np.allclose(w, 1 - 1e-3)
    assert folded > 10
    after = port.predict(ims, imgsz=S, conf=0.0, batch=4)
    for a, b in zip(before, after):
        assert_detections_close(a.boxes.data, b.boxes.data, atol_box=1e-4, atol_score=1e-5)


def test_reset_weights_draws_the_seed_again(pair):
    _, _, path = pair
    port = YOLO(path, device="cpu", seed=3)
    fresh = {k: v.clone() for k, v in port.model.state_dict().items()}
    with torch.no_grad():
        for p in port.model.parameters():
            p.add_(1.0)
        for name, b in port.model.named_buffers():
            if name.endswith("running_mean"):
                b.add_(1.0)
    assert port.reset_weights() is port
    for k, v in port.model.state_dict().items():
        assert torch.equal(v, fresh[k]), k
    unseeded = YOLO(path, device="cpu", seed=None)
    torch.manual_seed(0)
    unseeded.reset_weights()
    assert all(torch.isfinite(p).all() for p in unseeded.model.parameters())
