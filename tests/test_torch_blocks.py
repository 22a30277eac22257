"""Port parity, block by block: each LPC-YOLO block of `lpc_yolo_tpu_torch`
against its JAX module on the same bridged weights, eval mode, f32, CPU.

Weights come from `random_variables` over the JAX module's `jax.eval_shape`
tree (seeded numpy), go to the port through `flax_to_state_dict`, and the
same NHWC input runs through both. Tolerance atol 1e-5: both sides are f32
with different summation orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.nn import modules as JM

from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.fuse import fuse_conv_bn
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_to_state_dict, random_variables


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(jmod, tmod, x_nhwc, seed=0):
    """Run the JAX module and its port on the same seeded weights; return both NHWC outputs."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros(x_nhwc.shape), training=False))
    variables = random_variables(shapes, seed)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x_nhwc), training=False))
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1).numpy()
    return ref, got


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (name, factory of (JAX module, port module), input shape)
CASES = [
    ("convbn_silu_3x3", lambda: (JM.ConvBN(24, 3, 1, act="silu"), TM.ConvBN(16, 24, 3, 1, act="silu")), (2, 8, 8, 16)),
    ("convbn_mish_3x3", lambda: (JM.ConvBN(24, 3, 1, act="mish"), TM.ConvBN(16, 24, 3, 1, act="mish")), (2, 8, 8, 16)),
    ("convbn_silu_s2", lambda: (JM.ConvBN(32, 3, 2), TM.ConvBN(3, 32, 3, 2)), (2, 8, 8, 3)),
    ("convbn_dw5_mish", lambda: (JM.ConvBN(16, 5, 1, g=16, act="mish"), TM.ConvBN(16, 16, 5, 1, g=16, act="mish")),
     (2, 8, 8, 16)),
    ("bottleneck", lambda: (JM.Bottleneck(16, True, k=(3, 3), e=1.0), TM.Bottleneck(16, 16, True, k=(3, 3), e=1.0)),
     (2, 8, 8, 16)),
    ("c2f_shortcut", lambda: (JM.C2f(32, n=2, shortcut=True), TM.C2f(24, 32, n=2, shortcut=True)), (2, 8, 8, 24)),
    ("c2f_plain", lambda: (JM.C2f(32, n=1, shortcut=False), TM.C2f(48, 32, n=1, shortcut=False)), (2, 8, 8, 48)),
    ("sppf", lambda: (JM.SPPF(32, 5), TM.SPPF(64, 32, 5)), (2, 8, 8, 64)),
    ("lpc", lambda: (JM.LPC(32, 3, 2), TM.LPC(24, 32, 3, 2)), (2, 8, 8, 24)),
    ("psa_2heads", lambda: (JM.PSA(256), TM.PSA(256, 256)), (2, 4, 4, 256)),
    ("psa_1head", lambda: (JM.PSA(64), TM.PSA(64, 64)), (2, 4, 6, 64)),
    ("space_to_depth", lambda: (JM.SpaceToDepth(), TM.SpaceToDepth()), (2, 8, 8, 5)),
    ("spca", lambda: (JM.SPCA(), TM.SPCA(32)), (2, 8, 8, 32)),
    ("cbam", lambda: (JM.CBAM(7), TM.CBAM(32, 7)), (2, 8, 8, 32)),
]
IDS = [c[0] for c in CASES]
WITH_CONVBN = CASES[:11]  # the blocks that hold ConvBNs (fold applies)


@pytest.mark.parametrize("name,make,shape", CASES, ids=IDS)
def test_block_matches_jax(name, make, shape):
    ref, got = _pair(*make(), _x(shape))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,make,shape", WITH_CONVBN, ids=IDS[:11])
def test_folded_block_matches_jax(name, make, shape):
    """The serving fold (`fuse_conv_bn`; 3x3 s1 convs through conv3x3's plain
    version on the CPU) computes the same block as the JAX module."""
    jmod, tmod = make()
    ref, _ = _pair(jmod, tmod, _x(shape))
    fuse_conv_bn(tmod, torch.float32)
    with torch.no_grad():
        got = tmod(torch.from_numpy(_x(shape).transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_activation_and_bn_constants():
    """Mish in block.py-family blocks, SiLU in YAML Conv and head towers; BN eps 1e-3."""
    assert TM.BN_EPS == JM.BN_EPS == 1e-3
    assert TM.ConvBN(4, 4).act == "silu"
    assert TM.Bottleneck(4, 4).cv1.act == "mish"
    c2f = TM.C2f(8, 8, n=1)
    assert c2f.cv1.act == c2f.cv2.act == c2f.m[0].cv1.act == "mish"
    assert TM.LPC(8, 8).cv2.act == "mish"
    from lpc_yolo_tpu_torch.nn.heads import V10Detect

    head = V10Detect(80, (16, 32, 64))
    assert head.one2one_cv2[0][0].act == "silu" and head.cv3[0][1][1].act == "silu"
    assert TM.ConvBN(4, 4).bn.eps == 1e-3


def test_space_to_depth_and_shuffle_order():
    """s2d channel blocks are [(h0,w0), (h1,w0), (h0,w1), (h1,w1)]; the 2-group
    shuffle puts even channels first (JAX modules.py:758-767, 878-883)."""
    x = torch.arange(2 * 4 * 4, dtype=torch.float32).reshape(1, 2, 4, 4)
    y = TM.SpaceToDepth()(x)
    assert torch.equal(y[:, 0:2], x[..., 0::2, 0::2]) and torch.equal(y[:, 2:4], x[..., 1::2, 0::2])
    assert torch.equal(y[:, 4:6], x[..., 0::2, 1::2]) and torch.equal(y[:, 6:8], x[..., 1::2, 1::2])
    c = torch.arange(6, dtype=torch.float32).reshape(1, 6, 1, 1)
    assert TM.channel_shuffle2(c).flatten().tolist() == [0, 2, 4, 1, 3, 5]
    xj = np.arange(6, dtype=np.float32).reshape(1, 1, 1, 6)
    assert np.asarray(JM.channel_shuffle2(jnp.asarray(xj))).flatten().tolist() == [0, 2, 4, 1, 3, 5]
