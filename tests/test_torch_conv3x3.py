"""3x3 stride-1 conv kernel of the port (`lpc_yolo_tpu_torch/ops/conv3x3.py`).

On the CPU the wrapper runs its plain version; it is held against the JAX
package's Pallas kernel `conv3x3_pallas(..., interpret=True)` for every
activation the serving path uses, at f32, atol 1e-5 (different summation
orders only). The CUDA kernel is held against the plain version on the card
in tests/test_torch_cuda.py. The bf16 kernel's tile choice
(`conv3x3_config`) and the C entry point's argument list are plain Python
and source text, checked here without a card.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lpc_yolo_tpu.ops.pallas_conv import conv3x3_pallas

from lpc_yolo_tpu_torch.ops.conv3x3 import ARGTYPES, CONFIGS, SMEM_LIMIT, conv3x3, conv3x3_config, conv3x3_plain

CU = Path(__file__).resolve().parents[1] / "lpc_yolo_tpu_torch" / "csrc" / "conv3x3.cu"

# The 17 distinct 3x3 s1 conv sites of an LPC-YOLO serving forward at 640: (C, H, W, Co, pixel stride).
LPC_SITES = [
    (16, 320, 320, 32, 16), (16, 160, 160, 16, 32), (16, 160, 160, 16, 16), (32, 160, 160, 64, 32),
    (32, 80, 80, 32, 64), (32, 80, 80, 32, 32), (64, 80, 80, 128, 64), (64, 80, 80, 64, 64),
    (64, 40, 40, 64, 128), (64, 40, 40, 64, 64), (128, 40, 40, 256, 128), (192, 40, 40, 64, 192),
    (64, 40, 40, 64, 64), (128, 20, 20, 128, 256), (128, 20, 20, 128, 128), (384, 20, 20, 64, 384),
    (64, 20, 20, 64, 64),
]
RAGGED = [(16, 21, 37, 16, 16), (64, 21, 37, 64, 64), (128, 21, 37, 256, 128), (24, 21, 37, 40, 30)]


def _inputs(C, Co, seed=0, H=8, W=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Co)) / np.sqrt(9 * C)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, Co).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("act", [False, "silu", "mish", "relu"])
@pytest.mark.parametrize("C,Co", [(16, 8), (16, 32), (24, 8), (24, 32)])
def test_plain_matches_pallas(C, Co, act):
    x, w, b = _inputs(C, Co, seed=C + Co)
    ref = np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act, hb=4, interpret=True))
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), act).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_channel_slice_input():
    """A channel slice of a channels_last map (the C2f split) is a valid input."""
    x, w, b = _inputs(16, 8, seed=5)
    wide = torch.from_numpy(np.concatenate([x, x[..., :4] * 0 + 3.0], -1))  # (2, 8, 8, 20)
    got = conv3x3(wide[..., :16], torch.from_numpy(w), torch.from_numpy(b), "mish")
    ref = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), "mish")
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_rejects_bad_shapes():
    x, w, b = _inputs(16, 8)
    with pytest.raises(ValueError):
        conv3x3(torch.from_numpy(x), torch.from_numpy(w[:, :, :8]), torch.from_numpy(b))
    with pytest.raises(ValueError):
        conv3x3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), act="gelu")


@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("C,H,W,Co,pix", LPC_SITES + RAGGED)
def test_config_fits_the_shape(C, H, W, Co, pix, B):
    """Shared memory within a block's limit, a grid that covers every output pixel and
    channel, a K chunk that fits C, and under a quarter of wasted pixels on the 20^2 and
    40^2 maps at b32; Co up to 128 in one channel tile (each halo chunk staged once)."""
    cfg = conv3x3_config(B, H, W, C, Co)
    th, tw, bn, ck, stages, wm, wn = CONFIGS[cfg.index]
    assert cfg.smem <= SMEM_LIMIT and cfg.threads <= 1024 and stages >= 2
    assert (th * tw) % wm == 0 and bn % wn == 0 and cfg.threads == 32 * (th * tw // wm) * (bn // wn)
    tiles_h, tiles_w = -(-H // th), -(-W // tw)
    assert cfg.grid[0] == B * tiles_h * tiles_w and tiles_h * th >= H and tiles_w * tw >= W
    assert cfg.grid[1] * bn >= Co and (cfg.grid[1] - 1) * bn < Co
    assert ck in (16, 32) and ck <= max(C, 16)
    if (C, H, W, Co, pix) in LPC_SITES:
        assert C % ck == 0
    if Co <= 128:
        assert cfg.grid[1] == 1
    if B == 32 and H == W and H in (20, 40):
        assert 1 - H * W / (tiles_h * th * tiles_w * tw) < 0.25


def test_configs_match_the_cuda_source():
    """CONFIGS lists the kernel's instantiations in the order of kConfigs, and every
    configuration's shared-memory ring fits a block."""
    src = CU.read_text()
    table = src[src.index("const Config kConfigs[]"):]
    found = [tuple(int(v) for v in m.split(",")) for m in re.findall(r"CONV3X3_CONFIG\(([\d, ]+)\)", table)]
    assert found == list(CONFIGS)
    assert all(s * ((th + 2) * (tw + 2) * (ck + 8) + 9 * ck * (bn + 8)) * 2 <= SMEM_LIMIT
               and th * tw * (bn + 8) * 2 <= SMEM_LIMIT for th, tw, bn, ck, s, _, _ in CONFIGS)


def test_argtypes_match_the_entry_point():
    """The wrapper's ctypes argument list follows conv3x3_launch's C signature."""
    src = CU.read_text()
    sig = re.search(r'extern "C" int conv3x3_launch\(([^)]*)\)', src).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong}
    params = [re.sub(r"\s+", " ", p.replace("const ", "")).strip() for p in sig.split(",")]
    want = [kinds[next(k for k in ("void*", "long long", "int") if p.startswith(k))] for p in params]
    assert want == ARGTYPES and len(params) == 16
