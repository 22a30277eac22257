"""The port's width-repack (plain version and the wrapper on the CPU) against the
JAX package: `repack_width_pallas` in interpret mode and the plain reshapes of
`lpc_yolo_tpu/nn/modules.py`. A repack moves elements and computes nothing, so
every comparison is bit-exact. The CUDA kernel itself is held against the plain
version on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lpc_yolo_tpu.nn import modules as jm
from lpc_yolo_tpu.ops.pallas_layout import repack_width_pallas

from lpc_yolo_tpu_torch.ops import repack as R

PAIRS = [(8, 1), (8, 4), (8, 2), (4, 2), (4, 1), (2, 1)]
DTYPES = {"uint8": (np.uint8, torch.uint8), "float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _input(dtype: str, shape, seed=0):
    """The same values as a numpy/jax array and a torch tensor."""
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        return jnp.asarray(a), torch.from_numpy(a)
    a = rng.standard_normal(shape, dtype=np.float32)
    t = torch.from_numpy(a).to(DTYPES[dtype][1])
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][0]), t  # bf16: torch rounds, jax casts exactly


def _bits(x) -> np.ndarray:
    """An array's bytes as uint8, whatever its dtype or framework."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pf,pt", PAIRS)
def test_repack_matches_pallas_and_reshape(pf, pt, dtype):
    c = 3
    xj, xt = _input(dtype, (2, 4, 16 // pf, pf * c))
    ref_kernel = repack_width_pallas(xj, pf, pt, interpret=True)
    ref_plain = jm.unpack_width(xj, pf) if pt == 1 else jm.repack_width(xj, pf, pt)
    assert tuple(ref_kernel.shape) == (2, 4, 16 // pt, pt * c)
    for got in (R.repack_width_plain(xt, pf, pt), R.repack_width_kernel(xt, pf, pt),
                R.unpack_width(xt, pf) if pt == 1 else R.repack_width(xt, pf, pt)):
        assert tuple(got.shape) == tuple(ref_kernel.shape) and got.is_contiguous()
        np.testing.assert_array_equal(_bits(got), _bits(ref_kernel))
        np.testing.assert_array_equal(_bits(got), _bits(ref_plain))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_strided_input_gives_the_same_answer(dtype):
    """A [:, :h, :w] slice of a larger staging buffer (strided in B, H and W/pf)."""
    _, big = _input(dtype, (3, 6, 5, 24), seed=1)
    view = big[1:, :4, :2]
    assert not view.is_contiguous()
    dense = view.contiguous()
    for pf, pt in ((8, 1), (8, 2), (4, 1)):
        got = R.repack_width_kernel(view, pf, pt)
        assert torch.equal(got, R.repack_width_plain(dense, pf, pt))
        assert torch.equal(got, dense.reshape(2, 4, 2 * pf // pt, 24 // pf * pt))


def test_pack_then_unpack_round_trip():
    _, x = _input("float32", (2, 4, 16, 3))
    np.testing.assert_array_equal(R.pack_width(x, 8).numpy(), np.asarray(jm.pack_width(jnp.asarray(x.numpy()), 8)))
    assert torch.equal(R.unpack_width(R.pack_width(x, 8), 8), x)
    assert R.repack_width(x, 4, 4) is x


@pytest.mark.parametrize("pf,pt,last", [(4, 4, 24), (2, 4, 24), (8, 3, 24), (8, 1, 20), (8, 0, 24)])
def test_wrapper_rejects_bad_factors(pf, pt, last):
    with pytest.raises(ValueError):
        R.repack_width_kernel(torch.zeros(1, 2, 2, last), pf, pt)


def test_copy_plan_folds_contiguous_dimensions():
    """The kernel's byte plan: contiguous trailing dimensions fold into the run,
    and the access width is the widest the run, strides and address allow."""
    # contiguous (16, 640, 80, 24) u8: one run of everything, 16-byte accesses
    x = torch.empty(16, 640, 80, 24, dtype=torch.uint8)
    assert R.copy_plan(x.shape, x.stride(), 1, 4096) == ((1, 1, 1), (0, 0, 0), 16 * 640 * 80 * 24, 16)
    # a [:, :600, :70] slice: W folds into the run (70 * 24 bytes), H and B stay strided
    v = x[:, :600, :70]
    dims, strides, run, vec = R.copy_plan(v.shape, v.stride(), 1, 4096)
    assert (dims, strides, run, vec) == ((1, 16, 600), (0, 640 * 80 * 24, 80 * 24), 70 * 24, 16)
    # f32 slice whose rows are not 16-byte multiples: 8-byte accesses; an odd address: by the byte width
    f = torch.empty(2, 8, 9, 6)[:, :4, :3]
    assert R.copy_plan(f.shape, f.stride(), 4, 4096)[2:] == (3 * 6 * 4, 8)
    assert R.copy_plan(f.shape, f.stride(), 4, 4100)[3] == 4
    # strided in W/pf too (every second column): nothing folds
    w = torch.empty(2, 4, 8, 24, dtype=torch.uint8)[:, :, ::2]
    assert R.copy_plan(w.shape, w.stride(), 1, 4096) == ((2, 4, 4), (4 * 8 * 24, 8 * 24, 48), 24, 8)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On anything but a CPU tensor the wrapper goes to the kernel (or raises): the
    plain version is not a fallback."""
    called = []
    monkeypatch.setattr(R, "repack_width_plain", lambda *a: called.append(a))
    meta = torch.empty(1, 4, 2, 24, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        R.repack_width_kernel(meta, 8, 1)
    assert not called
