"""The port's CUDA kernels against their plain PyTorch versions, and one training
step on the card against the same step on the CPU.

Marked `gpu`; every test skips without a CUDA card (the kernels have no CPU
mode). This file imports torch and the port only, so it runs on a machine
without JAX:

    python -m pytest tests/test_torch_cuda.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_config, conv3x3_plain
from lpc_yolo_tpu_torch.ops.conv_s8 import conv_s8, conv_s8_plain
from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, letterbox_tables
from lpc_yolo_tpu_torch.ops.quantize_s8 import quantize_s8, quantize_s8_plain
from lpc_yolo_tpu_torch.ops.repack import repack_width_kernel, repack_width_plain

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("mode", [torch.uint8, torch.float32, torch.bfloat16])
def test_letterbox_kernel_matches_plain(mode):
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 720, 1280, 3), dtype=np.uint8)).cuda()
    tab = torch.from_numpy(letterbox_tables(720, 1280, 640).copy()).cuda()
    before = letterbox.launches
    got = letterbox(frames, 640, out_dtype=mode).float()
    ref = letterbox_plain(frames, tab, 640, mode).float()
    torch.cuda.synchronize()
    assert letterbox.launches == before + 1
    tol = {torch.uint8: 1.0, torch.float32: 1e-5, torch.bfloat16: 1 / 256}[mode]
    assert (got - ref).abs().max().item() <= tol


@pytest.mark.parametrize("h0,w0", [(360, 480), (1080, 810)])
def test_letterbox_kernel_scaleup_false_matches_plain(h0, w0):
    """The validator's scaleup=False tables: a frame smaller than S (padded only, its content the
    RGB frame itself) and one larger (downscaled); u8 bit-exact, f32 1e-5, bf16 one ulp."""
    from lpc_yolo_tpu_torch.ops.letterbox import tables_on

    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, (2, h0, w0, 3), dtype=np.uint8)).cuda()
    tab = tables_on(h0, w0, 640, frames.device, False)
    for mode in (torch.uint8, torch.float32, torch.bfloat16):
        got = letterbox(frames, 640, out_dtype=mode, scaleup=False)
        ref = letterbox_plain(frames, tab, 640, mode)
        torch.cuda.synchronize()
        if mode == torch.uint8:
            assert torch.equal(got, ref)
        elif mode == torch.float32:
            assert (got - ref).abs().max().item() <= 1e-5
        else:
            assert (got.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max().item() <= 1
    if h0 <= 640 and w0 <= 640:
        top, left = (int((tab[k] >= 0).int().argmax()) for k in (0, 4))
        assert torch.equal(letterbox(frames, 640, out_dtype=torch.uint8, scaleup=False)[:, top:top + h0, left:left + w0],
                           frames.flip(-1))


# (B, H, W, C, Co, channel offset, bf16 instantiation the shape takes): each of the
# eight instantiations, ragged maps (19x37, 21x37), the 20x20 and 40x40 maps, batch 3,
# Co past 128 (two channel tiles), an unaligned channel slice (element-wise staging), Co
# no multiple of 8 (stores from the registers) and the upper half of a C2f split (offset
# C of a 2C map, strided rows).
CONV_CASES = [
    (2, 19, 37, 16, 16, 0, 0), (3, 128, 128, 16, 32, 0, 1), (3, 128, 128, 32, 32, 32, 1), (2, 19, 37, 32, 20, 0, 1),
    (2, 19, 37, 24, 40, 6, 2), (3, 128, 128, 64, 64, 0, 2), (3, 128, 128, 48, 128, 0, 3), (32, 40, 40, 64, 64, 64, 4),
    (32, 40, 40, 192, 64, 0, 4), (2, 19, 37, 32, 64, 32, 5), (2, 20, 20, 384, 64, 0, 5), (3, 128, 128, 64, 128, 0, 6),
    (16, 40, 40, 128, 256, 0, 6), (1, 24, 40, 16, 130, 0, 7), (2, 21, 37, 128, 256, 0, 7), (3, 20, 20, 128, 128, 128, 7),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [False, "silu", "mish", "relu"])
@pytest.mark.parametrize("B,H,W,C,Co,offset,config", CONV_CASES)
def test_conv3x3_kernel_matches_plain(B, H, W, C, Co, offset, config, act, dtype):
    """Kernel vs plain version on the card: f32 atol 1e-4 (summation order only), bf16
    relative 2e-2 against the f32 conv of the same bf16 inputs (f32 sums, one bf16 rounding)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    wide = torch.randn(B, H, W, C + offset, device="cuda", generator=g)
    w = torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5
    b = torch.rand(Co, device="cuda", generator=g) - 0.5
    xq, wq = wide.to(dtype)[..., offset:], w.to(dtype)  # slice after the cast: the kernel sees the strides
    assert conv3x3_config(B, H, W, C, Co).index == config
    before = conv3x3.launches
    got = conv3x3(xq, wq, b, act).float()
    ref = conv3x3_plain(xq.float(), wq.float(), b, act)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


# (B, H, W, C, Co, channel offset) of the YOLOv10 scales' shape classes: Co tiles partly filled
# (48, 80, 96, 160, 192), C no multiple of 32 (48, 80: 16-channel chunks), C up to 640 (K = 5760), and
# v10x's first C2f bottleneck whole at its serving batch of 32 (the upper half of a 160-channel split).
# At these batches the bf16 kernel takes instantiations 2, 6, 6, 7, 6, 6, 7 and 3.
V10_CONV_CASES = [
    (2, 160, 160, 48, 48, 48), (32, 80, 80, 96, 96, 0), (32, 40, 40, 192, 192, 0), (2, 80, 80, 160, 160, 0),
    (32, 80, 80, 320, 80, 0), (32, 40, 40, 640, 80, 0), (2, 20, 20, 640, 80, 0), (32, 160, 160, 80, 80, 80),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [False, "silu", "mish", "relu"])
@pytest.mark.parametrize("B,H,W,C,Co,offset", V10_CONV_CASES)
def test_conv3x3_v10_shapes_match_plain(B, H, W, C, Co, offset, act, dtype):
    """The kernel against its plain version at the v10 scales' new shape classes, with the tolerances of
    `test_conv3x3_kernel_matches_plain`."""
    g = torch.Generator(device="cuda").manual_seed(1)
    wide = torch.randn(B, H, W, C + offset, device="cuda", generator=g)
    w = torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5
    b = torch.rand(Co, device="cuda", generator=g) - 0.5
    xq, wq = wide.to(dtype)[..., offset:], w.to(dtype)
    got = conv3x3(xq, wq, b, act).float()
    ref = conv3x3_plain(xq.float(), wq.float(), b, act)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


# (B, H, W, C, Co) of the YOLOv8 Detect cls towers at their serving batch: c3 = max(ch0, min(nc, 100)) gives
# Co 80, 128, 192, 256 and 320 on n, s, m, l and x; the first conv takes the level's channels (up to 640 on
# x's P5), the second c3; Co 320 is three channel tiles, the last half filled.
V8_CONV_CASES = [
    (32, 80, 80, 64, 80), (32, 20, 20, 256, 80), (32, 40, 40, 128, 128), (32, 80, 80, 192, 192),
    (32, 20, 20, 576, 192), (32, 40, 40, 256, 256), (32, 20, 20, 512, 256), (32, 80, 80, 320, 320),
    (32, 20, 20, 640, 320), (32, 40, 40, 320, 320),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,Co", V8_CONV_CASES)
def test_conv3x3_v8_cls_tower_shapes_match_plain(B, H, W, C, Co, dtype):
    """The kernel against its plain version at the v8 cls towers' shapes (SiLU, as the towers' ConvBNs), with
    the tolerances of `test_conv3x3_kernel_matches_plain`."""
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    w = (torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5).to(dtype)
    b = torch.rand(Co, device="cuda", generator=g) - 0.5
    got = conv3x3(x, w, b, "silu").float()
    ref = conv3x3_plain(x.float(), w.float(), b, "silu")
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


# (B, H, W, C, Co, act) of the YOLOv8-seg heads at their serving batch: Proto's cv2 at 160x160 (npr -> npr: 64 on
# n, 192 on m, 320 on x; the largest map conv3x3 runs), Proto's cv1 (P3 -> npr at 80x80), and the mask-coefficient
# towers (each level's channels -> c4 = max(ch0 // 4, 32), then c4 -> c4).
SEG_CONV_CASES = [
    (32, 160, 160, 64, 64, "mish"), (32, 160, 160, 192, 192, "mish"), (32, 160, 160, 320, 320, "mish"),
    (32, 80, 80, 320, 320, "mish"), (32, 80, 80, 64, 32, "silu"), (32, 40, 40, 128, 32, "silu"),
    (32, 20, 20, 640, 80, "silu"), (32, 80, 80, 48, 48, "silu"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,Co,act", SEG_CONV_CASES)
def test_conv3x3_seg_shapes_match_plain(B, H, W, C, Co, act, dtype):
    """The kernel against its plain version at the seg heads' sites, Proto's 160x160 ones among them, with the
    tolerances of `test_conv3x3_kernel_matches_plain` (f32 abs 1e-4, bf16 2e-2 relative)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    w = (torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5).to(dtype)
    b = torch.rand(Co, device="cuda", generator=g) - 0.5
    got = conv3x3(x, w, b, act).float()
    ref = conv3x3_plain(x.float(), w.float(), b, act)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


# (B, H, W, C, Co, act) of the other CNN detection YAMLs at their serving batch: yolov6n's plain 3x3 convs with
# ReLU at each level (32 to 256 channels), yolov8x-p2's P2 head towers on the 160x160 maps (160 -> 64 and
# 160 -> 160), yolov8x-p6's first C2f bottleneck on the 320x320 map at 1280 (80 -> 80, Mish; batch 8),
# yolov3's P5 bottleneck (512 -> 1024, Mish) and its 3x3 head conv (512 -> 1024, SiLU).
ZOO_CONV_CASES = [
    (32, 160, 160, 32, 32, "relu"), (32, 80, 80, 64, 64, "relu"), (32, 40, 40, 128, 128, "relu"),
    (32, 20, 20, 256, 256, "relu"), (32, 160, 160, 160, 64, "silu"), (32, 160, 160, 160, 160, "silu"),
    (8, 320, 320, 80, 80, "mish"), (32, 20, 20, 512, 1024, "mish"), (32, 20, 20, 512, 1024, "silu"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,Co,act", ZOO_CONV_CASES)
def test_conv3x3_zoo_shapes_match_plain(B, H, W, C, Co, act, dtype):
    """The kernel against its plain version at the sites of the v3, v5, v6 and v8 P2 / P6 graphs, ReLU among
    them, with the tolerances of `test_conv3x3_kernel_matches_plain` (f32 abs 1e-4, bf16 2e-2 relative)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    w = (torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5).to(dtype)
    b = torch.rand(Co, device="cuda", generator=g) - 0.5
    got = conv3x3(x, w, b, act).float()
    ref = conv3x3_plain(x.float(), w.float(), b, act)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


@pytest.mark.parametrize("identity", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_repconv_is_one_launch(identity, dtype):
    """A YOLOv9 RepConv (128 -> 128 at 40x40, b32; with and without its identity BN) folded for serving is one
    conv3x3 launch with the SiLU epilogue. In f32 it equals its three unfolded branches (conv1 3x3 + conv2 1x1
    (+ the identity BN), then SiLU, through F.conv2d) within abs 1e-4; in bf16 it equals the plain version of the
    same conv on the same bf16 input and folded weights within 2e-2 relative, as every bf16 conv3x3 check."""
    from lpc_yolo_tpu_torch.nn.fuse import fuse_conv_bn
    from lpc_yolo_tpu_torch.nn.modules import RepConv

    g = torch.Generator(device="cuda").manual_seed(9)
    m = RepConv(128, 128, use_identity=identity).cuda().eval()
    with torch.no_grad():
        for t in m.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, device="cuda", generator=g) * 0.5 + 0.5 if t.dim() == 1
                        else torch.randn(t.shape, device="cuda", generator=g) / (t[0].numel() ** 0.5))
        x = torch.randn(32, 128, 40, 40, device="cuda", generator=g).contiguous(memory_format=torch.channels_last)
        ref = m(x)
        fuse_conv_bn(m, dtype)
        before = conv3x3.launches
        got = m(x.to(dtype)).float()
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        w, b = m.folded
        ref = conv3x3_plain(x.to(dtype).permute(0, 2, 3, 1).float(), w.float(), b, "silu").permute(0, 3, 1, 2)
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


# (B, H, W, C, Co) of the YOLOv8-pose keypoint towers at their serving batch: c4 = max(ch0 // 4, 51), so on n, s
# and m both convs of a tower are odd-sized (51 -> 51 at every level, the element-wise staging path), on n the
# first takes 64, 128 and 256 channels to 51; on x each level's channels go to 80 (320 -> 80 at 80x80).
POSE_CONV_CASES = [
    (32, 80, 80, 51, 51), (32, 40, 40, 51, 51), (32, 20, 20, 51, 51), (32, 80, 80, 64, 51), (32, 40, 40, 128, 51),
    (32, 20, 20, 256, 51), (32, 80, 80, 320, 80),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,Co", POSE_CONV_CASES)
def test_conv3x3_pose_shapes_match_plain(B, H, W, C, Co, dtype):
    """The kernel against its plain version at the pose heads' keypoint-tower sites (SiLU), the 51-channel ones
    among them, with the tolerances of `test_conv3x3_kernel_matches_plain` (f32 abs 1e-4, bf16 2e-2 relative)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    w = (torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5).to(dtype)
    b = torch.rand(Co, device="cuda", generator=g) - 0.5
    before = conv3x3.launches
    got = conv3x3(x, w, b, "silu").float()
    ref = conv3x3_plain(x.float(), w.float(), b, "silu")
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


# (B, H, W, C, Co) of the YOLOv8-obb angle towers at their serving batch and imgsz 1024: c4 = max(ch0 // 4, 1), so on n
# each level's channels (64, 128, 256) go to 16 and 16 -> 16 runs at 128x128, 64x64 and 32x32 (small K, many blocks);
# on x 320 -> 80 and 80 -> 80 at 128x128.
OBB_CONV_CASES = [
    (32, 128, 128, 64, 16), (32, 128, 128, 16, 16), (32, 64, 64, 128, 16), (32, 64, 64, 16, 16), (32, 32, 32, 256, 16),
    (32, 32, 32, 16, 16), (32, 128, 128, 320, 80), (32, 128, 128, 80, 80),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,Co", OBB_CONV_CASES)
def test_conv3x3_obb_shapes_match_plain(B, H, W, C, Co, dtype):
    """The kernel against its plain version at the OBB heads' angle-tower sites at 1024 (SiLU), with the tolerances of
    `test_conv3x3_kernel_matches_plain` (f32 abs 1e-4, bf16 2e-2 relative); one launch a call."""
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    w = (torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5).to(dtype)
    b = torch.rand(Co, device="cuda", generator=g) - 0.5
    before = conv3x3.launches
    got = conv3x3(x, w, b, "silu").float()
    ref = conv3x3_plain(x.float(), w.float(), b, "silu")
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


@pytest.mark.parametrize("multi_label", [False, True], ids=["best", "multi_label"])
def test_nms_rotated_on_the_card_matches_the_cpu(multi_label):
    """`nms_rotated` on a b4 pool of 21,504 anchors and 15 classes (imgsz 1024, DOTAv1) on the card against the CPU on
    the same inputs: per image the kept rows' counts within 2 of each other (a pair whose probIoU lies within f32
    rounding of iou_thres may be cut on one side only), and 99% of the card's rows have a CPU twin of the same class,
    score and rotated box within 1e-3 px."""
    from lpc_yolo_tpu_torch.ops.nms import nms_rotated

    rng = np.random.default_rng(9)
    B, A, nc = 4, 21504, 15
    rb = np.zeros((B, A, 5), np.float32)
    rb[..., :2] = rng.uniform(0, 1024, (B, A, 2))
    rb[..., 2:4] = rng.uniform(8, 120, (B, A, 2))
    rb[..., 4] = (rng.random((B, A)) - 0.25) * np.pi
    scores = (rng.random((B, A, nc)) ** 4).astype(np.float32)
    args = (0.25, 0.45, 300)
    cpu = nms_rotated(torch.from_numpy(rb), torch.from_numpy(scores), *args, multi_label=multi_label).numpy()
    card = nms_rotated(torch.from_numpy(rb).cuda(), torch.from_numpy(scores).cuda(), *args,
                       multi_label=multi_label).cpu().numpy()
    rows = twins = 0
    for a, b in zip(card, cpu):
        a, b = a[a[:, 5] > 0], b[b[:, 5] > 0]
        assert abs(len(a) - len(b)) <= 2 and len(a) > 50
        for row in a:
            same = (b[:, 6] == row[6]) & (b[:, 5] == row[5])
            twins += bool(same.any() and np.abs(b[same, :5] - row[:5]).max(1).min() <= 1e-3)
        rows += len(a)
    assert twins >= 0.99 * rows


def test_kept_rows_masks_on_the_card_match_the_cpu():
    """`process_mask(..., upsample=True)` of 200 kept rows at 640 on the card against the CPU on the same inputs
    (f32 sigmoid masks within 1e-5), and `unletterbox_masks` to a 720x1280 frame: on the same masks bit for bit
    (cv2's weights and fused lerp, in f64, give the same bools on both), through the whole chain at most 1e-4 of
    the pixels differ."""
    from lpc_yolo_tpu_torch.ops.masks import process_mask, unletterbox_masks

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    protos = torch.from_numpy(rng.standard_normal((32, 160, 160)).astype(np.float32))
    coeffs = torch.from_numpy(rng.standard_normal((200, 32)).astype(np.float32))
    xy = rng.uniform(0, 560, (200, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(8, 300, (200, 2))], 1).astype(np.float32))
    cpu = process_mask(protos, coeffs, boxes, (640, 640), upsample=True)
    card = process_mask(protos.cuda(), coeffs.cuda(), boxes.cuda(), (640, 640), upsample=True)
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-5)
    same = unletterbox_masks(cpu.cuda(), 640, (720, 1280)).cpu()
    ref = unletterbox_masks(cpu, 640, (720, 1280))
    assert torch.equal(same, ref) and ref.shape == (200, 720, 1280) and ref.any()
    chain = unletterbox_masks(card, 640, (720, 1280)).cpu()
    assert (chain != ref).float().mean().item() <= 1e-4


@pytest.mark.parametrize("pool", ["worst", "val", "pose"])
def test_nms_kernel_matches_plain(pool):
    """The NMS kernel against `nms_plain` on the same pool on the card: the same rows bit for bit and the same
    anchors. "worst": 4096 candidates an image, every score above conf (tied in runs of ~4), so all 300 steps
    run; "val": the validator's multi_label pool (conf 0.001, iou 0.7) of a seed-0 yolov8n at 320; "pose": the
    same of a seed-0 yolov8n-pose (nc 1, one candidate an anchor). One launch a call."""
    from chip_smoke import nms_val_pool, nms_worst_pool
    from lpc_yolo_tpu_torch.ops.nms import nms_greedy, nms_plain

    if pool == "worst":
        args, kw = nms_worst_pool(4, seed=0), dict(conf_thres=0.25, iou_thres=0.45)
    else:
        model = "yolov8n-pose.yaml" if pool == "pose" else "yolov8n.yaml"
        args, kw = nms_val_pool(4, imgsz=320, dtype=torch.float32, model=model), dict(conf_thres=0.001, iou_thres=0.7)
        assert pool != "pose" or not args[2].any()  # one class
    before = nms_greedy.launches
    out, anc = nms_greedy(*args, max_det=300, **kw)
    ref, ref_anc = nms_plain(*args, max_det=300, **kw)
    torch.cuda.synchronize()
    assert nms_greedy.launches == before + 1
    assert torch.equal(out, ref) and torch.equal(anc, ref_anc)
    kept = (out[..., 5] >= 0).sum(1)
    assert (kept == 300).all() if pool == "worst" else (kept > 0).all()


def test_conv3x3_configs_match_the_library():
    """The built library describes each instantiation as CONFIGS and conv3x3_config do."""
    import ctypes

    from lpc_yolo_tpu_torch.ops import _build
    from lpc_yolo_tpu_torch.ops.conv3x3 import CONFIGS, _describe

    lib = _build.load("conv3x3")
    assert lib.conv3x3_num_configs() == len(CONFIGS)
    out = (ctypes.c_int * 9)()
    for i, cfg in enumerate(CONFIGS):
        assert lib.conv3x3_describe(i, out) == 0
        py = _describe(i, 1, 1, 1, 1)
        assert list(out) == [*cfg, py.threads, py.smem]
    assert lib.conv3x3_describe(len(CONFIGS), out) != 0


def test_conv3x3_rejects_strided_channels():
    x = torch.randn(1, 8, 8, 32, device="cuda")[..., ::2]
    with pytest.raises(ValueError):
        conv3x3(x, torch.randn(3, 3, 16, 8, device="cuda"))


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pf,pt", [(8, 1), (8, 2), (4, 2), (2, 1)])
def test_repack_kernel_matches_plain(pf, pt, dtype, strided):
    """Bit-exact for element sizes 1, 2 and 4 bytes, on a contiguous input and on a
    [:, :h, :w] slice of a larger buffer (strided in B and H; its rows of 5 * 24
    elements are no multiple of 16 bytes in uint8, so the narrower access widths run too)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    big = (torch.rand(3, 40, 9, 24, device="cuda", generator=g) * 255).to(dtype)
    x = big[:, :33, :5] if strided else big[:, :33, :5].contiguous()
    assert x.is_contiguous() != strided
    before = repack_width_kernel.launches
    got = repack_width_kernel(x, pf, pt)
    torch.cuda.synchronize()
    assert repack_width_kernel.launches == before + 1
    assert got.is_contiguous() and got.shape == (3, 33, 5 * pf // pt, 24 // pf * pt)
    assert torch.equal(got.view(torch.uint8), repack_width_plain(x, pf, pt).view(torch.uint8))


def test_repack_kernel_training_feed_and_odd_offset():
    g = torch.Generator(device="cuda").manual_seed(1)
    feed = torch.randint(0, 256, (4, 640, 80, 24), device="cuda", generator=g, dtype=torch.uint8)
    assert torch.equal(repack_width_kernel(feed, 8, 1), feed.view(4, 640, 640, 3))
    # a view that starts 24 bytes into the buffer: 8-byte accesses
    assert torch.equal(repack_width_kernel(feed[:, :, 1:], 8, 1), feed[:, :, 1:].contiguous().view(4, 640, 632, 3))
    with pytest.raises(ValueError):
        repack_width_kernel(feed[..., ::2], 4, 1)  # the last dimension must be contiguous


def test_train_step_on_the_card_matches_the_cpu():
    """One f32 step of the full-width LPC-YOLO model (imgsz 64, batch 2, packed uint8 feed):
    loss items rtol 1e-3 and the updated parameters within 1e-3 of each leaf's largest value;
    then a bf16-autocast step is finite and goes through the repack kernel once."""
    import copy

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.train_step import OptConfig, init_train_state, make_train_step
    from lpc_yolo_tpu_torch.engine.trainer import pack_img

    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 30, (2, 4, 2))
    mask = np.array([[True, True, False, False], [True, False, False, False]])
    batch = {"img": pack_img(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)),
             "cls": rng.integers(0, 80, (2, 4)).astype(np.int32),
             "bboxes": np.concatenate([xy, xy + rng.uniform(8, 30, (2, 4, 2))], -1).astype(np.float32) * mask[..., None],
             "mask": mask}
    yolo = YOLO(device="cpu", seed=0)
    cfg = OptConfig(warmup_steps=2, total_steps=10)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(yolo.model)
        state = init_train_state(model, cfg, device=dev)
        step = make_train_step(model, cfg, amp=False)
        mets = [step(state, batch)[1] for _ in range(2)]  # lr is 0 on the first step
        runs[dev] = (state, mets)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        assert a["skipped"] is False and b["skipped"] is False
        np.testing.assert_allclose(a["items"].cpu().numpy(), b["items"].numpy(), rtol=1e-3)
    for k, p in runs["cpu"][0].params.items():
        q = runs["cuda"][0].params[k].cpu()
        assert (q - p).abs().max() <= 1e-3 * p.abs().max(), k

    model = copy.deepcopy(yolo.model)
    state = init_train_state(model, cfg, device="cuda")
    before = repack_width_kernel.launches
    state, met = make_train_step(model, cfg)(state, batch)
    assert repack_width_kernel.launches == before + 1
    assert met["skipped"] is False and bool(torch.isfinite(met["items"]).all())


def test_val_on_the_card_matches_the_cpu(tmp_path):
    """YOLO(device="cuda").val on a tiny dataset of .npy twins (read through cache_images="disk";
    the PNGs beside them are never decoded): one letterbox launch per batch and frame shape, 28
    conv3x3 launches per batch, and in f32 every key of the results dict within 0.02 of the same
    validation on the CPU (near-tied scores of the random weights may swap places)."""
    import json

    from chip_smoke import write_val_labels
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data.synthetic import write_png
    from lpc_yolo_tpu_torch.engine.predictor import serving_model
    from lpc_yolo_tpu_torch.engine.validator import Validator
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3

    imgsz, shapes = 128, [(96, 160), (100, 80), (200, 150)]
    img_dir = tmp_path / "images" / "val"
    img_dir.mkdir(parents=True)
    (tmp_path / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(5)
    files, frames = [], []
    for i in range(7):
        im = rng.integers(0, 256, shapes[i % 3] + (3,), dtype=np.uint8)
        files.append(img_dir / f"{i}.png")
        frames.append(im)
        write_png(files[-1], im)
        np.save(files[-1].with_suffix(".npy"), im)
    cpu = YOLO(device="cpu", seed=0)
    v = Validator(cpu, imgsz=imgsz, device="cpu")
    write_val_labels(files, frames, v.predict(serving_model(cpu.model, v.device, v.dtype), v.preprocess(frames)), imgsz)
    data = tmp_path / "data.yaml"
    data.write_text(json.dumps({"path": str(tmp_path), "val": "images/val", "nc": 80}))

    yolo = YOLO(device="cuda", seed=0)
    letterbox.launches = conv3x3.launches = 0
    got = yolo.val(data=str(data), imgsz=imgsz, batch=4, cache_images="disk", dtype=torch.float32)
    torch.cuda.synchronize()
    assert (letterbox.launches, conv3x3.launches) == (3 + 3, 28 * 2)  # batches [0..3], [4..6 + a repeat]
    ref = cpu.val(data=str(data), imgsz=imgsz, batch=4, cache_images="disk")
    assert got.keys() == ref.keys() and ref["metrics/mAP50(B)"] > 0.3
    assert max(abs(got[k] - ref[k]) for k in ref) <= 0.02, (got, ref)


def test_training_render_on_the_card_matches_the_cpu(tmp_path):
    """The training render (`data/augment.py::render`: cv2's fixed-point resize, the warp and HSV in f32
    with fused multiply-adds emulated in f64) on the card against the CPU, on plans of a mosaic batch with
    mixups and of a letterboxed batch at 640: within 1 LSB (bit-exact expected: integer and IEEE f64/f32
    operations only)."""
    from lpc_yolo_tpu_torch.data import (DataLoader, TrainTransforms, YOLODataset, check_det_dataset,
                                         make_synthetic_dataset, render)

    info = check_det_dataset(make_synthetic_dataset(tmp_path, n_train=8, n_val=1, nc=3, max_boxes=4, seed=5,
                                                    shapes=((720, 1280), (1080, 810), (360, 480))))
    ds = YOLODataset(info["train"], cache_images="disk")
    for tt in (TrainTransforms(640, {"mixup": 0.5}), TrainTransforms(640, {"mosaic": 0.0, "degrees": 5.0})):
        batch = next(iter(DataLoader(ds, tt.plan, batch_size=4, workers=2, shuffle=True, infinite=True)))
        card = render(batch["plan"], batch["sources"], torch.device("cuda")).cpu()
        cpu = render(batch["plan"], batch["sources"], torch.device("cpu"))
        assert card.shape == (4, 640, 640, 3) and (card.int() - cpu.int()).abs().max().item() <= 1


# (B, H, W, C, Co, act) of the RT-DETR sites at their serving batch: rtdetr-l's HGBlocks (48 @160², 96 @80²) and
# rtdetr-x's (64 @160², 128 @80²), Mish; the RepC3 RepConvs, SiLU, of l (256) and x (384) at 80², 40² and 20²
RTDETR_CONV_CASES = [
    (32, 160, 160, 48, 48, "mish"), (32, 80, 80, 96, 96, "mish"), (32, 160, 160, 64, 64, "mish"),
    (32, 80, 80, 128, 128, "mish"), (32, 80, 80, 256, 256, "silu"), (32, 40, 40, 256, 256, "silu"),
    (32, 20, 20, 256, 256, "silu"), (32, 80, 80, 384, 384, "silu"), (32, 20, 20, 384, 384, "silu"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,Co,act", RTDETR_CONV_CASES)
def test_conv3x3_rtdetr_shapes_match_plain(B, H, W, C, Co, act, dtype):
    """The kernel against its plain version at the RT-DETR sites (f32 abs 1e-4, bf16 2e-2 relative)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    w = (torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5).to(dtype)
    b = torch.rand(Co, device="cuda", generator=g) - 0.5
    got = conv3x3(x, w, b, act).float()
    ref = conv3x3_plain(x.float(), w.float(), b, act)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


def test_rtdetr_topk_ties_on_the_card_match_the_cpu():
    """`select_topk` on CUDA keeps `jax.lax.top_k`'s order as on the CPU: b32 rows of 8400 scores in bf16-like
    steps, the 316 border anchors of a 640 input tied at one value, the same indices in the same order."""
    from lpc_yolo_tpu_torch.nn.transformer import make_anchors, select_topk

    _, valid = make_anchors([(80, 80), (40, 40), (20, 20)], "cpu")
    assert int((~valid).sum()) == 316
    g = torch.Generator().manual_seed(3)
    scores = (torch.randn(32, 8400, generator=g) * 64).round() / 64  # many exact ties
    scores[:, ~valid[:, 0]] = 0.5
    for k in (300, 8400):
        assert torch.equal(select_topk(scores.cuda(), k).cpu(), select_topk(scores, k))


@pytest.mark.parametrize("n", [8400, 672_000])
def test_nms_pool_top_k_on_the_card_keeps_the_stable_order(n):
    """The NMS pool's `top_k` on CUDA against a stable descending sort on the CPU: b4 rows of n scores in 1/64
    steps (many exact ties, -0.0 beside +0.0), the first 4096 in `jax.lax.top_k`'s order, values and indices."""
    from lpc_yolo_tpu_torch.ops.nms import top_k

    g = torch.Generator().manual_seed(5)
    scores = (torch.rand(4, n, generator=g) * 64).round() / 64
    scores[:, ::7] = -0.0
    values, idx = top_k(scores.cuda(), 4096)
    ref_values, ref_idx = scores.sort(dim=1, descending=True, stable=True)
    assert torch.equal(idx.cpu(), ref_idx[:, :4096]) and torch.equal(values.cpu(), ref_values[:, :4096])


@pytest.mark.parametrize("cfg", ["rt-detr/rtdetr-l.yaml", "rt-detr/rtdetr-resnet50.yaml", "v8/yolov8-rtdetr.yaml"])
def test_rtdetr_serving_on_the_card_matches_the_cpu(cfg):
    """A small-decoder RT-DETR (hd 64, nq 60, nh 4, 2 layers; every other layer as published) served on the card in
    f32 from two 720p frames at 256 (letterbox, the folded graph, the decoder, no NMS) against the same serving
    path on the CPU: one letterbox launch, one conv3x3 launch a site, the rows matched tie-tolerantly (box 0.05
    px, score 1e-4); then bf16 on the card, finite (B, 60, 6) rows."""
    import yaml

    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.nn import build_model
    from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
    from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, load_flax, random_variables

    root = __import__("pathlib").Path(__file__).resolve().parents[1] / "lpc_yolo_tpu_torch" / "cfg" / "models"
    d = yaml.safe_load((root / cfg).read_text())
    d["head"][-1][3] = ["nc", 64, 60, 4, 4, 2, 256]
    m = build_model(d, device="cpu")
    load_flax(m, random_variables(flax_shapes(m), seed=0))
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(2)]
    card = Predictor(m, imgsz=256, batch=2, device="cuda", dtype=torch.float32)
    letterbox.launches = conv3x3.launches = 0
    got = card.infer(frames).cpu().numpy()
    torch.cuda.synchronize()
    assert (letterbox.launches, conv3x3.launches) == (1, len(conv3x3_sites(card.model)))
    ref = Predictor(m, imgsz=256, batch=2, device="cpu", dtype=torch.float32).infer(frames).numpy()
    assert got.shape == ref.shape == (2, 60, 6)
    for a, b in zip(got, ref):
        assert_detections_close(a, b, atol_box=0.05, atol_score=1e-4)
    half = Predictor(m, imgsz=256, batch=2, device="cuda", dtype=torch.bfloat16).infer(frames)
    assert half.shape == (2, 60, 6) and bool(torch.isfinite(half).all())


# (B, H, W, C, Co) of the YOLO-World `proj_conv` sites (MaxSigmoidAttnBlock: 3x3, no activation) at the serving
# batch, one a C2fAttn: yolov8s-world's (64 @80², 128 @40², 256 @20²), m's (96, 192, 288) and x's (160, 320, 320)
WORLD_PROJ_CASES = [
    (32, 80, 80, 64, 64), (32, 40, 40, 128, 128), (32, 20, 20, 256, 256), (32, 80, 80, 96, 96),
    (32, 40, 40, 192, 192), (32, 20, 20, 288, 288), (32, 80, 80, 160, 160), (32, 40, 40, 320, 320),
    (32, 20, 20, 320, 320),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,Co", WORLD_PROJ_CASES)
def test_conv3x3_world_proj_conv_shapes_match_plain(B, H, W, C, Co, dtype):
    """The kernel with the `none` epilogue against its plain version at the World `proj_conv` sites (f32 abs 1e-4,
    bf16 2e-2 relative)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    w = (torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5).to(dtype)
    b = torch.rand(Co, device="cuda", generator=g) - 0.5
    got = conv3x3(x, w, b, False).float()
    ref = conv3x3_plain(x.float(), w.float(), b, False)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-2


@pytest.mark.parametrize("cfg", ["v8/yolov8-world.yaml", "v8/yolov8-worldv2.yaml"])
def test_world_serving_on_the_card_matches_the_cpu(cfg):
    """A narrow World graph (scale [0.33, 0.125, 1024], every layer kept) with a text table of 5 rows served on the card
    in f32 from two 720p frames at 256 (letterbox, the folded graph with its proj_conv sites, the contrastive heads,
    the NMS over 5 classes) against the same serving path on the CPU: one letterbox, one conv3x3 a site and one NMS
    launch, the rows matched tie-tolerantly (box 0.05 px, score 1e-4); then bf16 on the card, finite (B, 300, 6)
    rows labelled below 5."""
    import yaml

    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.nn import build_model
    from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites
    from lpc_yolo_tpu_torch.ops.nms import nms_greedy
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
    from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, load_flax, random_variables
    from lpc_yolo_tpu_torch.utils.text_embed import encode_names

    root = __import__("pathlib").Path(__file__).resolve().parents[1] / "lpc_yolo_tpu_torch" / "cfg" / "models"
    d = {**yaml.safe_load((root / cfg).read_text()), "scales": {"n": [0.33, 0.125, 1024]}, "scale": "n"}
    m = build_model(d, device="cpu")
    load_flax(m, random_variables(flax_shapes(m), seed=0))
    text = encode_names(["person", "bus", "car", "dog", "a red cone"])[None]
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(2)]
    card = Predictor(m, imgsz=256, batch=2, device="cuda", dtype=torch.float32, text=text)
    letterbox.launches = conv3x3.launches = nms_greedy.launches = 0
    got = card.infer(frames).cpu().numpy()
    torch.cuda.synchronize()
    assert (letterbox.launches, conv3x3.launches, nms_greedy.launches) == (1, len(conv3x3_sites(card.model)), 1)
    ref = Predictor(m, imgsz=256, batch=2, device="cpu", dtype=torch.float32, text=text).infer(frames).numpy()
    for a, b in zip(got, ref):
        n = int((b[:, 5] >= 0).sum())
        assert n > 0 and int((a[:, 5] >= 0).sum()) == n
        assert_detections_close(a[:n], b[:n], atol_box=0.05, atol_score=1e-4)
    half = Predictor(m, imgsz=256, batch=2, device="cuda", dtype=torch.bfloat16, text=text).infer(frames)
    assert half.shape == (2, 300, 6) and bool(torch.isfinite(half).all()) and half[..., 5].max().item() < 5


# (B, H, W, C, Co, k, stride, act, view): LPC-YOLO's int8 site shapes at batch 2 (a 3x3 s1 C2f bottleneck at
# 80^2, the 3x3 s2 LPC conv, the SPPF tail, a v10Detect 1x1 to 80 channels), ragged maps and Co, C no multiple
# of 16 (byte staging), a channel slice of a wider buffer and a 1x1 stride 2.
S8_CASES = [
    (2, 80, 80, 64, 64, 3, 1, "mish", False), (2, 40, 40, 128, 64, 3, 2, "mish", False),
    (2, 20, 20, 512, 256, 1, 1, "mish", False), (2, 20, 20, 384, 80, 1, 1, "silu", False),
    (2, 21, 23, 96, 70, 3, 1, "relu", True), (2, 21, 23, 90, 67, 3, 2, False, False), (1, 7, 9, 72, 33, 1, 2, "mish", True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,Co,k,s,act,view", S8_CASES)
def test_conv_s8_matches_plain(B, H, W, C, Co, k, s, act, view, dtype):
    """The s8 conv against its plain version (exact s32 sums, the same f32 epilogue): f32 out equal to 1e-6 of the
    largest value (expf / log1pf / tanhf against torch's), bf16 out within one ulp."""
    g = torch.Generator(device="cuda").manual_seed(0)
    buf = torch.randint(-127, 128, (B, H, W, C + (16 if view else 0)), dtype=torch.int8, device="cuda", generator=g)
    x8 = buf[..., 16:] if view else buf
    w8 = torch.randint(-127, 128, (Co, k, k, C), dtype=torch.int8, device="cuda", generator=g)
    sw = torch.rand(Co, device="cuda", generator=g) * 1e-3 + 1e-5
    b = torch.randn(Co, device="cuda", generator=g)
    before = conv_s8.launches
    got = conv_s8(x8, w8, sw, 0.0123, b, act, s, dtype).float()
    ref = conv_s8_plain(x8, w8, sw, 0.0123, b, act, s, torch.float32)
    torch.cuda.synchronize()
    assert conv_s8.launches == before + 1
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()
    else:
        ref16 = ref.to(torch.bfloat16).float()
        assert ((got - ref16).abs() <= ref16.abs() * 2 ** -7).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_s8_matches_plain(dtype):
    """Bit-exact into a channel slice (the rest of the buffer untouched), from a channel-strided view, and on
    exact ties (half to even)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(4, 33, 37, 80, device="cuda", generator=g) * 3).to(dtype)
    inv = 127 / 3.7
    out = torch.zeros(4, 33, 37, 200, dtype=torch.int8, device="cuda")
    before = quantize_s8.launches
    quantize_s8(x, inv, out=out[..., 37:117])
    ref = quantize_s8_plain(x, inv)
    assert torch.equal(out[..., 37:117], ref) and not out[..., :37].any() and not out[..., 117:].any()
    assert torch.equal(quantize_s8(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), inv), ref)
    ties = (torch.arange(-300, 300, device="cuda").float() + 0.5).reshape(1, 1, 600, 1).to(dtype)
    assert torch.equal(quantize_s8(ties, 1.0), quantize_s8_plain(ties, 1.0))
    assert quantize_s8.launches == before + 3
