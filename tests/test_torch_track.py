"""The port's trackers (`lpc_yolo_tpu_torch/trackers/`) and `YOLO.track` against the JAX package, on the CPU.

* The Kalman filters step by step, bit for bit.
* ByteTrack and BoT-SORT (GMC `none` and `sparseOptFlow`; ReID `hist` and
  `cnn` on the JAX encoder's bridged parameters) over three seeded detection
  sequences of 60 frames (objects that move, an occlusion that loses a track
  for 3 to 12 frames and finds it again, low-confidence frames the second
  stage rescues, false positives), each frame's rows (box, id, score, class,
  detection index) equal to the JAX tracker's bit for bit.
* The ReID pieces: the crops against cv2's resize bit for bit, calcHist's bin
  of every value 0..255 of each channel, the histogram embedding against the
  JAX one bit for bit, the CNN embedding within 1e-5 (f32) through `params=`
  and through a JAX-named `.npz`.
* `YOLO.track` (full-width yolov10n at imgsz 64) against the JAX
  `track_stream` fed the port's own per-frame Results, so that an f32 ulp
  between XLA's and torch's convs cannot change what the trackers see;
  `persist=True` keeping the tracker in the port, and the JAX facade
  restarting the ids on every call (its fault, ROADMAP Queue 3).
* What needs cv2 raises without it (sparseOptFlow), and what does not
  (GMC `none`, the histogram and CNN encoders) runs without it.
"""

import copy
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import cv2
from lpc_yolo_tpu.trackers import bot_sort as JBS
from lpc_yolo_tpu.trackers import byte_tracker as JBT
from lpc_yolo_tpu.trackers import kalman_filter as JKF
from lpc_yolo_tpu.trackers import reid as JREID
from lpc_yolo_tpu.trackers import track as JTRACK

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.trackers import bot_sort as TBS
from lpc_yolo_tpu_torch.trackers import byte_tracker as TBT
from lpc_yolo_tpu_torch.trackers import kalman_filter as TKF
from lpc_yolo_tpu_torch.trackers import reid as TREID
from lpc_yolo_tpu_torch.trackers import track as TTRACK
from lpc_yolo_tpu_torch.trackers.gmc import GMC
from lpc_yolo_tpu_torch.utils.flax_bridge import random_variables, flax_shapes

ROOT = Path(__file__).resolve().parents[1]
HW = (180, 240)  # the rendered frames' size
N_FRAMES = 60


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def render_sequence(seed: int):
    """A seeded clip and its detections: 5 objects of 3 classes moving at constant speed over a textured
    background that pans 0 to 2 px a frame; each object hidden for a window of 3 to 12 frames (the
    tracker loses it and must find it again), scored 0.15 to 0.45 on ~15% of its frames (the low stage's
    rescue) and 0.65 to 0.95 otherwise, its box jittered by up to 1.5 px; 0 to 2 false positives a frame.
    A list of (frame (h, w, 3) uint8 BGR, boxes (n, 4) f32, scores (n,) f32, classes (n,) f32), rows
    shuffled."""
    rng = np.random.default_rng(seed)
    h, w = HW
    texture = rng.integers(0, 256, (h + 80, w + 80, 3), dtype=np.uint8)
    texture = cv2.GaussianBlur(texture, (0, 0), 2.0)
    n_obj = 5
    size = rng.uniform([18, 18], [50, 60], (n_obj, 2))
    pos = rng.uniform([0, 0], [w - 60, h - 70], (n_obj, 2))
    vel = rng.uniform(-2.5, 2.5, (n_obj, 2))
    cls = rng.integers(0, 3, n_obj)
    colour = rng.integers(30, 230, (n_obj, 3))
    hidden = [(s, s + rng.integers(3, 13)) for s in rng.integers(8, N_FRAMES - 15, n_obj)]
    pan = np.cumsum(rng.integers(0, 3, (N_FRAMES, 2)), 0)
    out = []
    for t in range(N_FRAMES):
        ox, oy = pan[t] % 40
        frame = texture[oy:oy + h, ox:ox + w].copy()
        rows = []
        for k in range(n_obj):
            x1, y1 = pos[k] + vel[k] * t
            x1, y1 = float(np.clip(x1, 0, w - size[k, 0])), float(np.clip(y1, 0, h - size[k, 1]))
            x2, y2 = x1 + size[k, 0], y1 + size[k, 1]
            cv2.rectangle(frame, (int(x1), int(y1)), (int(x2), int(y2)), tuple(int(c) for c in colour[k]), -1)
            if hidden[k][0] <= t < hidden[k][1]:
                continue
            score = rng.uniform(0.15, 0.45) if rng.random() < 0.15 else rng.uniform(0.65, 0.95)
            jit = rng.uniform(-1.5, 1.5, 4)
            rows.append([x1 + jit[0], y1 + jit[1], x2 + jit[2], y2 + jit[3], score, cls[k]])
        for _ in range(rng.integers(0, 3)):
            x, y = rng.uniform(0, w - 30), rng.uniform(0, h - 30)
            rows.append([x, y, x + rng.uniform(10, 30), y + rng.uniform(10, 30), rng.uniform(0.1, 0.7),
                         rng.integers(0, 3)])
        rows = np.asarray(rows, np.float32)[rng.permutation(len(rows))]
        out.append((frame, rows[:, :4].copy(), rows[:, 4].copy(), rows[:, 5].copy()))
    return out


@pytest.fixture(scope="module")
def sequences():
    return {seed: render_sequence(seed) for seed in (0, 1, 2)}


@pytest.fixture(scope="module")
def cnn_encoders():
    """The JAX CNN encoder (its PRNGKey(42) parameters) and the port's on the same parameters, bridged."""
    jenc = JREID.CNNEncoder()
    params = jax_params(jenc)
    return jenc, TREID.CNNEncoder(params=params, device="cpu")


def jax_params(jenc):
    import jax

    return jax.tree_util.tree_map(np.asarray, dict(jenc._params))


def run_tracker(tracker, seq):
    return [tracker.update(b, s, c, img) for img, b, s, c in seq]


TRACKERS = {
    "bytetrack": (lambda enc: JBT.BYTETracker(), lambda enc: TBT.BYTETracker()),
    "botsort-none": (lambda enc: JBS.BOTSORT(gmc_method="none"), lambda enc: TBS.BOTSORT(gmc_method="none")),
    "botsort-sparseOptFlow": (lambda enc: JBS.BOTSORT(), lambda enc: TBS.BOTSORT()),
    "botsort-hist": (lambda enc: JBS.BOTSORT(gmc_method="none", with_reid=True, encoder=JREID.HistogramEncoder()),
                     lambda enc: TBS.BOTSORT(gmc_method="none", with_reid=True, encoder=TREID.HistogramEncoder())),
    "botsort-cnn": (lambda enc: JBS.BOTSORT(gmc_method="none", with_reid=True, encoder=enc[0]),
                    lambda enc: TBS.BOTSORT(gmc_method="none", with_reid=True, encoder=enc[1])),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", list(TRACKERS))
def test_tracker_rows_match_jax(kind, seed, sequences, request):
    """Every frame's rows [x1, y1, x2, y2, id, score, cls, det index] of the port's tracker are the JAX
    tracker's, bit for bit; the sequence loses tracks and finds them again under their old ids."""
    enc = request.getfixturevalue("cnn_encoders") if kind == "botsort-cnn" else None
    make_j, make_t = TRACKERS[kind]
    seq = sequences[seed]
    ref = run_tracker(make_j(enc), seq)
    got = run_tracker(make_t(enc), seq)
    for t, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and np.array_equal(a, b), f"{kind} seed {seed}: frame {t} differs"
    ids = [set(r[:, 4].astype(int)) for r in got]
    assert max(max(s, default=0) for s in ids) >= 4, "too few tracks"
    # a track that disappears for at least one frame and comes back under its id (re-acquired)
    gone_and_back = any(i in ids[t] and i not in ids[t + 1] and any(i in s for s in ids[t + 2:])
                        for t in range(len(ids) - 2) for i in ids[t])
    assert gone_and_back


def test_rescue_stage_runs(sequences):
    """The low-confidence stage matches a track on some frame of each sequence (a row whose score is below
    track_high_thresh), in the port as in JAX."""
    for seq in sequences.values():
        rows = run_tracker(TBT.BYTETracker(), seq)
        assert any((r[:, 5] < 0.5).any() for r in rows)


@pytest.mark.parametrize("kf", ["XYAH", "XYWH"])
def test_kalman_filters_step_by_step(kf):
    """initiate, predict, multi_predict, project and update of the port's filter on seeded measurements:
    every mean and covariance bitwise the JAX filter's."""
    rng = np.random.default_rng(3)
    j, t = getattr(JKF, f"KalmanFilter{kf}")(), getattr(TKF, f"KalmanFilter{kf}")()
    meas = rng.uniform([10, 10, 0.3, 10], [200, 200, 2.0, 80], (5, 4))
    if kf == "XYWH":
        meas[:, 2] = meas[:, 2] * meas[:, 3]
    states = []
    for m in meas:
        a, b = j.initiate(m), t.initiate(m)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        states.append(a)
    for step in range(6):
        means = np.stack([s[0] for s in states])
        covs = np.stack([s[1] for s in states])
        a, b = j.multi_predict(means.copy(), covs.copy()), t.multi_predict(means.copy(), covs.copy())
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        for i, (m, c) in enumerate(zip(*a)):
            p = j.predict(m, c), t.predict(m, c)
            assert all(np.array_equal(x, y) for x, y in zip(*p))
            q = j.project(m, c), t.project(m, c)
            assert all(np.array_equal(x, y) for x, y in zip(*q))
            z = meas[i] + rng.normal(0, 1, 4) * [1, 1, 0.01, 1]
            u = j.update(m, c, z), t.update(m, c, z)
            assert all(np.array_equal(x, y) for x, y in zip(*u))
            states[i] = u[0]


def test_crops_match_cv2():
    """`_crop_resize` (cvops.resize) against the JAX one (cv2.resize) bit for bit: boxes inside, across the
    frame's edges, past them, of one pixel, and an exact 2x downscale (cv2's INTER_AREA switch)."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (150, 200, 3), dtype=np.uint8)
    boxes = np.array([[10, 20, 60, 110], [-15, -5, 30, 40], [180, 120, 260, 190], [50.7, 60.2, 51.1, 60.9],
                      [0, 0, 128, 256], [20, 10, 148, 266], [199.5, 149.5, 220, 170], [3.3, 4.4, 99.9, 140.1]],
                     np.float32)
    boxes = np.concatenate([boxes, np.sort(rng.uniform(-20, 220, (24, 2, 2)), 1).transpose(0, 2, 1).reshape(24, 4)])
    assert np.array_equal(TREID._crop_resize(img, boxes).numpy(), JREID._crop_resize(img, boxes))


@pytest.mark.parametrize("channel", [0, 1, 2])
def test_hist_bins_match_calchist(channel):
    """The bin cv2.calcHist gives every value 0..255 of H (8 bins over [0, 180)), S (8 over [0, 256)) and
    V (4 over [0, 256)): values at the bin edges included; H values 180..255 fall outside its range."""
    bins, rng_ = TREID.HIST_BINS[channel], TREID.HIST_RANGES[channel]
    table = TREID.hist_bins(bins, *rng_)
    for v in range(256):
        hist = cv2.calcHist([np.full((1, 1), v, np.uint8)], [0], None, [bins], list(map(float, rng_))).ravel()
        assert table[v] == (int(np.argmax(hist)) if hist.sum() else -1), f"value {v}"


def test_hist_encoder_matches_jax():
    """The histogram embedding of the port (no cv2) against the JAX one (cv2's resize, cvtColor, calcHist),
    bit for bit, on a frame whose crops hold every hue."""
    rng = np.random.default_rng(6)
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(0, 256, 2), indexing="ij"), -1).astype(np.uint8)
    img = cv2.cvtColor(np.concatenate([hsv, np.full(hsv.shape[:2] + (1,), 200, np.uint8)], -1), cv2.COLOR_HSV2BGR)
    img = np.concatenate([img, rng.integers(0, 256, img.shape, dtype=np.uint8)], 1)
    boxes = np.array([[0, 0, 128, 180], [10, 5, 40, 70], [128, 0, 256, 180], [100, 100, 200, 170], [3, 3, 4, 4]],
                     np.float32)
    assert np.array_equal(TREID.HistogramEncoder()(img, boxes), JREID.HistogramEncoder()(img, boxes))


def test_cnn_encoder_matches_jax(cnn_encoders, tmp_path):
    """The port's ReIDNet on the JAX encoder's bridged PRNGKey(42) parameters against the JAX encoder:
    embeddings within 1e-5 (f32, unit rows), through `params=` and through an `.npz` of JAX-named leaves
    (`params_path`; leaves it lacks keep the port's own)."""
    jenc, tenc = cnn_encoders
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (160, 220, 3), dtype=np.uint8)
    boxes = np.array([[5, 5, 60, 130], [100, 20, 210, 70], [50, 50, 51, 51], [0, 0, 220, 160], [30, 90, 90, 150]],
                     np.float32)
    ref = jenc(img, boxes)
    got = tenc(img, boxes)
    assert got.shape == ref.shape == (5, 128)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    params = jax_params(jenc)
    flat = {f"params/{m}/{leaf}": v for m, leaves in params["params"].items() for leaf, v in leaves.items()}
    np.savez(tmp_path / "reid.npz", **flat)
    from_file = TREID.CNNEncoder(params_path=str(tmp_path / "reid.npz"), device="cpu")
    np.testing.assert_allclose(from_file(img, boxes), ref, rtol=0, atol=1e-5)
    own = TREID.CNNEncoder(device="cpu")  # no parameters given: random_variables of seed 42
    expect = TREID.CNNEncoder(params=random_variables(flax_shapes(TREID.ReIDNet()), TREID.REID_SEED), device="cpu")
    assert np.array_equal(own(img, boxes), expect(img, boxes))
    assert np.allclose(np.linalg.norm(got, axis=1), 1, atol=1e-6)


def test_tracker_configs_and_cv2_free_paths(monkeypatch):
    """The port's tracker YAMLs are byte copies of the JAX ones; `make_tracker` builds each (by name, path
    and dict, with a ReID encoder when asked). Without cv2, GMC `none`, the histogram encoder and a BoT-SORT
    with them run, and `sparseOptFlow` raises an ImportError that names it; an unknown method raises (the JAX
    GMC returns the identity for it)."""
    for name in ("bytetrack.yaml", "botsort.yaml"):
        ours = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "trackers" / name
        assert ours.read_bytes() == (ROOT / "lpc_yolo_tpu" / "cfg" / "trackers" / name).read_bytes()
        assert type(TTRACK.make_tracker(name)).__name__ == type(JTRACK.make_tracker(name)).__name__
        assert type(TTRACK.make_tracker(str(ours))).__name__ == type(JTRACK.make_tracker(name)).__name__
    bot = TTRACK.make_tracker({"tracker_type": "botsort", "with_reid": True, "reid_encoder": "cnn", "gmc_method": "none"},
                              device="cpu")
    assert isinstance(bot.encoder, TREID.CNNEncoder) and bot.with_reid
    with pytest.raises(ValueError, match="tracker_type"):
        TTRACK.make_tracker({"tracker_type": "sort"})
    with pytest.raises(ValueError, match="unknown GMC method"):
        GMC("optflow")
    from lpc_yolo_tpu.trackers.gmc import GMC as JaxGMC

    # the JAX GMC takes the typo and compensates nothing (a JAX fault, ROADMAP Queue 3)
    assert np.array_equal(JaxGMC("optflow").apply(np.zeros((8, 8, 3), np.uint8)), np.eye(2, 3))
    seq = render_sequence(4)[:5]
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    hist = TTRACK.make_tracker({"tracker_type": "botsort", "gmc_method": "none", "with_reid": True})
    assert isinstance(hist.encoder, TREID.HistogramEncoder)
    assert sum(len(r) for r in run_tracker(hist, seq)) > 0
    with pytest.raises(ImportError, match="GMC sparseOptFlow"):
        run_tracker(TBS.BOTSORT(), seq)


# -- YOLO.track ---------------------------------------------------------------------------------------------

S = 64
TRACK_CFG = {"tracker_type": "bytetrack", "track_high_thresh": 0.45, "track_low_thresh": 0.3,
             "new_track_thresh": 0.5, "track_buffer": 30, "match_thresh": 0.8, "fuse_score": True}


@pytest.fixture(scope="module")
def v10n():
    return YOLO("yolov10n.yaml", device="cpu", seed=0)


def clip(n: int = 8, seed: int = 21):
    """A 96x128 frame panned 3 px a frame."""
    base = np.random.default_rng(seed).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    return [np.ascontiguousarray(np.roll(base, 3 * i, axis=1)) for i in range(n)]


@pytest.mark.parametrize("tracker", ["bytetrack", "botsort"])
def test_track_matches_jax_track_stream(v10n, tracker):
    """`YOLO.track(stream=True)` yields one Results a frame, each with boxes [x1, y1, x2, y2, id, conf, cls];
    its rows equal those of the JAX `track_stream` fed the port's own per-frame detections (`predict`
    at conf 0.3, batch 1, copied before either tracker sees them)."""
    frames = clip()
    cfg = dict(TRACK_CFG) if tracker == "bytetrack" else {**TRACK_CFG, "tracker_type": "botsort",
                                                            "gmc_method": "sparseOptFlow"}
    gen = v10n.track(frames, tracker=cfg, conf=0.3, imgsz=S, max_det=40, stream=True)
    assert isinstance(gen, types.GeneratorType)
    got = []
    for r in gen:  # frame by frame
        got.append(r)
        assert len(got) <= len(frames)
    dets = v10n.predict(frames, conf=0.3, imgsz=S, max_det=40, batch=1)
    ref = list(JTRACK.track_stream(iter(copy.deepcopy(dets)), tracker_cfg=cfg))
    assert len(got) == len(ref) == len(frames)
    for a, b in zip(got, ref):
        assert a.boxes.data.shape[1] == 7 and np.array_equal(a.boxes.data, b.boxes.data)
        assert np.array_equal(a.boxes.id, a.boxes.data[:, 4])
    assert max(len(r) for r in got) > 0


def test_persist_keeps_ids_and_jax_restarts_them(v10n, monkeypatch):
    """Two `track(..., persist=True)` calls over two halves of a clip: the port's second call goes on with
    the first call's tracker (its ids continue and are those of one call over the whole clip); the JAX
    facade's `track` builds a tracker on every call, so its second call's ids start again at 1 (a JAX
    fault: ROADMAP Queue 3). The JAX facade runs on the port's detections (its `predict` replaced)."""
    import lpc_yolo_tpu.engine.model as jax_model

    frames = clip(10)
    kw = dict(tracker=TRACK_CFG, conf=0.3, imgsz=S, max_det=40)
    whole = [r.boxes.data for r in v10n.track(frames, **kw)]
    first = [r.boxes.data for r in v10n.track(frames[:5], **kw)]
    second = [r.boxes.data for r in v10n.track(frames[5:], persist=True, **kw)]
    assert all(np.array_equal(a, b) for a, b in zip(first + second, whole))
    fresh = [r.boxes.data for r in v10n.track(frames[5:], persist=False, **kw)]
    assert min(r[:, 4].min() for r in fresh if len(r)) == 1
    assert not all(np.array_equal(a, b) for a, b in zip(fresh, second))

    dets = v10n.predict(frames, conf=0.3, imgsz=S, max_det=40, batch=1)
    jy = object.__new__(jax_model.YOLO)
    monkeypatch.setattr(jy, "predict", lambda source, **k: iter(copy.deepcopy(source)), raising=False)
    j1 = jy.track(dets[:5], tracker=TRACK_CFG)
    j2 = jy.track(dets[5:], tracker=TRACK_CFG, persist=True)
    assert all(np.array_equal(a.boxes.data, b) for a, b in zip(j1, first))
    assert all(np.array_equal(a.boxes.data, b) for a, b in zip(j2, fresh))  # restarted, as persist=False


def test_track_results_api_on_track_rows(v10n, tmp_path):
    """A tracked Results carries the ids everywhere the JAX one does: `summary` track_id, `plot` labels
    "id:<k> ", `save_txt` rows; `track(stream=False)` gives the list."""
    out = v10n.track(clip(4), tracker=TRACK_CFG, conf=0.3, imgsz=S, max_det=40)
    assert isinstance(out, list) and len(out) == 4
    r = next(x for x in out if len(x))
    s = r.summary()
    assert [d["track_id"] for d in s] == r.boxes.id.astype(int).tolist()
    assert r.plot().shape == r.orig_img.shape
