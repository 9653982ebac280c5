"""The port's evaluation modules against the JAX package's, on the CPU, on
the same seeded numpy inputs:

- eval/metrics.py: `fitness`, `box_iou_np`, `match_predictions`,
  `ap_per_class`, `compute_ap`, `ConfusionMatrix` — exact (both sides
  are the same float64 numpy);
- eval/widerface.py on synthetic prediction directories and ground-truth
  `.mat` files written with `scipy.io.savemat` (`chip_smoke.
  write_widerface_gt`, the fixture chip_smoke's phase 21 scores against):
  `load_gt`, `read_pred_file` / `load_preds`, `norm_scores`,
  `image_eval`, `img_pr_info`, `voc_ap`, `evaluation` and
  `write_pred_file` (byte for byte) — exact; `evaluation` through the
  native IoU and through numpy alike; the port's CLI
  `cli.evaluate_widerface` prints the JAX CLI's block and gates alike;
- native/ (the g++ library, gated as tests/test_native.py gates it):
  `bbox_overlaps_plus1` on disjoint, nested, touching, degenerate and
  empty box sets — exact against the JAX package's library (the same
  C++ function), and within 1e-12 of the numpy IoU (another op order);
  the library raises rather than fall back when it is unavailable;
- data/dataset.py on `data/synthetic.make_synthetic_face_dataset` output
  (square images, and a copy with images resized to other aspect ratios,
  whose normalized labels stay right): `FaceDataset.get` items,
  `batch_shapes`, `collate` and the serial, thread and process
  `DataLoader` batches — exact, square and `rect` (pad 0.5); each package builds from
  its own copy of the folder, so the `.labels.npz` caches are not shared;
  `scale_coords(..., kpt=True, step=3)` on the rect items' geometry —
  exact; `augment=True` raises naming ROADMAP module 8.
"""

import io
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest

import chip_smoke
from face_detection_multi_scale_tpu import native as JNAT
from face_detection_multi_scale_tpu.data import dataset as JD
from face_detection_multi_scale_tpu.data import letterbox as JLB
from face_detection_multi_scale_tpu.data.synthetic import (
    make_synthetic_face_dataset)
from face_detection_multi_scale_tpu.eval import metrics as JMET
from face_detection_multi_scale_tpu.eval import widerface as JWF
from face_detection_multi_scale_tpu_torch import native as TNAT
from face_detection_multi_scale_tpu_torch.data import dataset as TD
from face_detection_multi_scale_tpu_torch.data import letterbox as TLB
from face_detection_multi_scale_tpu_torch.eval import metrics as TMET
from face_detection_multi_scale_tpu_torch.eval import widerface as TWF

needs_native = pytest.mark.skipif(
    not (JNAT.available() and TNAT.available()),
    reason="native toolchain unavailable")


def exact(a, b):
    """Equal values of equal type and shape, through tuples, lists, dicts
    and object arrays (numpy arrays bit for bit, NaN equal to NaN)."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), \
        (type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            exact(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            exact(x, y)
    elif a is None:
        assert b is None
    elif isinstance(a, np.ndarray) and a.dtype == object:  # .mat cells
        assert a.shape == b.shape and b.dtype == object
        for x, y in zip(a.ravel(), b.ravel()):
            exact(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def boxes_xyxy(rng, n, lo=0, hi=500, wmin=5, wmax=100):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(wmin, wmax, (n, 2))], 1)


# ---------------------------------------------------------------------------
# eval/metrics.py
# ---------------------------------------------------------------------------

def test_metrics_constants_and_fitness():
    exact(TMET.IOUV, JMET.IOUV)
    assert TMET.fitness(0.1, 0.2, 0.5, 0.3) == JMET.fitness(0.1, 0.2, 0.5,
                                                            0.3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_predictions_and_box_iou(seed):
    rng = np.random.default_rng(seed)
    gt = boxes_xyxy(rng, 12)
    gt_cls = rng.integers(0, 2, 12).astype(np.float64)
    # predictions near the ground truth and elsewhere, two classes
    near = gt[rng.integers(0, 12, 20)] + rng.normal(0, 6, (20, 4))
    pred = np.concatenate([near, boxes_xyxy(rng, 10)])
    pred = np.concatenate([pred, rng.uniform(0, 1, (30, 1)),
                           rng.integers(0, 2, (30, 1))], 1)
    exact(TMET.box_iou_np(pred[:, :4], gt), JMET.box_iou_np(pred[:, :4], gt))
    got = TMET.match_predictions(pred, gt, gt_cls)
    exact(got, JMET.match_predictions(pred, gt, gt_cls))
    assert got.any()
    exact(TMET.match_predictions(pred[:0], gt, gt_cls),
          JMET.match_predictions(pred[:0], gt, gt_cls))


@pytest.mark.parametrize("nc", [1, 3])
def test_ap_per_class_and_compute_ap(nc):
    rng = np.random.default_rng(10 + nc)
    n = 400
    tp = rng.uniform(0, 1, (n, 10)) < np.linspace(0.8, 0.2, 10)
    conf = rng.uniform(0, 1, n)
    pred_cls = rng.integers(0, nc, n).astype(np.float64)
    target_cls = rng.integers(0, nc, 150).astype(np.float64)
    exact(TMET.ap_per_class(tp, conf, pred_cls, target_cls),
          JMET.ap_per_class(tp, conf, pred_cls, target_cls))
    recall = np.sort(rng.uniform(0, 1, 50))
    precision = rng.uniform(0, 1, 50)
    exact(TMET.compute_ap(recall, precision),
          JMET.compute_ap(recall, precision))


def test_confusion_matrix():
    rng = np.random.default_rng(3)
    port, ref = TMET.ConfusionMatrix(3), JMET.ConfusionMatrix(3)
    for _ in range(4):
        gt = boxes_xyxy(rng, 8)
        labels = np.concatenate([rng.integers(0, 3, (8, 1)), gt], 1)
        det = gt[rng.integers(0, 8, 10)] + rng.normal(0, 4, (10, 4))
        det = np.concatenate([det, rng.uniform(0, 1, (10, 1)),
                              rng.integers(0, 3, (10, 1))], 1)
        port.process_batch(det, labels)
        ref.process_batch(det, labels)
    exact(port.values(), ref.values())
    assert port.values().sum() > 0


# ---------------------------------------------------------------------------
# eval/widerface.py
# ---------------------------------------------------------------------------

def synthetic_protocol(root, seed=0, n_events=3, n_images=5):
    """A prediction directory (written with the JAX writer) and the four
    ground-truth .mat files: events of images with (x, y, w, h) faces,
    predictions near some faces and elsewhere, keep lists per setting,
    an image with no faces and one with no predictions."""
    rng = np.random.default_rng(seed)
    pred_dir, gt_dir = root / "pred", root / "gt"
    events = {}
    for e in range(n_events):
        event = f"{e}--Event{e}"
        images = []
        for j in range(n_images):
            name = f"{e}_img_{j}"
            n_gt = 0 if (e, j) == (0, 1) else int(rng.integers(2, 12))
            gt = boxes_xyxy(rng, n_gt, hi=800, wmin=4, wmax=120)
            gt_xywh = np.concatenate([gt[:, :2], gt[:, 2:] - gt[:, :2]], 1)
            keep = {s: np.sort(rng.choice(np.arange(1, n_gt + 1),
                                          size=int(rng.integers(0, n_gt + 1)),
                                          replace=False))
                    for s in ("easy", "medium", "hard")} if n_gt else \
                {s: np.zeros(0, int) for s in ("easy", "medium", "hard")}
            images.append((name, np.round(gt_xywh), keep))
            n_near = 0 if (e, j) == (1, 2) else int(rng.integers(0, n_gt + 1))
            near = gt[rng.integers(0, max(n_gt, 1), n_near)] \
                + rng.normal(0, 3, (n_near, 4)) if n_gt else np.zeros((0, 4))
            far = boxes_xyxy(rng, 0 if (e, j) == (1, 2) else 6, hi=800)
            rows = np.concatenate([near, far])
            conf = rng.uniform(0.0, 1.3, (len(rows), 1))  # > 1 clamps
            rows = np.concatenate([rows, conf], 1)[np.argsort(-conf[:, 0])]
            JWF.write_pred_file(str(pred_dir / event / f"{name}.txt"), name,
                                rows)
        events[event] = images
    chip_smoke.write_widerface_gt(str(gt_dir), events)
    return str(pred_dir), str(gt_dir)


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    return synthetic_protocol(tmp_path_factory.mktemp("wider"))


def test_load_gt_and_preds(protocol):
    pred_dir, gt_dir = protocol
    exact(TWF.load_gt(gt_dir), JWF.load_gt(gt_dir))
    got, want = TWF.load_preds(pred_dir), JWF.load_preds(pred_dir)
    exact(got, want)
    TWF.norm_scores(got)
    JWF.norm_scores(want)
    exact(got, want)


def test_image_eval_pr_info_voc_ap(protocol):
    pred_dir, gt_dir = protocol
    preds = JWF.load_preds(pred_dir)
    JWF.norm_scores(preds)
    facebox, _, _, keep = JWF.load_gt(gt_dir)
    pred = preds["0--Event0"]["0_img_0"]
    gt = facebox[0][0][0][0].astype(np.float64)
    ignore = np.zeros(len(gt), np.int64)
    ignore[keep["hard"][0][0][0][0].reshape(-1) - 1] = 1
    got = TWF.image_eval(pred, gt, ignore, 0.5)
    exact(got, JWF.image_eval(pred, gt, ignore, 0.5))
    exact(TWF.img_pr_info(pred[:, 4], got[1], got[0]),
          JWF.img_pr_info(pred[:, 4], got[1], got[0]))
    rng = np.random.default_rng(4)
    rec, prec = np.sort(rng.uniform(0, 1, 40)), rng.uniform(0, 1, 40)
    assert TWF.voc_ap(rec, prec) == JWF.voc_ap(rec, prec)


def test_evaluation_matches_jax_native_or_numpy(protocol, monkeypatch):
    pred_dir, gt_dir = protocol
    want = JWF.evaluation(pred_dir, gt_dir, verbose=False)
    got = TWF.evaluation(pred_dir, gt_dir, verbose=False)
    assert got == want
    assert 0 < min(got.values()) and max(got.values()) < 1
    # the port's _overlaps without the native library: numpy, same APs
    monkeypatch.setattr(TNAT, "available", lambda: False)
    assert TWF.evaluation(pred_dir, gt_dir, verbose=False) == want


def test_write_pred_file_byte_for_byte(tmp_path):
    rng = np.random.default_rng(6)
    rows = np.concatenate([boxes_xyxy(rng, 30, wmin=0.2, wmax=90),
                           rng.uniform(0, 1.4, (30, 1))], 1)
    rows[0, :4] = [0.5, 1.5, 2.49999, 3.5]  # the int(x + 0.5) edges
    for pkg, name in ((TWF, "port"), (JWF, "jax")):
        pkg.write_pred_file(str(tmp_path / name / "ev" / "a.txt"), "a",
                            rows)
        pkg.write_pred_file(str(tmp_path / name / "ev" / "b.txt"), "b",
                            rows[:0])
    for f in ("a", "b"):
        assert (tmp_path / "port" / "ev" / f"{f}.txt").read_bytes() == \
            (tmp_path / "jax" / "ev" / f"{f}.txt").read_bytes()
    exact(TWF.read_pred_file(str(tmp_path / "port" / "ev" / "a.txt")),
          JWF.read_pred_file(str(tmp_path / "jax" / "ev" / "a.txt")))


def test_evaluate_widerface_cli_matches_jax(protocol):
    import cli.evaluate_widerface as jcli
    from face_detection_multi_scale_tpu_torch.cli import (
        evaluate_widerface as tcli)

    pred_dir, gt_dir = protocol
    aps = JWF.evaluation(pred_dir, gt_dir, verbose=False)
    for gate in ([], ["--expect-hard", str(aps["hard"] + 0.01)]):
        argv = ["-p", pred_dir, "-g", gt_dir] + gate
        outs = []
        for mod in (tcli, jcli):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = mod.main(argv)
            outs.append((rc, buf.getvalue()))
        assert outs[0] == outs[1]
        assert outs[0][0] == (1 if gate else 0)
        assert "Hard   Val AP" in outs[0][1]


# ---------------------------------------------------------------------------
# native/
# ---------------------------------------------------------------------------

def overlap_cases(case):
    """(boxes, query) for one IoU case."""
    rng = np.random.default_rng(0)
    if case == "random":
        return boxes_xyxy(rng, 40), boxes_xyxy(rng, 23)
    if case == "empty":
        return boxes_xyxy(rng, 0), boxes_xyxy(rng, 5)
    if case == "no_query":
        return boxes_xyxy(rng, 7), boxes_xyxy(rng, 0)
    # integer boxes: nested, shared edges (iw or ih exactly 0 or 1 with the
    # +1 convention), duplicates, zero-width and point boxes
    b = np.round(boxes_xyxy(rng, 48, hi=60, wmin=0, wmax=12))
    b[8:16] = b[:8]
    b[16:20, 2] = b[16:20, 0]
    b[20:24, 2:] = b[20:24, :2]
    b[24:32, 0] = b[:8, 2] + 1
    b[32:40, 1] = b[:8, 3]
    return b, b[::-1].copy()


@needs_native
@pytest.mark.parametrize("case", ["random", "empty", "no_query",
                                  "edges"])
def test_native_bbox_overlaps(case):
    boxes, query = overlap_cases(case)
    got = TNAT.bbox_overlaps_plus1(boxes, query)
    assert got.shape == (len(boxes), len(query))
    exact(got, JNAT.bbox_overlaps_plus1(boxes, query))
    np.testing.assert_allclose(got, TWF.bbox_overlaps_plus1(boxes, query),
                               rtol=1e-12)  # numpy, another op order
    if case == "edges":
        assert (got == 0).any() and (got == 1).any() and \
            ((0 < got) & (got < 1)).any()


def test_native_raises_without_the_library(monkeypatch):
    """No second fallback: without the library the binding raises, and
    evaluation's numpy route is widerface._overlaps's alone."""
    monkeypatch.setattr(TNAT, "load", lambda: None)
    assert not TNAT.available()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        TNAT.bbox_overlaps_plus1(*overlap_cases("random"))
    boxes, query = overlap_cases("edges")
    exact(TWF._overlaps(boxes, query), TWF.bbox_overlaps_plus1(boxes, query))


def test_native_library_builds_into_the_port():
    """The port's IoU function equals the JAX package's source text, and
    its library lands in the port's gitignored _build/."""
    def iou_function(path):
        src = open(path).read()
        start = src.index("// Pairwise IoU with the +1 pixel area convention.")
        return src[start:src.index("\n}\n", start) + 3]

    assert TNAT.library_path().parent.name == "_build"
    assert iou_function(TNAT.SRC) == iou_function(JNAT.SRC)


# ---------------------------------------------------------------------------
# data/dataset.py
# ---------------------------------------------------------------------------

ASPECTS = ((96, 128), (128, 80), (128, 128), (72, 128), (128, 112),
           (112, 128), (128, 96), (128, 64), (100, 128))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(square val dir, mixed-aspect val dir) for each package: the
    synthetic dataset once, copied per package; the mixed copy resizes
    each image to another aspect ratio (normalized labels unchanged)."""
    import cv2
    import yaml

    root = tmp_path_factory.mktemp("faces")
    data = yaml.safe_load(open(make_synthetic_face_dataset(
        str(root / "base"), n_images=18, img_size=128, val_fraction=0.5,
        seed=3)))
    val = root / "base" / "val"
    out = {}
    for pkg in ("port", "jax"):
        square = root / pkg / "square"
        mixed = root / pkg / "mixed"
        shutil.copytree(val, square)
        shutil.copytree(val, mixed)
        for i, p in enumerate(sorted((mixed / "images").rglob("*.jpg"))):
            h, w = ASPECTS[i % len(ASPECTS)]
            cv2.imwrite(str(p), cv2.resize(cv2.imread(str(p)), (w, h)))
        out[pkg] = (str(square / "images"), str(mixed / "images"))
    assert data["val"] == str(val / "images")
    return out


def datasets(corpora, which, **kw):
    return (TD.FaceDataset(corpora["port"][which], **kw),
            JD.FaceDataset(corpora["jax"][which], **kw))


def same_item(got, want):
    (gi, gl, gp, gs), (wi, wl, wp, ws) = got, want
    exact(gi, wi)
    exact(gl, wl)
    assert gp.split("/")[-3:] == wp.split("/")[-3:]  # the package's copy
    exact(gs, ws)


@pytest.mark.parametrize("rect", [False, True])
def test_dataset_items_and_batch_shapes(corpora, rect):
    kw = dict(img_size=128, augment=False, hyp={}, kpt_label=5, stride=32,
              rect=rect, batch_size=4, pad=0.5 if rect else 0.0)
    port, ref = datasets(corpora, 1, **kw)
    assert len(port) == len(ref) == 9
    exact(port.batch_shapes, ref.batch_shapes)
    exact(port.shapes, ref.shapes)
    exact(port.labels, ref.labels)
    if rect:
        assert len({tuple(s) for s in port.batch_shapes}) > 1
    for i in range(len(port)):
        same_item(port.get(i), ref.get(i))
    # the second build reads each package's own label cache
    again = TD.FaceDataset(corpora["port"][1], **kw)
    exact(again.labels, port.labels)


@pytest.mark.parametrize("workers,mode", [(1, "thread"), (3, "thread"),
                                          (2, "process")])
def test_dataset_loader_batches(corpora, workers, mode):
    """The port's loader (serial, a thread pool, worker processes) gives
    the JAX serial loader's batches, in order and shuffled."""
    kw = dict(img_size=128, augment=False, hyp={}, kpt_label=5, stride=32,
              batch_size=4)
    port, ref = datasets(corpora, 0, **kw)
    for shuffle in (False, True):
        want = list(JD.DataLoader(ref, 4, shuffle=shuffle, seed=5,
                                  drop_last=False, workers=1))
        loader = TD.DataLoader(port, 4, shuffle=shuffle, seed=5,
                               drop_last=False, workers=workers, mode=mode)
        try:
            got = list(loader)
        finally:
            loader.close()
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            exact(g[0], w[0])
            exact(g[1], w[1])
            exact(g[3], w[3])
            assert [p.split("/")[-1] for p in g[2]] == \
                [p.split("/")[-1] for p in w[2]]
    exact(TD.collate([port.get(0), port.get(1)])[1],
          JD.collate([ref.get(0), ref.get(1)])[1])


def test_scale_coords_keypoints_on_rect_batches(corpora):
    kw = dict(img_size=128, augment=False, hyp={}, kpt_label=5, stride=32,
              rect=True, batch_size=4, pad=0.5)
    port, _ = datasets(corpora, 1, **kw)
    rng = np.random.default_rng(9)
    for i in range(len(port)):
        img, _, _, ((h0, w0), ratio_pad) = port.get(i)
        h_in, w_in = img.shape[:2]
        kpts = np.concatenate([rng.uniform(-10, w_in + 10, (7, 5, 1)),
                               rng.uniform(-10, h_in + 10, (7, 5, 1)),
                               rng.uniform(0, 1, (7, 5, 1))], 2)
        kpts = kpts.reshape(7, 15)
        got = TLB.scale_coords((h_in, w_in), kpts.copy(), (h0, w0),
                               ratio_pad=ratio_pad, kpt=True, step=3)
        want = JLB.scale_coords((h_in, w_in), kpts.copy(), (h0, w0),
                                ratio_pad=ratio_pad, kpt=True, step=3)
        exact(got, want)
        exact(got[:, 2::3], kpts[:, 2::3])  # the confidences stay


def test_dataset_helpers(tmp_path):
    paths = ["/d/images/ev/a.jpg", "/d/images/x/images/b.png"]
    exact(TD.img2label_paths(paths), JD.img2label_paths(paths))
    assert TD.IMG_FORMATS == JD.IMG_FORMATS
    lab = tmp_path / "l.txt"
    lab.write_text("0 0.5 0.5 0.2 0.3 0.45 0.42 2 0.55 0.42 2 0.5 0.5 2 "
                   "0.46 0.58 2 0.54 0.58 2\n0 0.2 0.2 0.1 0.1 " +
                   "0 0 0 " * 5 + "\n")
    exact(TD.load_label_file(str(lab), 5), JD.load_label_file(str(lab), 5))
    exact(TD.load_label_file(str(tmp_path / "none.txt"), 5),
          JD.load_label_file(str(tmp_path / "none.txt"), 5))
    assert TD._files_hash(paths) == JD._files_hash(paths)


def test_dataset_augment_raises_naming_module_8(corpora):
    """The augmenting FaceDataset, once module 8's NotImplementedError, is
    ported: on the mixed-aspect corpus with mosaic, mixup, a warp and the
    flips, each sample equals the JAX package's under the same seeds
    (images bit for bit, labels within 1e-6). What module 8 still lacks,
    training over several processes, raises naming it; bf16 training,
    ported since, does not."""
    import argparse
    import random

    import torch

    from face_detection_multi_scale_tpu_torch.cli import train

    hyp = {"mosaic": 0.7, "mixup": 0.5, "degrees": 5.0, "scale": 0.3,
           "translate": 0.1, "fliplr": 0.5, "flipud": 0.5, "hsv_h": 0.015,
           "hsv_s": 0.7, "hsv_v": 0.4}
    t = TD.FaceDataset(corpora["port"][1], img_size=128, augment=True,
                       hyp=hyp)
    j = JD.FaceDataset(corpora["jax"][1], img_size=128, augment=True,
                       hyp=hyp)
    for i in range(len(t)):
        samples = []
        for ds in (t, j):
            random.seed(i)
            np.random.seed(i)
            samples.append(ds.get(i))
        assert np.array_equal(samples[0][0], samples[1][0])
        np.testing.assert_allclose(samples[0][1], samples[1][1], atol=1e-6)
    args = argparse.Namespace(dtype="bfloat16", device="cpu")
    assert train._device(args) == torch.device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.distributed, "is_initialized", lambda: True)
        mp.setattr(torch.distributed, "get_world_size", lambda: 2)
        with pytest.raises(NotImplementedError, match="module 8"):
            train._device(args)
