"""The port's training data and tools against the JAX package on the CPU:
the augmenting FaceDataset and its loader, the augmentation primitives,
autoanchor, the label weights, the synthetic set, hyperparameter
evolution; the checkpoints and the stripped inference weights; and
`cli.train --device cpu` end to end (train, validate, checkpoint,
resume, evolve).

Augmentation draws from the global `random` / `np.random` in the
reference's order, so the same seeds give the same batches: images bit
for bit, labels within 1e-6. The stripped weights are the JAX package's
.npz layout, key for key."""

import argparse
import json
import random
import sys

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.data import dataset as JD
from face_detection_multi_scale_tpu.data.synthetic import (
    make_synthetic_face_dataset as j_synthetic)
from face_detection_multi_scale_tpu.train import autoanchor as JA
from face_detection_multi_scale_tpu.train import checkpoint as JC
from face_detection_multi_scale_tpu.train import evolve as JE
from face_detection_multi_scale_tpu.train.hyp import PRESETS, get_hyp
from face_detection_multi_scale_tpu.utils import general as JG
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu_torch.cli import train as TCLI
from face_detection_multi_scale_tpu_torch.data import dataset as TD
from face_detection_multi_scale_tpu_torch.data.synthetic import (
    make_synthetic_face_dataset as t_synthetic)
from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict, load_inference_weights)
from face_detection_multi_scale_tpu_torch.train import autoanchor as TA
from face_detection_multi_scale_tpu_torch.train import checkpoint as TC
from face_detection_multi_scale_tpu_torch.train import evolve as TE
from face_detection_multi_scale_tpu_torch.train import hyp as TH
from face_detection_multi_scale_tpu_torch.train import trainer as TR
from face_detection_multi_scale_tpu_torch.utils import general as TG
from face_detection_multi_scale_tpu_torch.utils.profiling import (
    MetricsLogger)

from test_torch_model import narrowed, random_variables

LABEL_TOL = 1e-6
SIZE = 96  # the datasets' img_size; the synthetic images are 128 px
# every augmentation of the reference recipe on: mosaic (and mixup of
# two), flips both ways, HSV, a perspective warp with rotation, scale,
# shear and translation
AUG_HYP = dict(PRESETS["scratch.p5"], mosaic=0.6, mixup=0.5, flipud=0.5,
               fliplr=0.5, degrees=8.0, scale=0.4, shear=3.0,
               translate=0.15, perspective=0.0004)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for this module: beside the other test
    workers, its thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    """A synthetic set of 4 training images and 1 validation image: 2
    steps an epoch at batch 2."""
    return t_synthetic(str(tmp_path_factory.mktemp("small") / "set"),
                       n_images=5, img_size=64, val_fraction=0.2, seed=6)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The data yaml of a synthetic set written by the port's generator
    (the JAX generator's files are equal: test_synthetic_set_matches)."""
    import yaml

    path = t_synthetic(str(tmp_path_factory.mktemp("syn") / "set"),
                       n_images=12, img_size=128, seed=5)
    with open(path) as f:
        return path, yaml.safe_load(f)


def seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def assert_samples_equal(got, want):
    assert np.array_equal(got[0], want[0])
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=LABEL_TOL)
    assert got[2:] == want[2:]


def test_synthetic_set_matches(tmp_path):
    """The port's generator writes the JAX generator's images, labels and
    yaml for the same seed."""
    a = t_synthetic(str(tmp_path / "t"), n_images=4, img_size=64, seed=3)
    b = j_synthetic(str(tmp_path / "j"), n_images=4, img_size=64, seed=3)
    files_a = sorted(p.relative_to(tmp_path / "t")
                     for p in (tmp_path / "t").rglob("*.*"))
    files_b = sorted(p.relative_to(tmp_path / "j")
                     for p in (tmp_path / "j").rglob("*.*"))
    assert files_a == files_b and len(files_a) == 9
    for rel in files_a:
        if rel.suffix != ".yaml":
            assert (tmp_path / "t" / rel).read_bytes() == \
                (tmp_path / "j" / rel).read_bytes(), rel
    assert a.endswith("data.yaml") and b.endswith("data.yaml")


@pytest.mark.parametrize("rect_hyp", ["mosaic", "no-mosaic"])
def test_augmented_samples_match_jax(synth, rect_hyp):
    """Every sample of the augmenting FaceDataset, each under its own
    seed: mosaic (+ mixup) or the letterbox + random_perspective path,
    then HSV and the flips."""
    hyp = dict(AUG_HYP, mosaic=0.6 if rect_hyp == "mosaic" else 0.0)
    _, cfg = synth
    t = TD.FaceDataset(cfg["train"], img_size=SIZE, augment=True, hyp=hyp)
    j = JD.FaceDataset(cfg["train"], img_size=SIZE, augment=True, hyp=hyp)
    assert t.mosaic == j.mosaic and t.mosaic_border == j.mosaic_border
    for i in range(len(t)):
        assert_samples_equal(seeded(i, lambda: t.get(i)),
                             seeded(i, lambda: j.get(i)))


def test_mosaic9_cutout_replicate_match_jax(synth):
    """load_mosaic9 (not on the default recipe's path), cutout and
    replicate under the same seeds."""
    _, cfg = synth
    t = TD.FaceDataset(cfg["train"], img_size=SIZE, augment=True,
                       hyp=AUG_HYP)
    j = JD.FaceDataset(cfg["train"], img_size=SIZE, augment=True,
                       hyp=AUG_HYP)
    for i in (0, 5):
        got = seeded(i, lambda: t.load_mosaic9(i))
        want = seeded(i, lambda: j.load_mosaic9(i))
        assert np.array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=LABEL_TOL)
    img, _ = seeded(3, lambda: t.load_mosaic(3))
    assert img.shape == (SIZE, SIZE, 3)
    boxes = np.array([[0, 10, 12, 40, 50], [0, 60, 50, 70, 70],
                      [0, 5, 70, 30, 90]], np.float32)
    outs = []
    for mod in (TD, JD):
        im = img.copy()
        kept = seeded(9, lambda: mod.cutout(im, boxes.copy()))
        im2, rows = seeded(10, lambda: mod.replicate(img.copy(), boxes))
        outs.append((im, kept, im2, rows))
    for got, want in zip(*outs):
        assert np.array_equal(got, want)


def test_dataloader_batches_match_jax(synth):
    """The serial DataLoader over the augmenting dataset: the same batches
    (images, labels with their image index) for the same global seeds,
    two epochs of the loader's epoch-seeded shuffle."""
    _, cfg = synth
    batches = []
    for mod in (TD, JD):
        ds = mod.FaceDataset(cfg["train"], img_size=SIZE, augment=True,
                             hyp=AUG_HYP)
        loader = mod.DataLoader(ds, 4, shuffle=True, seed=3, workers=1)
        out = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            random.seed(epoch)
            np.random.seed(epoch)
            out += list(loader)
        batches.append(out)
    assert len(batches[0]) == len(batches[1]) == 4
    for got, want in zip(*batches):
        assert np.array_equal(got[0], want[0]) and got[0].dtype == np.uint8
        np.testing.assert_allclose(got[1], want[1], atol=LABEL_TOL)
        assert got[2] == want[2]


def test_augmentation_without_opencv_raises(monkeypatch):
    """Where OpenCV is missing the augmenting path raises ImportError
    naming it; nothing is skipped quietly."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(ImportError, match="OpenCV"):
        TD.augment_hsv(img, 0.1, 0.1, 0.1)
    with pytest.raises(ImportError, match="OpenCV"):
        TD.random_perspective(img, np.zeros((0, 15), np.float32))


def test_autoanchor_matches_jax(synth):
    """check_anchors (BPR, and the k-means + evolution recompute it runs
    below 0.98) and kmean_anchors equal under the same np.random seed."""
    _, cfg = synth
    ds = TD.FaceDataset(cfg["train"], img_size=SIZE)
    js, ts = JZ.get_spec("yolov7-lite-t"), TZ.get_spec("yolov7-lite-t")
    for thr in (4.0, 1.5):  # 1.5: a BPR below 0.98 recomputes
        got = seeded(0, lambda: TA.check_anchors(
            ds.labels, ds.shapes, ts, thr=thr, imgsz=SIZE, verbose=False))
        want = seeded(0, lambda: JA.check_anchors(
            ds.labels, ds.shapes, js, thr=thr, imgsz=SIZE, verbose=False))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    got = seeded(1, lambda: TA.kmean_anchors(ds.labels, ds.shapes, n=9,
                                             img_size=SIZE, gen=50,
                                             verbose=False))
    want = seeded(1, lambda: JA.kmean_anchors(ds.labels, ds.shapes, n=9,
                                              img_size=SIZE, gen=50,
                                              verbose=False))
    np.testing.assert_array_equal(got, want)
    anchors = np.arange(1, 19, dtype=np.float64).reshape(3, 3, 2)
    np.testing.assert_array_equal(
        TA.check_anchor_order(anchors[::-1], (8, 16, 32)),
        JA.check_anchor_order(anchors[::-1], (8, 16, 32)))


def test_label_weights_hyp_and_evolution_match_jax():
    rng = np.random.default_rng(2)
    labels = [np.c_[rng.integers(0, 3, (n, 1)), rng.random((n, 4))]
              for n in (3, 0, 5, 1)]
    cw = TG.labels_to_class_weights(labels, 3)
    np.testing.assert_array_equal(cw, JG.labels_to_class_weights(labels, 3))
    np.testing.assert_array_equal(
        TG.labels_to_image_weights(labels, 3, cw),
        JG.labels_to_image_weights(labels, 3, cw))
    assert TH.PRESETS == PRESETS and TH.get_hyp("finetune") == \
        get_hyp("finetune")
    assert TE.META == JE.META
    ledger = [{"fitness": f, "hyp": dict(PRESETS["scratch.p6"], lr0=f)}
              for f in (0.1, 0.3, 0.2)]
    got = seeded(4, lambda: TE.mutate(PRESETS["scratch.p6"], ledger,
                                      np.random.default_rng(1)))
    want = seeded(4, lambda: JE.mutate(PRESETS["scratch.p6"], ledger,
                                       np.random.default_rng(1)))
    assert got == want
    gen = TG.init_seeds(5)
    assert isinstance(gen, torch.Generator) and random.random() == \
        seeded(5, random.random)


def small_state(optimizer="sgd"):
    spec = narrowed(TZ, "yolov7-tiny-face")
    net = TM.init_weights(TM.YoloFace(spec),
                          torch.Generator().manual_seed(1))
    state = TR.create_train_state(net, optimizer)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for d in (state.momentum_buf, state.ema_params,
                  state.second_moment or {}):
            for t in d.values():
                t.normal_(generator=gen)
        for name, b in net.named_buffers():
            if b.is_floating_point():
                b.uniform_(0.5, 1.5, generator=gen)
    state.step, state.ema_updates = 7, 5
    return state


def assert_states_equal(a, b):
    for x, y in ((a.model.state_dict(), b.model.state_dict()),
                 (a.momentum_buf, b.momentum_buf),
                 (a.ema_params, b.ema_params),
                 (a.second_moment or {}, b.second_moment or {})):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert (a.step, a.ema_updates) == (b.step, b.ema_updates)


@pytest.mark.parametrize("optimizer,writer", [("sgd", "sync"),
                                              ("adam", "async")])
def test_checkpoint_round_trip(tmp_path, optimizer, writer):
    """save/load give back the state exactly (params, buffers, optimizer
    moments, EMA, counters) and the meta; the crash contract: a parked
    <tag>.pt.old alone is loaded, and adopted by the next save; a stale
    .tmp is discarded."""
    state = small_state(optimizer)
    meta = {"epoch": 3, "best_fitness": 0.25}
    if writer == "async":
        w = TC.AsyncCheckpointWriter()
        w.save(str(tmp_path), "last", state, meta)
        w.close()
    else:
        TC.save_checkpoint(str(tmp_path), "last", state, meta)
    assert TC.peek_meta(str(tmp_path), "last") == meta
    other = small_state(optimizer)
    with torch.no_grad():
        for p in other.model.parameters():
            p.zero_()
    other.step = other.ema_updates = 0
    loaded, got_meta = TC.load_checkpoint(str(tmp_path), "last", other)
    assert loaded is other and got_meta == meta
    assert_states_equal(other, state)

    last = tmp_path / "last.pt"
    last.rename(tmp_path / "last.pt.old")
    (tmp_path / "last.pt.tmp").write_bytes(b"half")
    assert_states_equal(TC.load_checkpoint(str(tmp_path), "last",
                                           small_state(optimizer))[0],
                        state)
    TC.save_checkpoint(str(tmp_path), "best", state, meta)
    TC._pre_save(str(last))
    assert last.exists() and not (tmp_path / "last.pt.old").exists() \
        and not (tmp_path / "last.pt.tmp").exists()
    with pytest.raises(ValueError, match="second_moment"):
        TC.load_checkpoint(str(tmp_path), "last", small_state(
            "adam" if optimizer == "sgd" else "sgd"))


def test_stripped_weights_are_the_jax_npz(tmp_path):
    """save_inference_weights(strip_to_inference(state)) of a state whose
    EMA holds the JAX weights: the JAX loader reads the JAX
    save_inference_weights' keys, shapes and values, and the port's
    FaceDetector(torch_weights=) and loader read them back."""
    spec_j = narrowed(JZ, "yolov7-tiny-face")
    variables = random_variables(spec_j, seed=6)
    state = small_state()
    sd = jax_to_state_dict(variables)
    with torch.no_grad():
        for name, b in state.model.named_buffers():
            b.copy_(sd[name])
        for name, e in state.ema_params.items():
            e.copy_(sd[name])
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    TC.save_inference_weights(str(ours), TC.strip_to_inference(state))
    JC.save_inference_weights(str(theirs), variables)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    flat = lambda t, p="": {p + k: v for kk, vv in t.items() for k, v in (
        flat(vv, f"{kk}/").items() if isinstance(vv, dict)
        else {kk: vv}.items())}
    jax_read = flat(JC.load_inference_weights(str(ours)))
    port_read = flat(load_inference_weights(str(ours)))
    assert jax_read.keys() == port_read.keys()
    for k in jax_read:
        np.testing.assert_array_equal(np.asarray(jax_read[k]), port_read[k])
    det = FaceDetector(narrowed(TZ, "yolov7-tiny-face"),
                       torch_weights=str(ours), img_sizes=(64,),
                       fuse=False, device="cpu")
    for k, v in det.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_metrics_logger_writes_jsonl(tmp_path):
    log = MetricsLogger(str(tmp_path), use_tensorboard=False)
    log.log(3, {"train/box_loss": np.float32(0.5), "skip": "text"})
    log.close()
    rows = [json.loads(l) for l in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert rows == [{"step": 3, "train/box_loss": 0.5}]


CLI = ["--model", "yolov7-lite-t", "--img-size", "64", "--batch-size", "2",
       "--nominal-batch", "4", "--hyp", "scratch.p5", "--no-tensorboard",
       "--workers", "1", "--min-warmup-steps", "2", "--name", "run",
       "--device", "cpu"]


def test_cli_train_checkpoints_resumes_and_strips(tmp_path, small_set):
    """cli.train --device cpu, 2 epochs of 2 micro-steps (accumulated to
    the nominal batch of 4): last, best, best_inference.npz and
    results.txt; --resume runs epoch 2 only, from `last`; the stripped
    weights are the final EMA's and FaceDetector reads them."""
    path = small_set
    runs = str(tmp_path / "runs")
    args = CLI + ["--data", path, "--project", runs, "--epochs", "2"]
    assert TCLI.main(args) == 0
    first = TCLI.train_run.last
    weights = tmp_path / "runs" / "run" / "weights"
    assert {p.name for p in weights.iterdir()} >= {
        "last.pt", "last.meta.json", "best.pt", "best.meta.json",
        "best_inference.npz"}
    results = (tmp_path / "runs" / "run" / "results.txt").read_text()
    assert [l.split()[0] for l in results.splitlines()] == ["0", "1"]
    assert first["state"].step == 2  # 4 micro-steps, 2 applies
    assert TC.peek_meta(str(weights), "last")["epoch"] == 1
    strip = TC.strip_to_inference(first["state"])
    with np.load(weights / "best_inference.npz") as f:
        for k, v in f.items():
            col, *path_ = k.split("/")
            node = strip[col]
            for p in path_:
                node = node[p]
            np.testing.assert_array_equal(v, node)

    assert TCLI.main(args[:-1] + ["3", "--resume", "--exist-ok"]) == 0
    results = (tmp_path / "runs" / "run" / "results.txt").read_text()
    assert [l.split()[0] for l in results.splitlines()] == ["0", "1", "2"]
    assert TCLI.train_run.last["state"].step == 3
    FaceDetector("yolov7-lite-t", torch_weights=str(
        weights / "best_inference.npz"), img_sizes=(64,), device="cpu")


def test_cli_evolve_and_refusals(tmp_path, monkeypatch, small_set):
    """run_evolve's generations through a stubbed training run write the
    ledger and the evolved hyp; several processes and a missing card
    raise naming what is missing, and bf16 training (ported) does not."""
    path = small_set
    fits = iter([0.1, 0.4])

    def fake_run(args, hyp_override=None, quiet=False):
        fake_run.last = {"fitness": next(fits), "save_dir": args.name,
                         "state": None}
        return 0

    monkeypatch.setattr(TCLI, "train_run", fake_run)
    assert TCLI.main(CLI + ["--data", path, "--project",
                            str(tmp_path), "--evolve", "2"]) == 0
    ledger = JE.read_ledger(str(tmp_path / "evolve.txt"))
    assert [e["fitness"] for e in ledger] == [0.1, 0.4]
    assert json.loads((tmp_path / "hyp_evolved.json").read_text()) == \
        ledger[1]["hyp"]
    monkeypatch.undo()

    base = TCLI.parse_args(CLI + ["--data", path])
    assert TCLI._device(argparse.Namespace(**dict(
        vars(base), dtype="bfloat16"))) == torch.device("cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="module 7"):
        TCLI._device(base)
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI._device(argparse.Namespace(**dict(vars(base), device="cuda")))
