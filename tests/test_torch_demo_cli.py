"""The port's demo entry points (data/streams.py, cli/detect.py,
cli/serve.py, cli/compare_json_shapes.py, cli/compare_resize_methods.py)
against the JAX package's on the CPU.

One narrowed cfg yaml (yolov7-tiny-face at width 0.25, written as a
user's reference-format cfg) and one seeded weights .npz serve both
packages. The gate and IoU threshold lie in the widest gaps of the
port's decoded rows of every frame the CLIs see (`settings_for_rows`),
so both forwards, within the decoded-row tolerance ROW_TOL of each
other, keep the same detections. The JAX CLIs share one JAX detector
(one compile a shape; its constructor is patched to hand it out), and
compare_resize_methods' standard path adds one shape.

Held: `LoadImages` over images and a short video yields the same paths
and frames; `cli.detect --device cpu` writes the same label files (boxes
within 1 px, confidences within ROW_TOL) and prints the same face
counts; `cli.serve`'s handler answers the raw and the multipart POST
with the same records (within ROW_TOL) and a 404 elsewhere;
`compare_json_shapes` prints the same report and exit code;
`compare_resize_methods` prints the same counts and mean confidences.
Without `--device`, each CLI that runs a model asks for the card and
raises here."""

import io
import json
import sys
import threading
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.data import streams as JS
from face_detection_multi_scale_tpu.infer import detector as JDET
from face_detection_multi_scale_tpu.models.spec import load_spec as j_spec
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu_torch.cli import (
    compare_json_shapes as tcompare, compare_resize_methods as tresize,
    detect as tdetect, serve as tserve)
from face_detection_multi_scale_tpu_torch.data import letterbox as LB
from face_detection_multi_scale_tpu_torch.data import streams as TS
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.models.spec import (
    load_spec as t_spec)
from face_detection_multi_scale_tpu_torch.train.checkpoint import (
    save_inference_weights)

from test_torch_detector import ROW_TOL, settings_for_rows
from test_torch_model import narrowed, random_variables
from test_torch_zoo_models import zoo_cfg

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import cli.compare_json_shapes as jcompare  # noqa: E402
import cli.compare_resize_methods as jresize  # noqa: E402
import cli.detect as jdetect  # noqa: E402
import cli.serve as jserve  # noqa: E402

SIZE = 128
H, W = 96, 128  # the frames: letterboxed to SIZE x SIZE (auto=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The cfg yaml, the weights .npz, a source folder (4 images and a
    3-frame video), every frame the CLIs see, the decisive thresholds,
    the port's detector and the shared JAX detector."""
    import cv2
    import yaml

    root = tmp_path_factory.mktemp("demo")
    cfg = root / "tiny-narrow.yaml"
    cfg.write_text(yaml.safe_dump(zoo_cfg(narrowed(JZ,
                                                   "yolov7-tiny-face"))))
    spec = j_spec(str(cfg))
    weights = str(root / "w.npz")
    variables = random_variables(spec, seed=8)
    save_inference_weights(weights, variables)

    rng = np.random.default_rng(9)
    src = root / "src"
    src.mkdir()
    for i in range(4):
        cv2.imwrite(str(src / f"im{i}.jpg"),
                    rng.integers(0, 256, (H, W, 3), np.uint8))
    video = cv2.VideoWriter(str(src / "clip.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    for _ in range(3):
        video.write(rng.integers(0, 256, (H, W, 3), np.uint8))
    video.release()
    frames = [frame for _, frame, _ in TS.LoadImages(str(src))]
    assert len(frames) == 7

    tdet = TFaceDetector(t_spec(str(cfg)), torch_weights=weights,
                         img_sizes=(SIZE,), device="cpu")
    inputs = np.stack([LB.preprocess_standard(f, SIZE, tdet.stride)
                       for f in frames])
    rows = tdet.forward_rows(inputs).numpy()
    conf, iou, _ = settings_for_rows(rows, None)
    kw = dict(img_sizes=(SIZE,), conf_thres=conf, iou_thres=iou)
    tdet = TFaceDetector(t_spec(str(cfg)), torch_weights=weights,
                         device="cpu", **kw)
    jdet = JDET.FaceDetector(j_spec(str(cfg)), variables=variables, **kw)
    return dict(cfg=str(cfg), weights=weights, src=src, frames=frames,
                conf=conf, iou=iou, tdet=tdet, jdet=jdet, root=root)


@pytest.fixture()
def shared_jax_detector(setup, monkeypatch):
    """The JAX CLIs' FaceDetector(...) hands out the shared detector,
    whose weights and thresholds the CLI arguments name."""
    def make(model, torch_weights=None, **kw):
        assert torch_weights == setup["weights"]
        assert kw.get("conf_thres") == setup["conf"]
        return setup["jdet"]

    monkeypatch.setattr(JDET, "FaceDetector", make)


def run_cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_load_images_matches_jax(setup):
    """Images, then the video frame by frame: the same paths and frames,
    and the capture handed out with each video frame."""
    got, want = (list(mod.LoadImages(str(setup["src"]))) for mod in (TS, JS))
    assert len(got) == len(want) == 7 and len(TS.LoadImages(
        str(setup["src"]))) == 5
    for (gp, gf, gc), (wp, wf, wc) in zip(got, want):
        assert gp == wp and np.array_equal(gf, wf)
        assert (gc is None) == (wc is None) == (not gp.endswith(".mp4"))
    glob_src = str(setup["src"] / "im*.jpg")
    assert [p for p, _, _ in TS.LoadImages(glob_src)] == \
        [p for p, _, _ in JS.LoadImages(glob_src)]
    with pytest.raises(FileNotFoundError):
        TS.LoadImages(str(setup["root"] / "missing"))


def read_labels(folder: Path):
    return {p.name: np.array([[float(v) for v in l.split()]
                              for l in p.read_text().splitlines()])
            for p in sorted(folder.glob("*.txt"))}


def test_detect_cli_matches_jax(setup, shared_jax_detector, tmp_path):
    """--save-txt --save-conf over the images and the video: the same
    label files (boxes within 1 px of the native frame, confidences
    within ROW_TOL), the same printed counts."""
    argv = ["--model", setup["cfg"], "--weights", setup["weights"],
            "--source", str(setup["src"]), "--img-size", str(SIZE),
            "--conf-thres", repr(setup["conf"]),
            "--iou-thres", repr(setup["iou"]), "--save-txt", "--save-conf",
            "--exist-ok", "--name", "exp"]
    outs = {}
    for name, main, extra in (("jax", jdetect.main, []),
                              ("port", tdetect.main, ["--device", "cpu"])):
        rc, out = run_cli(main, argv + ["--project", str(tmp_path / name)]
                          + extra)
        assert rc == 0
        outs[name] = [l for l in out.splitlines() if l.endswith("faces")]
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 7
    got = read_labels(tmp_path / "port" / "exp" / "labels")
    want = read_labels(tmp_path / "jax" / "exp" / "labels")
    assert got.keys() == want.keys() and len(got) == 5
    assert sum(len(v) for v in got.values()) > 0
    for name, rows in got.items():
        theirs = want[name]
        assert rows.shape == theirs.shape and rows.shape[1] == 6, name
        pair = np.abs(rows[:, None] - theirs[None]).max(-1).argmin(1)
        theirs = theirs[pair]
        assert (rows[:, 0] == theirs[:, 0]).all()
        assert (np.abs(rows[:, 1:5] - theirs[:, 1:5])
                <= 1.0 / np.array([W, H, W, H]) + 1e-6).all(), name
        np.testing.assert_allclose(rows[:, 5], theirs[:, 5],
                                   rtol=ROW_TOL["rtol"],
                                   atol=ROW_TOL["atol"] + 1e-5)
    saved = {p.name for p in (tmp_path / "port" / "exp").iterdir()}
    assert {"im0.jpg", "clip.mp4", "labels"} <= saved


@pytest.fixture()
def servers(setup):
    """Both packages' handlers on localhost, each with its detector."""
    import argparse

    urls = {}
    started = []
    for name, mod, det in (("port", tserve, setup["tdet"]),
                           ("jax", jserve, setup["jdet"])):
        mod.DETECTOR = det
        mod.ARGS = argparse.Namespace(img_size=SIZE)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), mod.Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        started.append(srv)
        urls[name] = f"http://127.0.0.1:{srv.server_address[1]}"
    yield urls
    for srv in started:
        srv.shutdown()
        srv.server_close()


def post(url, body, ctype):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def test_serve_matches_jax(setup, servers):
    """The raw body and the multipart body: the same records (numbers
    within ROW_TOL, paired by box); another path answers 404."""
    import cv2

    ok, buf = cv2.imencode(".png", setup["frames"][0])
    image = buf.tobytes()
    boundary = b"xBOUNDARYx"
    multipart = (b"--" + boundary + b"\r\n"
                 b'Content-Disposition: form-data; name="image"; '
                 b'filename="a.png"\r\nContent-Type: image/png\r\n\r\n'
                 + image + b"\r\n--" + boundary + b"--\r\n")
    keys = ("xmin", "ymin", "xmax", "ymax", "confidence")
    for body, ctype in ((image, "application/octet-stream"),
                        (multipart, "multipart/form-data; boundary="
                         + boundary.decode())):
        got, want = (post(servers[n] + "/v1/object-detection/tiny", body,
                          ctype) for n in ("port", "jax"))
        assert len(got) == len(want) > 0
        assert all(r["name"] == "face" and r["class"] == 0
                   for r in got + want)
        g = np.array([[r[k] for k in keys] for r in got])
        w = np.array([[r[k] for k in keys] for r in want])
        w = w[np.abs(g[:, None] - w[None]).max(-1).argmin(1)]
        np.testing.assert_allclose(g, w, **ROW_TOL)
    for n in ("port", "jax"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                servers[n] + "/nope", data=b"x", method="POST"), timeout=30)
        assert e.value.code == 404


def test_compare_json_shapes_matches_jax(tmp_path):
    """Two production-JSON folders (a match, a frame-count mismatch, a
    file on each side only): the same report and exit code."""
    def write(folder, name, n_frames):
        folder.mkdir(exist_ok=True)
        (folder / name).write_text(json.dumps({"yolo_face_prediction": [{
            "name": "yolo-face-bboxes", "shape": [n_frames, 1, 5],
            "data": [[[1.0, 2.0, 3.0, 4.0, 0.9]]] * n_frames}]}))

    a, b = tmp_path / "a", tmp_path / "b"
    for name, na, nb in (("same.json", 3, 3), ("diff.json", 2, 4)):
        write(a, name, na)
        write(b, name, nb)
    write(a, "only_a.json", 1)
    write(b, "only_b.json", 1)
    got, want = (run_cli(main, [str(a), str(b), "--report",
                                str(tmp_path / f"{who}.txt")])
                 for who, main in (("port", tcompare.main),
                                   ("jax", jcompare.main)))
    assert got == want and got[0] == 1 and "MISMATCH diff.json" in got[1]
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()


def test_compare_resize_methods_matches_jax(setup, shared_jax_detector,
                                            tmp_path):
    """The panel is written, and the printed A/B has the same counts and
    mean confidences (within ROW_TOL) for both preprocessings."""
    import cv2

    image = str(tmp_path / "img.jpg")
    cv2.imwrite(image, setup["frames"][1])
    argv = ["--image", image, "--model", setup["cfg"], "--weights",
            setup["weights"], "--img-size", str(SIZE),
            "--conf-thres", repr(setup["conf"])]
    results = {}
    for name, main, extra in (("jax", jresize.main, []),
                              ("port", tresize.main, ["--device", "cpu"])):
        rc, out = run_cli(main, argv + ["--out", str(tmp_path / f"{name}"
                                                     ".png")] + extra)
        assert rc == 0 and (tmp_path / f"{name}.png").exists()
        results[name] = json.loads(out[out.index("{"):])
    for mode in ("api", "standard"):
        got, want = results["port"][mode], results["jax"][mode]
        assert got["count"] == want["count"]
        np.testing.assert_allclose(got["mean_conf"], want["mean_conf"],
                                   **ROW_TOL)


def test_clis_without_device_ask_for_the_card(setup, monkeypatch,
                                              tmp_path):
    """Without --device, detect, serve and compare_resize_methods build
    their detector on the card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = ["--model", setup["cfg"], "--weights", setup["weights"]]
    for main, argv in ((tdetect.main, model + [
            "--source", str(setup["src"]), "--project", str(tmp_path)]),
                       (tserve.main, model),
                       (tresize.main, model + [
                           "--image", str(setup["src"] / "im0.jpg"),
                           "--out", str(tmp_path / "panel.png")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_cli(main, argv)
