"""The port's utils/downloads.py and cli/download_widerface.py against the
JAX package's utils/downloads.py and the repo-root cli/download_widerface.py,
on the CPU. No test opens a socket: every fetch goes to a file:// URL under
the test's own directory, or through a patched `download_url`
(tests/torch_shared.release_redirect, which raises on any other URL).

- `attempt_download` with an explicit file:// URL: the same return value
  and bytes from both, and no `.part` left; an existing path, or one
  without a weights suffix, comes back unchanged with no fetch; a
  file:// URL that does not exist gives FileNotFoundError from both.
- `FaceDetector(torch_weights=<missing>.npz)` in both packages fetches
  `{DEFAULT_RELEASE}/<name>` (here from a local release directory holding
  the JAX `save_inference_weights` file of numpy-seeded variables) and
  serves it: decoded rows within the decoded-row tolerance (atol 5e-3 /
  rtol 1e-3, tests/test_torch_detector.py's ROW_TOL), thresholds in the
  widest gaps of the port's values (`settings_for_rows`).
- `download_widerface.main` of both, with `URLS` pointed at file:// zips
  built in the test's directory, under the default flags,
  `--download_all` and `--keep_zip`, then a second run that skips what
  was extracted: the same extracted trees and kept zips.
"""

import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.infer.detector import (
    FaceDetector as JFaceDetector)
from face_detection_multi_scale_tpu.models import zoo as JZ
from face_detection_multi_scale_tpu.ops import nms as JN
from face_detection_multi_scale_tpu.train.checkpoint import (
    save_inference_weights)
from face_detection_multi_scale_tpu.utils import downloads as JD
from face_detection_multi_scale_tpu_torch.cli import (
    download_widerface as TW)
from face_detection_multi_scale_tpu_torch.infer.detector import (
    FaceDetector as TFaceDetector)
from face_detection_multi_scale_tpu_torch.models import zoo as TZ
from face_detection_multi_scale_tpu_torch.ops import nms as TN
from face_detection_multi_scale_tpu_torch.utils import downloads as TD

from test_torch_detector import assert_rows_match, settings_for_rows
from test_torch_model import narrowed, random_variables
from torch_shared import release_redirect

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import cli.download_widerface as JW  # noqa: E402

MODULES = {"jax": JD, "port": TD}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores
    (tests/test_torch_quant.py's port-only cases ran 20x slower beside
    one other test process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_attempt_download_file_url_matches_jax(tmp_path):
    src = tmp_path / "src" / "w.npz"
    src.parent.mkdir()
    np.savez(src, a=np.random.default_rng(0).standard_normal(1000))
    dest = tmp_path / "dest" / "w.npz"
    got = {}
    for tag, mod in MODULES.items():
        ret = mod.attempt_download(str(dest), url=src.as_uri())
        got[tag] = (ret, dest.read_bytes())
        assert not Path(str(dest) + ".part").exists()
        dest.unlink()
    assert got["port"] == got["jax"]
    assert got["port"] == (str(dest), src.read_bytes())


@pytest.mark.parametrize("which", ["existing", "other suffix"])
def test_attempt_download_returns_without_fetching(tmp_path, monkeypatch,
                                                   which):
    path = tmp_path / ("w.pt" if which == "existing" else "missing.pth")
    if which == "existing":
        path.write_bytes(b"weights")
    calls = []
    for tag, mod in MODULES.items():
        monkeypatch.setattr(mod, "download_url",
                            lambda *a, **k: calls.append((tag, a)))
        assert mod.attempt_download(str(path)) == str(path)
    assert calls == []
    assert path.exists() == (which == "existing")


def test_attempt_download_missing_url_raises(tmp_path):
    url = (tmp_path / "nowhere" / "w.npz").as_uri()
    for mod in MODULES.values():
        dest = tmp_path / "dest" / "w.npz"
        with pytest.raises(FileNotFoundError, match="download failed"):
            mod.attempt_download(str(dest), url=url)
        assert not dest.exists()


def test_detector_fetches_missing_weights(tmp_path, monkeypatch):
    """Both FaceDetectors fetch a missing `.npz` from the release (a local
    directory here) and serve the same weights."""
    name = "yolov7-tiny-face"
    spec_j, spec_t = narrowed(JZ, name), narrowed(TZ, name)
    variables = random_variables(spec_j, seed=21)
    release = tmp_path / "release"
    release.mkdir()
    save_inference_weights(str(release / "x.npz"), variables)
    calls = {}
    for tag, mod in MODULES.items():
        calls[tag] = []
        monkeypatch.setattr(mod, "download_url", release_redirect(
            mod, release.as_uri(), calls[tag]))
    frames = np.random.default_rng(22).integers(0, 256, (2, 64, 64, 3),
                                                dtype=np.uint8)
    jpath, tpath = (tmp_path / tag / "missing" / "x.npz"
                    for tag in ("jax", "port"))
    tdet = TFaceDetector(spec_t, torch_weights=str(tpath), device="cpu",
                         img_sizes=(64,))
    # thresholds in the widest gaps of the port's own values (within
    # ulps of the JAX side's; a JAX forward of its own would cost a
    # compile)
    conf, iou, k = settings_for_rows(tdet.forward_rows(frames).numpy(), None)
    tdet.conf_thres, tdet.iou_thres, tdet.max_candidates = conf, iou, k
    jdet = JFaceDetector(spec_j, torch_weights=str(jpath), img_sizes=(64,),
                         conf_thres=conf, iou_thres=iou, max_candidates=k)
    want_url = f"{TD.DEFAULT_RELEASE}/x.npz"
    assert TD.DEFAULT_RELEASE == JD.DEFAULT_RELEASE
    assert calls == {"jax": [want_url], "port": [want_url]}
    for path in (jpath, tpath):
        assert path.read_bytes() == (release / "x.npz").read_bytes()
        assert not Path(str(path) + ".part").exists()
    want = JN.detections_to_numpy(jdet.run_network(frames))
    got = TN.detections_to_numpy(tdet.run_network(frames))
    for g, w in zip(got, want):
        assert len(g) > 0
        assert_rows_match(g, np.asarray(w))


def make_zips(root: Path) -> dict:
    """file:// URLs of four small WIDER-shaped zips under `root`."""
    urls = {}
    for name in ("train", "val", "test", "annot"):
        top = "wider_face_split" if name == "annot" else f"WIDER_{name}"
        path = root / (f"{top}.zip" if name == "annot"
                       else f"WIDER_{name}.zip")
        with zipfile.ZipFile(path, "w") as z:
            z.writestr(f"{top}/readme.txt", f"{name}\n")
            z.writestr(f"{top}/0--Parade/0_{name}.jpg", bytes(range(97)))
        urls[name] = path.as_uri()
    return urls


def tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("flags", [[], ["--download_all"], ["--keep_zip"],
                                   ["--download_all", "--keep_zip"]],
                         ids=["default", "all", "keep", "all-keep"])
def test_download_widerface_matches_jax(tmp_path, monkeypatch, capsys,
                                        flags):
    urls = make_zips(tmp_path)
    out = {}
    for tag, mod in (("jax", JW), ("port", TW)):
        monkeypatch.setattr(mod, "URLS", urls)
        root = tmp_path / tag
        assert mod.main(["--output_dir", str(root)] + flags) == 0
        first = tree(root)
        # a second run skips what was extracted and fetches nothing
        monkeypatch.setattr(mod, "download", lambda *a: pytest.fail(
            "fetched again"))
        capsys.readouterr()
        assert mod.main(["--output_dir", str(root)] + flags) == 0
        assert "exists, skipping" in capsys.readouterr().out
        assert tree(root) == first
        out[tag] = first
    assert out["port"] == out["jax"]
    names = {p.split("/")[0] for p in out["port"]}
    sets = (["train", "val", "test"] if "--download_all" in flags
            else ["train"])
    want = {f"WIDER_{s}" for s in sets} | {"wider_face_split"}
    if "--keep_zip" in flags:
        want |= {f"WIDER_{s}.zip" for s in sets} | {"wider_face_split.zip"}
    assert names == want
