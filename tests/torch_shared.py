"""Helpers that the port's tests share with chip_smoke.py (which puts
this directory on its import path): seeded in-memory face sets, a local
stand-in for the weights release, and the tolerance ratios that hold a
data-parallel train step against the one-process step at the
sharded-step tolerances. Imports no JAX: the
spawned ranks of tests/test_torch_mesh.py and of chip_smoke.py import it.
"""

import numpy as np
import torch

from face_detection_multi_scale_tpu_torch.data import dataset as DS

# the sharded-step tolerances (the JAX suite's, tests/
# test_multidevice_training.py): losses, parameters, BN statistics
MESH_LOSS_RTOL = 1e-5
MESH_PARAM_TOL = dict(rtol=2e-3, atol=1e-4)
MESH_BN_TOL = dict(rtol=1e-4, atol=1e-6)


class MemoryFaces(DS.FaceDataset):
    """A FaceDataset over seeded in-memory images and labels (the card
    machine has no OpenCV or PIL to read files): `_enumerate` gives the
    names, labels and native shapes, `load_image` the stored image at
    the network size with its native (h0, w0)."""

    def __init__(self, images, hw0, labels, **kw):
        self.images, self.hw0, self.given = images, hw0, labels
        super().__init__(None, **kw)

    def _enumerate(self, path, prefix):
        names = [f"mem/{i}.jpg" for i in range(len(self.images))]
        shapes = np.array([(w, h) for h, w in self.hw0], np.float64)
        return names, names, list(self.given), shapes

    def load_image(self, index):
        img = self.images[index]
        return img.copy(), self.hw0[index], img.shape[:2]


def face_labels(rng, n: int):
    """n images' seeded labels: 1-3 faces each, normalized `0 cx cy w h`
    rows with 5 landmarks inside the box (load_label_file's layout)."""
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        xy = rng.uniform(0.25, 0.75, (k, 2))
        wh = rng.uniform(0.08, 0.4, (k, 2))
        kpt = xy[:, None] + rng.uniform(-0.25, 0.25, (k, 5, 2)) * wh[:, None]
        out.append(np.concatenate([np.zeros((k, 1)), xy, wh,
                                   kpt.reshape(k, 10)], 1).astype(np.float32))
    return out


def memory_faces(rng, n: int, size: int, stride: int) -> MemoryFaces:
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return MemoryFaces(images, [(size, size)] * n, face_labels(rng, n),
                       img_size=size, kpt_label=5, stride=stride)


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor, rtol: float,
                    atol: float = 0.0) -> float:
    """max |got - want| / (atol + rtol |want|): within the tolerance iff
    <= 1."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def step_ratios(got, want, exact=None) -> dict:
    """Tolerance ratios of one train-step result against another's, each
    (losses, components, the state dict, ...) as chip_smoke.mesh_train
    returns it: the
    losses (MESH_LOSS_RTOL), the components (and atol 1e-7), the
    parameters and BN statistics (mesh_ratios). With `exact` (the float64
    step), also the parameter tensors beyond the tolerance ("noisy"),
    the worst of their L2 distances from the exact step over `want`'s
    ("noise_ratio"), the L2 distance of all the parameters from the
    exact step over `want`'s ("l2_ratio"), and `want`'s own ratios
    against the exact step."""
    out = dict(mesh_ratios(got[2], want[2]), loss=max(
        abs(a - b) / abs(b) for a, b in zip(got[0], want[0]))
        / MESH_LOSS_RTOL, components=max(
        tolerance_ratio(torch.from_numpy(a), torch.from_numpy(b),
                        MESH_LOSS_RTOL, 1e-7)
        for a, b in zip(got[1], want[1])))
    if exact is not None:
        params = [k for k in want[2] if k.endswith(
            ("weight", "bias", "implicit"))]
        noisy = [k for k in params if tolerance_ratio(
            got[2][k], want[2][k], **MESH_PARAM_TOL) > 1.0]
        dist2 = lambda a, k: float((a[k].double() - exact[2][k].double())
                                   .norm())
        total = lambda a: sum(dist2(a, k) ** 2 for k in params) ** 0.5
        out.update(noisy=noisy, noise_ratio=max(
            [dist2(got[2], k) / max(dist2(want[2], k), 1e-30)
             for k in noisy] or [0.0]),
            l2_ratio=total(got[2]) / max(total(want[2]), 1e-30),
            want_exact=mesh_ratios(want[2], exact[2]))
    return out


def mesh_ratios(got: dict, want: dict) -> dict:
    """Tolerance ratios of a state dict against another: the worst over
    the parameters (MESH_PARAM_TOL) and the BN running statistics
    (MESH_BN_TOL)."""
    out = {"param": 0.0, "bn": 0.0}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        bn = k.endswith(("running_mean", "running_var"))
        what = "bn" if bn else "param"
        out[what] = max(out[what], tolerance_ratio(
            got[k], w, **(MESH_BN_TOL if bn else MESH_PARAM_TOL)))
    return out


def release_redirect(downloads, base: str, calls=None):
    """A stand-in for `downloads.download_url` (either package's
    utils/downloads module) that fetches what the release would serve
    from `base`, a file:// URL, through the real function, and records
    each requested URL in `calls`. Any other URL raises, so nothing
    reaches the network."""
    real = downloads.download_url

    def fetch(url, dest, chunk=1 << 20):
        if calls is not None:
            calls.append(url)
        if url.startswith(downloads.DEFAULT_RELEASE):
            url = base + url[len(downloads.DEFAULT_RELEASE):]
        if not url.startswith("file://"):
            raise AssertionError(f"a fetch from the network: {url}")
        return real(url, dest, chunk)

    return fetch
