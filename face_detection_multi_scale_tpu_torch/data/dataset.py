"""Validation dataset: WIDER FACE images + 5-landmark labels, the
non-augmenting path, with its collate and loader.

A copy of the JAX package's data/dataset.py without augmentation: the
label files and their cache, `FaceDataset` with `augment=False` (square or
`rect` batch shapes, the longest-side resize, the letterbox, labels in
the letterboxed frame), `collate` and `DataLoader`. `augment=True`
(mosaic, random_perspective, augment_hsv, cutout) is training, ROADMAP
queue 1, module 8, and raises NotImplementedError. Host-side numpy/cv2
re-implementation of the reference data layer (reference
utils/datasets.py:349-676 LoadImagesAndLabels, :680-710 load_image).
cv2 and PIL are imported inside the functions that use them.

Batches collate to uint8 NHWC (normalization happens on the device),
labels ride along as fixed-width rows with an image index column, and
per-host sharding replaces DistributedSampler.
"""

from __future__ import annotations

import glob
import hashlib
import os
import random
import threading
import queue as queue_mod
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from face_detection_multi_scale_tpu_torch.data.letterbox import letterbox

IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp",
               "mpo"}


def img2label_paths(img_paths: Sequence[str]) -> List[str]:
    """images/ dir -> labels/ dir, image ext -> .txt
    (utils/datasets.py:343-346)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"
            for p in img_paths]


def load_label_file(path: str, kpt_label: int) -> np.ndarray:
    """Read + validate one label txt (utils/datasets.py:481-510): rows of
    `cls x y w h` plus kpt_label x (x, y, occlusion) triplets; occlusion is
    stripped, coords must be normalized and non-negative."""
    ncols = kpt_label * 2 + 5
    if not os.path.isfile(path):
        return np.zeros((0, ncols), np.float32)
    with open(path) as f:
        rows = [x.split() for x in f.read().strip().splitlines()]
    if not rows:
        return np.zeros((0, ncols), np.float32)
    l = np.array(rows, np.float32)
    assert (l >= 0).all(), f"negative labels: {path}"
    if kpt_label:
        assert l.shape[1] == kpt_label * 3 + 5, \
            f"labels require {kpt_label * 3 + 5} columns: {path}"
        assert (l[:, 5::3] <= 1).all() and (l[:, 6::3] <= 1).all(), \
            f"non-normalized coordinates: {path}"
        keep = np.ones(l.shape[1], bool)
        keep[7::3] = False  # drop occlusion columns
        l = l[:, keep]
    else:
        assert l.shape[1] == 5, f"labels require 5 columns: {path}"
        assert (l[:, 1:5] <= 1).all(), f"non-normalized coords: {path}"
    assert np.unique(l, axis=0).shape[0] == l.shape[0], \
        f"duplicate labels: {path}"
    return l.astype(np.float32)


def exif_size(img) -> Tuple[int, int]:
    """PIL image size (w, h) corrected for EXIF rotation
    (utils/datasets.py exif_size semantics)."""
    s = img.size
    try:
        rotation = dict(img._getexif().items())[274]
        if rotation in (6, 8):
            s = (s[1], s[0])
    except Exception:
        pass
    return s


def _files_hash(paths: Sequence[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.encode())
        try:
            h.update(str(os.path.getsize(p)).encode())
        except OSError:
            pass
    return h.hexdigest()


class FaceDataset:
    """Image + label store for validation (no augmentation).

    `augment=True` raises NotImplementedError: mosaic, random_perspective,
    augment_hsv and the flips are training (ROADMAP queue 1, module 8).
    `hyp` is accepted for the JAX signature and unused here. The images
    and labels come from `_enumerate` and `load_image`, which a subclass
    may override to serve them from memory."""

    def __init__(self, path, img_size: int = 640, augment: bool = False,
                 hyp: Optional[Dict] = None, kpt_label: int = 5,
                 stride: int = 32, cache_images: bool = False,
                 prefix: str = "", rect: bool = False,
                 batch_size: int = 16, pad: float = 0.0,
                 single_cls: bool = False):
        if augment:
            raise NotImplementedError(
                "FaceDataset(augment=True): the augmenting path (mosaic, "
                "random_perspective, augment_hsv, flips) is training, not "
                "ported yet (ROADMAP queue 1, module 8)")
        self.img_size = img_size
        self.augment = augment
        self.hyp = hyp or {}
        self.kpt_label = kpt_label
        self.stride = stride
        self.rect = rect

        (self.img_files, self.label_files, self.labels,
         self.shapes) = self._enumerate(path, prefix)
        if single_cls:  # force one class (utils/datasets.py:419-421)
            self.labels = [l.copy() for l in self.labels]
            for l in self.labels:
                if len(l):
                    l[:, 0] = 0
        self.n = len(self.img_files)
        self.indices = list(range(self.n))

        # Rectangular batching: sort by aspect ratio and give each batch
        # the minimal stride-aligned (h, w) that fits its images
        # (utils/datasets.py:431-454). NOTE the reference fork hard-forces
        # `self.rect = False` (utils/datasets.py:357), so its own val
        # protocol always runs the square letterbox — rect here is the
        # opt-in restoration of the upstream protocol, off by default.
        self.batch = np.floor(
            np.arange(self.n) / batch_size).astype(int)
        self.batch_shapes = None
        if rect:
            s = np.asarray(self.shapes, np.float64)  # (n, 2) wh
            ar = s[:, 1] / s[:, 0]  # h / w
            irect = ar.argsort()
            self.img_files = [self.img_files[i] for i in irect]
            self.label_files = [self.label_files[i] for i in irect]
            self.labels = [self.labels[i] for i in irect]
            self.shapes = s[irect]
            ar = ar[irect]
            nb = int(self.batch[-1]) + 1
            shapes_b = [[1.0, 1.0]] * nb
            for i in range(nb):
                ari = ar[self.batch == i]
                mini, maxi = ari.min(), ari.max()
                if maxi < 1:
                    shapes_b[i] = [maxi, 1.0]
                elif mini > 1:
                    shapes_b[i] = [1.0, 1.0 / mini]
            self.batch_shapes = (np.ceil(
                np.array(shapes_b) * img_size / stride + pad)
                .astype(int) * stride)
        self._img_cache: Dict[int, Tuple] = {}
        if cache_images:
            for i in range(self.n):
                self._img_cache[i] = self._load_image_uncached(i)

    def _enumerate(self, path, prefix: str):
        """(image files, label files, labels, shapes (n, 2) as (w, h)) of
        `path`: a directory, a list file or a list of either
        (utils/datasets.py:367-390), the labels and shapes through the
        label cache."""
        files: List[str] = []
        for p in path if isinstance(path, list) else [path]:
            p = Path(p)
            if p.is_dir():
                files += glob.glob(str(p / "**" / "*.*"), recursive=True)
            elif p.is_file():
                with open(p) as t:
                    parent = str(p.parent) + os.sep
                    for x in t.read().strip().splitlines():
                        files.append(x.replace("./", parent)
                                     if x.startswith("./") else x)
            else:
                raise FileNotFoundError(f"{prefix}{p} does not exist")
        img_files = sorted(
            x.split(" ")[0] for x in files
            if x.split(" ")[0].rsplit(".", 1)[-1].lower() in IMG_FORMATS)
        assert img_files, f"{prefix}no images found in {path}"
        label_files = img2label_paths(img_files)

        # label cache (the reference's *.cache equivalent,
        # utils/datasets.py:394-418), stored as an npz keyed by a
        # path+size hash
        cache_path = Path(label_files[0]).parent.with_suffix(
            ".labels.npz") if label_files else None
        key = _files_hash(img_files + label_files)
        cache = None
        if cache_path and cache_path.is_file():
            try:
                loaded = np.load(cache_path, allow_pickle=True)
                if str(loaded["key"]) == key:
                    cache = (list(loaded["labels"]), loaded["shapes"])
            except Exception:
                cache = None
        if cache is None:
            from PIL import Image

            labels = [load_label_file(lb, self.kpt_label)
                      for lb in label_files]
            shapes = np.array([exif_size(Image.open(p))
                               for p in img_files], np.float64)
            cache = (labels, shapes)
            if cache_path:
                try:
                    np.savez_compressed(
                        cache_path, key=key,
                        labels=np.array(labels, dtype=object),
                        shapes=shapes)
                except OSError:
                    pass
        return img_files, label_files, cache[0], cache[1]

    def __len__(self):
        return self.n

    # ------------------------------------------------------------------

    def _load_image_uncached(self, index: int):
        import cv2

        img = cv2.imread(self.img_files[index])
        assert img is not None, f"Image Not Found {self.img_files[index]}"
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            interp = cv2.INTER_AREA if r < 1 else cv2.INTER_LINEAR
            img = cv2.resize(img, (int(w0 * r), int(h0 * r)),
                             interpolation=interp)
        return img, (h0, w0), img.shape[:2]

    def load_image(self, index: int):
        """Longest-side resize to img_size (utils/datasets.py:680-696):
        (img HWC BGR uint8, (h0, w0), (h, w))."""
        if index in self._img_cache:
            img, hw0, hw = self._img_cache[index]
            return img.copy(), hw0, hw
        return self._load_image_uncached(index)

    # ------------------------------------------------------------------

    def get(self, index: int):
        """One validation example: (img HWC RGB uint8, labels (n, 5+2k)
        normalized to the letterboxed frame, path, shapes), as the JAX
        dataset's non-augmenting branch (reference utils/datasets.py:
        551-645 without its draws), through the indices indirection
        (utils/datasets.py:551)."""
        index = self.indices[index]
        img, (h0, w0), (h, w) = self.load_image(index)
        # per-batch rect shape when rect, else the square img_size
        # (utils/datasets.py:573)
        shape = (tuple(self.batch_shapes[self.batch[index]])
                 if self.rect else self.img_size)
        img, ratio, pad = letterbox(img, shape, auto=False, scaleup=False)
        shapes = (h0, w0), ((h / h0, w / w0), pad)
        labels = self.labels[index].copy()
        if labels.size:
            labels[:, 1:] = _xywhn2xyxy_kpt(
                labels[:, 1:], ratio[0] * w, ratio[1] * h,
                pad[0], pad[1], self.kpt_label)

        if len(labels):
            labels[:, 1:5] = _xyxy2xywh_rows(labels[:, 1:5])
            labels[:, [2, 4]] /= img.shape[0]
            labels[:, [1, 3]] /= img.shape[1]
            if self.kpt_label:
                labels[:, 6::2] /= img.shape[0]
                labels[:, 5::2] /= img.shape[1]

        img = np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB, HWC
        return img, labels.astype(np.float32), self.img_files[index], shapes


# ---------------------------------------------------------------------------
# label geometry
# ---------------------------------------------------------------------------

def _xywhn2xyxy_kpt(x, w, h, padw, padh, kpt_label):
    """Normalized xywh (+ normalized kpts) -> pixel xyxy (+ pixel kpts),
    zeros staying zero (utils/general.py:322-338)."""
    y = x.copy()
    y[:, 0] = w * (x[:, 0] - x[:, 2] / 2) + padw
    y[:, 1] = h * (x[:, 1] - x[:, 3] / 2) + padh
    y[:, 2] = w * (x[:, 0] + x[:, 2] / 2) + padw
    y[:, 3] = h * (x[:, 1] + x[:, 3] / 2) + padh
    if kpt_label:
        kx = x[:, 4::2]
        ky = x[:, 5::2]
        y[:, 4::2] = np.where(kx != 0, w * kx + padw, 0)
        y[:, 5::2] = np.where(ky != 0, h * ky + padh, 0)
    return y


def _xyxy2xywh_rows(x):
    y = x.copy()
    y[:, 0] = (x[:, 0] + x[:, 2]) / 2
    y[:, 1] = (x[:, 1] + x[:, 3]) / 2
    y[:, 2] = x[:, 2] - x[:, 0]
    y[:, 3] = x[:, 3] - x[:, 1]
    return y


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------

def collate(samples) -> Tuple[np.ndarray, np.ndarray, list, list]:
    """Stack samples: images (B, H, W, 3) uint8 RGB; labels (N, 6+2k)
    rows [img_idx, cls, x, y, w, h, kpts...] (the reference collate_fn,
    utils/datasets.py:647-652, in NHWC)."""
    imgs, labels, paths, shapes = zip(*samples)
    out_labels = []
    for i, l in enumerate(labels):
        if len(l):
            out_labels.append(np.concatenate(
                [np.full((len(l), 1), i, np.float32), l], axis=1))
    n_cols = labels[0].shape[1] + 1 if len(labels[0].shape) == 2 else 16
    merged = (np.concatenate(out_labels, 0) if out_labels
              else np.zeros((0, n_cols), np.float32))
    return np.stack(imgs), merged, list(paths), list(shapes)


# -- process-pool worker plumbing (module-level so spawn can import it) --

_WORKER_DS: Optional[FaceDataset] = None


def _proc_worker_init(dataset: FaceDataset):
    """Runs once in each worker process; with the fork start method the
    dataset arrives by copy-on-write inheritance (no pickle), with spawn
    it is pickled once per worker."""
    global _WORKER_DS
    _WORKER_DS = dataset


def _proc_get_batch(task):
    """Assemble one full batch inside a worker process.

    Seeded per (loader seed, epoch, batch index), NOT per worker — the
    augmentation draw for a given batch is deterministic no matter which
    worker picks the task (the reference instead seeds each torch worker
    process, utils/datasets.py:59-87 + torch worker_init, which makes the
    stream depend on the worker->batch schedule).

    `ds_indices` is the parent's CURRENT dataset.indices when it has
    diverged from the fork-time snapshot (per-epoch --image-weights
    resampling, cli/train.py) — the worker's forked dataset would keep
    the epoch-0 list forever. None = unchanged since fork (the common
    unweighted case: zero extra IPC); once diverged, the compact int
    array rides with every task so any worker is always current."""
    idxs, batch_seed, ds_indices = task
    if ds_indices is not None:
        _WORKER_DS.indices = ds_indices
    if batch_seed is not None:
        random.seed(batch_seed)
        np.random.seed(batch_seed % (2 ** 32))
    return [_WORKER_DS.get(int(i)) for i in idxs]


class DataLoader:
    """Shuffling, optionally host-sharded, prefetched loader.

    Per-host sharding replaces DistributedSampler (utils/datasets.py:78):
    host k of K takes every K-th index after the epoch-seeded shuffle.

    Worker modes (the InfiniteDataLoader-with-workers equivalent,
    utils/datasets.py:59-121):
    - mode="thread" (default): samples of each batch fetched through a
      thread pool — cv2 releases the GIL, but label/target assembly is
      pure Python, so this tops out near 1 core of Python work.
    - mode="process": each batch is assembled end-to-end (decode +
      augment + label build) inside one of `workers` persistent worker
      processes, mirroring the reference's dataloader worker processes;
      finished batches return over pipes. Augmentation RNG is seeded per
      (seed, epoch, batch) so results are schedule-independent — but the
      stream differs from the serial/thread modes' shared global stream.
    - workers <= 1 keeps the exact serial global-RNG draw order the
      seeded parity tests rely on.

    The prefetch queue overlaps batch assembly with the train step in
    every mode.
    """

    def __init__(self, dataset: FaceDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0,
                 drop_last: bool = True, prefetch: int = 2,
                 workers: int = 4, mode: str = "thread"):
        if getattr(dataset, "rect", False):
            # rect batch shapes are computed for sequential whole-dataset
            # iteration (batch i = indices [i*bs, (i+1)*bs)); shuffling
            # or host-sharding would mix shapes inside one stacked batch
            assert not shuffle and num_hosts == 1, (
                "rect datasets require shuffle=False, num_hosts=1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = workers
        assert mode in ("thread", "process"), mode
        self.mode = mode
        self.epoch = 0
        self._pool = None  # persistent process pool
        if self.mode == "process" and self.workers > 1:
            # fork the pool EAGERLY: forking after the torch runtime has
            # spawned its worker threads risks the classic
            # fork-while-a-thread-holds-a-lock deadlock in the children;
            # at loader construction the runtime is usually not (fully)
            # up yet, which is the safest point we control
            self._get_pool()

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _get_pool(self):
        if self._pool is None:
            import multiprocessing as mp

            # fork: dataset inherited copy-on-write, no per-worker
            # pickle of the image cache; spawn fallback elsewhere
            methods = mp.get_all_start_methods()
            ctx = mp.get_context(
                "fork" if "fork" in methods else "spawn")
            # snapshot identity: tasks ship dataset.indices only after
            # the parent reassigns it (image-weights resampling) —
            # unweighted epochs pay no per-task indices IPC
            self._fork_indices = self.dataset.indices
            self._pool = ctx.Pool(self.workers,
                                  initializer=_proc_worker_init,
                                  initargs=(self.dataset,))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.dataset) // self.num_hosts
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.host_id::self.num_hosts]

    def __iter__(self):
        if self.mode == "process" and self.workers > 1:
            yield from self._iter_process()
            return
        idx = self._epoch_indices()
        nb = len(self)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)

        def produce():
            try:
                if self.workers > 1:
                    from concurrent.futures import ThreadPoolExecutor
                    with ThreadPoolExecutor(self.workers) as ex:
                        for b in range(nb):
                            chunk = idx[b * self.batch_size:
                                        (b + 1) * self.batch_size]
                            samples = list(ex.map(
                                self.dataset.get,
                                [int(i) for i in chunk]))
                            q.put(collate(samples))
                else:
                    for b in range(nb):
                        chunk = idx[b * self.batch_size:
                                    (b + 1) * self.batch_size]
                        samples = [self.dataset.get(int(i))
                                   for i in chunk]
                        q.put(collate(samples))
                q.put(None)
            except BaseException as e:  # surface worker errors
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def _iter_process(self):
        """Process-pool epoch: one task per batch, at most
        workers + prefetch outstanding so a slow consumer never buffers
        the whole epoch in result pipes."""
        from collections import deque

        idx = self._epoch_indices()
        nb = len(self)
        pool = self._get_pool()
        max_inflight = self.workers + max(self.prefetch, 1)
        inflight: deque = deque()
        b = 0
        while b < nb or inflight:
            while b < nb and len(inflight) < max_inflight:
                chunk = [int(i) for i in
                         idx[b * self.batch_size:
                             (b + 1) * self.batch_size]]
                batch_seed = hash((self.seed, self.epoch, b)) & 0x7FFFFFFF
                cur = self.dataset.indices
                ship = (None if cur is self._fork_indices
                        else np.asarray(cur, np.int64))
                inflight.append(pool.apply_async(
                    _proc_get_batch, ((chunk, batch_seed, ship),)))
                b += 1
            yield collate(inflight.popleft().get())
