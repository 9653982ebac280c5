"""Video / webcam / RTSP stream readers.

A copy of the JAX package's data/streams.py, the reference stream
loaders (reference utils/datasets.py:124-201 LoadImages, :204-259
LoadWebcam, :262-340 LoadStreams with threaded grabbers and 4x frame
skipping). These yield raw BGR frames; preprocessing happens in the
detector. OpenCV is imported inside each loader.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp",
               "mpo"}
VID_FORMATS = {"mov", "avi", "mp4", "mpg", "mpeg", "m4v", "wmv", "mkv"}


class LoadImages:
    """Iterate images and video files: yields (path, frame_bgr, cap_or_None)
    (utils/datasets.py:124-201 semantics)."""

    def __init__(self, path: str):
        import cv2

        p = str(Path(path).resolve())
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "*.*")))
        elif os.path.isfile(p):
            files = [p]
        else:
            raise FileNotFoundError(p)
        self.images = [f for f in files
                       if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS]
        self.videos = [f for f in files
                       if f.rsplit(".", 1)[-1].lower() in VID_FORMATS]
        self.nf = len(self.images) + len(self.videos)
        assert self.nf > 0, f"no images or videos in {path}"
        self._cv2 = cv2

    def __iter__(self):
        for f in self.images:
            img = self._cv2.imread(f)
            if img is not None:
                yield f, img, None
        for f in self.videos:
            cap = self._cv2.VideoCapture(f)
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield f, frame, cap
            cap.release()

    def __len__(self):
        return self.nf


class LoadWebcam:
    """Single-camera grabber (utils/datasets.py:204-259): always returns
    the freshest frame."""

    def __init__(self, source: str = "0"):
        import cv2

        self.cap = cv2.VideoCapture(int(source) if source.isdigit()
                                    else source)
        assert self.cap.isOpened(), f"failed to open {source}"

    def __iter__(self):
        while True:
            self.cap.grab()
            ok, frame = self.cap.retrieve()
            if not ok:
                break
            yield "webcam", frame, self.cap
        self.cap.release()


class LoadStreams:
    """Multi-stream threaded reader (utils/datasets.py:262-340): one
    daemon thread per source keeps only the latest frame, reading every
    4th frame (frame-skip x4, :310-314). Iteration yields the latest
    frame of every stream as a list."""

    def __init__(self, sources, skip: int = 4):
        import cv2

        if isinstance(sources, str):
            if os.path.isfile(sources) and not sources.split(".")[-1] in \
                    VID_FORMATS:
                with open(sources) as f:
                    sources = [s.strip() for s in f if s.strip()]
            else:
                sources = [sources]
        self.sources = list(sources)
        self.frames: List[Optional[np.ndarray]] = [None] * len(self.sources)
        self.caps = []
        self.skip = skip
        self._stop = threading.Event()
        for i, s in enumerate(self.sources):
            cap = cv2.VideoCapture(int(s) if str(s).isdigit() else s)
            assert cap.isOpened(), f"failed to open {s}"
            ok, self.frames[i] = cap.read()
            self.caps.append(cap)
            t = threading.Thread(target=self._update, args=(i, cap),
                                 daemon=True)
            t.start()

    def _update(self, i: int, cap):
        n = 0
        while not self._stop.is_set() and cap.isOpened():
            n += 1
            cap.grab()
            if n % self.skip == 0:
                ok, frame = cap.retrieve()
                if ok:
                    self.frames[i] = frame
            time.sleep(0.01)

    def __iter__(self):
        while not self._stop.is_set():
            if any(f is None for f in self.frames):
                break
            yield self.sources, [f.copy() for f in self.frames], None

    def close(self):
        self._stop.set()
        for cap in self.caps:
            cap.release()
