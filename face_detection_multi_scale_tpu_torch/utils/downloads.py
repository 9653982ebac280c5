"""Asset download helpers (a copy of the JAX package's utils/downloads.py;
the module needs neither framework).

Reference parity: utils/google_utils.py:19-91 `attempt_download` — fetch a
missing weights file from a GitHub release (or any URL) before loading.
`FaceDetector(torch_weights=...)` calls `attempt_download` on its path, as
the JAX detector does.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

DEFAULT_RELEASE = ("https://github.com/derronqi/yolov7-face/releases/"
                   "download/v1.0")


def download_url(url: str, dest: str, chunk: int = 1 << 20) -> str:
    """Fetch `url` into `dest` through `dest + ".part"`, swapped in whole
    once the body has been read."""
    import urllib.request

    Path(dest).parent.mkdir(parents=True, exist_ok=True)
    req = urllib.request.Request(url, headers={"User-Agent": "wget"})
    tmp = dest + ".part"
    with urllib.request.urlopen(req) as resp, open(tmp, "wb") as out:
        while True:
            buf = resp.read(chunk)
            if not buf:
                break
            out.write(buf)
    os.replace(tmp, dest)
    return dest


def attempt_download(path: str, release_base: str = DEFAULT_RELEASE,
                     url: Optional[str] = None) -> str:
    """Return `path`, downloading it first if missing: explicit `url`, or
    `{release_base}/{basename}` (the GitHub-release convention of
    utils/google_utils.py:19-53). Only weights files (.pt, .npz,
    .stablehlo) are fetched; any other path comes back unchanged."""
    if os.path.exists(path) or not str(path).endswith((".pt", ".npz",
                                                       ".stablehlo")):
        return path
    src = url or f"{release_base}/{os.path.basename(path)}"
    print(f"downloading {src} -> {path}")
    try:
        return download_url(src, path)
    except Exception as e:
        raise FileNotFoundError(
            f"{path} not found locally and download failed: {e}") from e
