#!/usr/bin/env python
"""WIDER FACE dataset downloader (a copy of the repo-root
cli/download_widerface.py; it needs neither framework).

Same surface and sources as the reference downloader
(reference download_widerface.py:58-143): HuggingFace CUHK-CSE mirror,
train/val/test zips + annotation split, skip-if-extracted, progress.

    python -m face_detection_multi_scale_tpu_torch.cli.download_widerface \
        [--output_dir ./data/widerface] [--keep_zip] [--download_all]
"""

from __future__ import annotations

import argparse
import sys
import zipfile
from pathlib import Path

URLS = {
    "train": "https://huggingface.co/datasets/CUHK-CSE/wider_face/resolve/main/data/WIDER_train.zip",
    "val": "https://huggingface.co/datasets/CUHK-CSE/wider_face/resolve/main/data/WIDER_val.zip",
    "test": "https://huggingface.co/datasets/CUHK-CSE/wider_face/resolve/main/data/WIDER_test.zip",
    "annot": "https://huggingface.co/datasets/CUHK-CSE/wider_face/resolve/main/data/wider_face_split.zip",
}


def download(url: str, dest: Path, chunk: int = 1 << 20):
    """Stream `url` into `dest`, printing the progress when the size is
    known."""
    import urllib.request

    req = urllib.request.Request(url, headers={"User-Agent": "wget"})
    with urllib.request.urlopen(req) as resp, open(dest, "wb") as out:
        total = int(resp.headers.get("Content-Length", 0))
        done = 0
        while True:
            buf = resp.read(chunk)
            if not buf:
                break
            out.write(buf)
            done += len(buf)
            if total:
                pct = 100 * done / total
                print(f"\r  {dest.name}: {done >> 20} MB "
                      f"({pct:.1f}%)", end="", flush=True)
        print()


def main(argv=None):
    ap = argparse.ArgumentParser(description="Download WIDER FACE dataset")
    ap.add_argument("--output_dir", default="./data/widerface")
    ap.add_argument("--keep_zip", action="store_true")
    ap.add_argument("--download_all", action="store_true",
                    help="train + val + test + annotations "
                         "(default: train + annotations)")
    args = ap.parse_args(argv)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    wanted = (["train", "val", "test", "annot"] if args.download_all
              else ["train", "annot"])
    for name in wanted:
        url = URLS[name]
        filename = ("wider_face_split.zip" if name == "annot"
                    else f"WIDER_{name}.zip")
        extracted = out / ("wider_face_split" if name == "annot"
                           else f"WIDER_{name}")
        local = out / filename
        if extracted.exists():
            print(f"exists, skipping: {extracted}")
            continue
        if not local.exists():
            print(f"downloading {url}")
            download(url, local)
        print(f"extracting {local}")
        with zipfile.ZipFile(local) as z:
            z.extractall(out)
        if not args.keep_zip:
            local.unlink()
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
