"""Developer utilities mirroring the reference's scripts/ experiments.

Port of eitx/scripts/devtools.py. Reference counterparts
(kt_service/scripts/):
  - label.py: YOLO dataset 70/30 train/valid split ->
    :func:`split_yolo_dataset` (stdlib only, seeded shuffle, images and
    labels moved together).
  - cnt_draw.py: rasterize a flat coordinate list as a polyline for
    visual debugging -> :func:`draw_polyline` (numpy raster, no OpenCV).
  - test_lungmask.py: lung contours drawn over a DICOM slice ->
    :func:`lung_overlay` (the trained tissue segmenter provides the lung
    mask on ``device``; contours come from the native tracer).

Usage:
    python -m eitx_torch.scripts.devtools split  SRC_DIR DST_DIR [--ratio 0.7]
    python -m eitx_torch.scripts.devtools cnt    x1 y1 x2 y2 ... [--out p.png]
    python -m eitx_torch.scripts.devtools lungs  SLICE.dcm [--out overlay.png]
                                                 [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np


def split_yolo_dataset(
    src: str,
    dst: str,
    split_ratio: float = 0.7,
    seed: int = 42,
) -> Tuple[int, int]:
    """Split a YOLO-layout dataset (src/images + src/labels) into
    dst/train/{images,labels} and dst/valid/{images,labels}.

    Images without a label file keep an empty .txt (negative sample),
    matching ultralytics' dataset conventions. Returns
    (n_train, n_valid)."""
    images = sorted(os.listdir(os.path.join(src, "images")))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(images))
    n_train = int(round(len(images) * split_ratio))
    picks = {"train": order[:n_train], "valid": order[n_train:]}
    for part, idxs in picks.items():
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(dst, part, sub), exist_ok=True)
        for i in idxs:
            name = images[int(i)]
            stem = os.path.splitext(name)[0]
            shutil.copy(
                os.path.join(src, "images", name),
                os.path.join(dst, part, "images", name),
            )
            lab = os.path.join(src, "labels", stem + ".txt")
            out_lab = os.path.join(dst, part, "labels", stem + ".txt")
            if os.path.exists(lab):
                shutil.copy(lab, out_lab)
            else:
                open(out_lab, "w").close()
    return n_train, len(images) - n_train


def _raster_line(img: np.ndarray, p0, p1, value) -> None:
    """Draw a 1-px line into ``img`` (H, W[, C]) in place."""
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.clip(np.round(np.linspace(x0, x1, n + 1)).astype(int),
                 0, img.shape[1] - 1)
    ys = np.clip(np.round(np.linspace(y0, y1, n + 1)).astype(int),
                 0, img.shape[0] - 1)
    img[ys, xs] = value


def draw_polyline(
    coords: List[float],
    size: Tuple[int, int] = (200, 200),
    close: bool = False,
) -> np.ndarray:
    """Flat [x1, y1, x2, y2, ...] list -> (H, W) uint8 image with the
    polyline drawn white (the reference's cnt_draw.py debugging aid,
    without the cv2 GUI loop)."""
    pts = np.asarray(coords, np.float64).reshape(-1, 2)
    img = np.zeros(size, np.uint8)
    for i in range(len(pts) - 1):
        _raster_line(img, pts[i], pts[i + 1], 255)
    if close and len(pts) > 2:
        _raster_line(img, pts[-1], pts[0], 255)
    return img


def lung_overlay(
    dicom_path: str,
    weights: Optional[str] = None,
    imgsz: int = 256,
    device="cuda",
) -> np.ndarray:
    """Lung contours drawn green over a windowed DICOM slice.

    The reference uses the external lungmask UNet (R231); the trained
    tissue segmenter supplies the lung class instead, on ``device``, and
    the contours come from the native tracer. Returns an (H, W, 3) uint8
    BGR overlay."""
    from ..contours.trace import find_external_contours
    from ..image import window_normalize
    from ..io.dicom import read_dicom
    from ..models.yolo.infer import TissueSegmenter

    with open(dicom_path, "rb") as fh:
        ds = read_dicom(fh.read())
    hu = ds.pixel_array.astype(np.float32) * ds.rescale_slope + (
        ds.rescale_intercept
    )
    img = window_normalize(hu, 40.0, 400.0, device=device).cpu().numpy(
    ).astype(np.uint8)
    if weights is None:
        from ..core.weights import find_checkpoint

        weights = find_checkpoint("tissue", imgsz)
        if weights is None:
            raise SystemExit(
                f"no trained tissue checkpoint for imgsz={imgsz} under "
                "weights/ — pass an explicit weights path (a random-"
                "init segmenter would draw garbage contours)"
            )
    seg = TissueSegmenter(imgsz=imgsz, weights=weights, max_det=16,
                          device=device)
    labels = seg.segment_labels(img[None], compose_full=True)[0]
    overlay = np.repeat(img[..., None], 3, axis=-1)
    for cnt in find_external_contours((labels == 2).astype(np.uint8)):
        pts = cnt.astype(np.int64)
        overlay[pts[:, 1], pts[:, 0]] = (0, 255, 0)
    return overlay


def main(argv=None):
    p = argparse.ArgumentParser(description="eitx_torch dev utilities")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("split")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.add_argument("--ratio", type=float, default=0.7)
    sp.add_argument("--seed", type=int, default=42)
    cp = sub.add_parser("cnt")
    cp.add_argument("coords", nargs="+", type=float)
    cp.add_argument("--out", default="cnt.png")
    lp = sub.add_parser("lungs")
    lp.add_argument("dicom")
    lp.add_argument("--out", default="lung_overlay.png")
    lp.add_argument("--weights", default=None)
    lp.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.cmd == "split":
        n_t, n_v = split_yolo_dataset(args.src, args.dst, args.ratio,
                                      args.seed)
        print(f"split: {n_t} train / {n_v} valid")
    elif args.cmd == "cnt":
        img = draw_polyline(args.coords)
        _save_png(args.out, np.repeat(img[..., None], 3, -1))
        print("wrote", args.out)
    elif args.cmd == "lungs":
        overlay = lung_overlay(args.dicom, weights=args.weights,
                               device=args.device)
        _save_png(args.out, overlay)
        print("wrote", args.out)


def _save_png(path: str, rgb: np.ndarray) -> None:
    from ..io import to_png_bytes

    with open(path, "wb") as fh:
        fh.write(to_png_bytes(rgb))


if __name__ == "__main__":
    main()
