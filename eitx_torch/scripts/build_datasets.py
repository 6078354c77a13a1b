"""Offline dataset builders (CLI).

Port of eitx/scripts/build_datasets.py: the HU transform, body masks,
windowing, normalisation, pseudo-labels and the two networks run on
``device`` (``--device``, the card unless the caller asks for the CPU);
files are written as eitx writes them.

Parity with the reference's scripts family:
  - axial:   DICOM zips -> windowed axial slices + HU pseudo-labels
             (create_femm_dataset.py / create_axial_dataset.py)
  - nii:     NIfTI volumes -> same, with mm-scaled spacing recorded
             (create_axial_dataset_from_nii.py)
  - frontal: DICOM series -> frontal-view images for rib training
             (create_front_dataset_from_dicom.py)
  - autolabel: run the tissue segmenter on images and emit YOLO labels
             (create_rib_labels.py style model-assisted labeling)
  - riblabel: the rib detector's boxes as YOLO detection labels

    python -m eitx_torch.scripts.build_datasets frontal a.zip --out d/ \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import numpy as np

logger = logging.getLogger("eitx_torch.scripts")


def _save_image(path: str, img: np.ndarray) -> None:
    from ..io.images import to_png_bytes

    with open(path, "wb") as fh:
        fh.write(to_png_bytes(img))


def build_axial_dataset(zip_paths, out_dir: str, window=(40.0, 400.0),
                        device="cuda"):
    from ..image import body_mask_from_hu, hu_transform, window_normalize
    from ..io.zips import largest_series_from_zip
    from .pseudo_label import labels_to_yolo_lines, pseudo_label_slice

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "labels"), exist_ok=True)
    n = 0
    for zp in zip_paths:
        with open(zp, "rb") as fh:
            slices, _ = largest_series_from_zip(fh)
        stem = os.path.splitext(os.path.basename(zp))[0]
        for i, ds in enumerate(slices):
            hu = hu_transform(ds.pixel_array, ds.rescale_slope,
                              ds.rescale_intercept, device=device)
            mask = body_mask_from_hu(hu, flipud=True)
            img = window_normalize(hu, *window) * (mask > 0)
            labels = pseudo_label_slice(hu.flip(0, 1).cpu().numpy(), mask,
                                        device=device)
            lines = labels_to_yolo_lines(labels)
            name = f"{stem}_{i:04d}"
            _save_image(os.path.join(out_dir, "images", name + ".png"),
                        img.cpu().numpy())
            with open(os.path.join(out_dir, "labels", name + ".txt"), "w") as fh:
                fh.write("\n".join(lines))
            n += 1
    logger.info("wrote %d axial samples to %s", n, out_dir)
    return n


def build_nii_dataset(nii_paths, out_dir: str, window=(40.0, 400.0),
                      stride: int = 1, device="cuda"):
    """NIfTI volumes -> windowed axial slices + HU pseudo-labels
    (create_axial_dataset_from_nii parity: data is already HU, spacing
    recorded from pixdim, every ``stride``-th slice)."""
    from ..image import body_mask_from_hu_batch, window_normalize
    from ..io.nifti import read_nifti
    from .pseudo_label import labels_to_yolo_lines, pseudo_label_stack

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "labels"), exist_ok=True)
    n = 0
    for path in nii_paths:
        vol, pixdim = read_nifti(path)
        stem = os.path.splitext(os.path.basename(path))[0].replace(".nii", "")
        sel = range(0, vol.shape[-1], stride)
        hu_stack = np.stack(
            [np.fliplr(vol[:, :, k].T) for k in sel]
        ).astype(np.float32)  # rotate 90 CW like the serving path
        masks = body_mask_from_hu_batch(hu_stack, device=device)
        labels = pseudo_label_stack(hu_stack, masks, device=device)
        imgs = (window_normalize(hu_stack, *window, device=device)
                * (masks > 0).flip(-2, -1)).cpu().numpy()
        with open(os.path.join(out_dir, f"{stem}_spacing.txt"), "w") as fh:
            fh.write(f"{pixdim[1]} {pixdim[2]}\n")
        for j, k in enumerate(sel):
            name = f"{stem}_{k:04d}"
            _save_image(os.path.join(out_dir, "images", name + ".png"),
                        imgs[j])
            lines = labels_to_yolo_lines(labels[j])
            with open(os.path.join(out_dir, "labels", name + ".txt"), "w") as fh:
                fh.write("\n".join(lines))
            n += 1
    logger.info("wrote %d nii samples to %s", n, out_dir)
    return n


def build_frontal_dataset(zip_paths, out_dir: str, device="cuda"):
    from ..image.normalize import minmax_normalize_u8
    from ..image.orientation import axial_stack_to_frontal, stack_axial_slices
    from ..io.zips import largest_series_from_zip

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for zp in zip_paths:
        with open(zp, "rb") as fh:
            slices, _ = largest_series_from_zip(fh)
        slices.sort(key=lambda s: s.instance_number)
        vol = stack_axial_slices([s.pixel_array for s in slices])
        frontal = axial_stack_to_frontal(
            vol, slices[0].patient_position or "HFS",
            slices[0].image_orientation, slices[0].patient_orientation,
        )
        stem = os.path.splitext(os.path.basename(zp))[0]
        for k in range(frontal.shape[-1]):
            img = minmax_normalize_u8(frontal[:, :, k], device=device)
            _save_image(os.path.join(out_dir, f"{stem}_f{k:03d}.png"),
                        img.cpu().numpy())
            n += 1
    logger.info("wrote %d frontal slices to %s", n, out_dir)
    return n


def auto_label_images(image_paths, out_dir: str, weights: Optional[str],
                      imgsz: int = 512, device="cuda"):
    from ..io.images import decode_image
    from ..models.yolo.infer import TissueSegmenter
    from .pseudo_label import labels_to_yolo_lines

    os.makedirs(out_dir, exist_ok=True)
    seg = TissueSegmenter(imgsz=imgsz, weights=weights, device=device)
    n = 0
    for path in image_paths:
        with open(path, "rb") as fh:
            img = decode_image(fh.read())
        labels, _ = seg.predict_labels(img)
        lines = labels_to_yolo_lines(labels)
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(out_dir, stem + ".txt"), "w") as fh:
            fh.write("\n".join(lines))
        n += 1
    logger.info("auto-labeled %d images into %s", n, out_dir)
    return n


def auto_label_ribs(image_paths, out_dir: str, weights: Optional[str],
                    conf: float = 0.5, device="cuda"):
    """Model-assisted rib box labeling: run the rib detector over frontal
    images and emit YOLO *detection* labels "cls cx cy w h" (normalized) —
    create_rib_labels.py parity."""
    from ..io.images import decode_image
    from ..models.yolo.infer import RibsDetector

    os.makedirs(out_dir, exist_ok=True)
    det_model = RibsDetector(weights=weights, conf=conf, device=device)
    n = 0
    for path in image_paths:
        with open(path, "rb") as fh:
            img = decode_image(fh.read())
        if img.ndim == 3:
            img = img[..., 0]
        h, w = img.shape
        det = det_model.predict(img)
        lines = []
        for box, valid in zip(det.boxes, det.valid):
            if not valid:
                continue
            x1, y1, x2, y2 = box
            cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
            bw, bh = (x2 - x1) / w, (y2 - y1) / h
            lines.append(f"0 {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(out_dir, stem + ".txt"), "w") as fh:
            fh.write("\n".join(lines))
        n += 1
    logger.info("rib-labeled %d images into %s", n, out_dir)
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="eitx_torch dataset builders")
    p.add_argument("--device", default="cuda")
    sub = p.add_subparsers(dest="cmd", required=True)
    ax = sub.add_parser("axial")
    ax.add_argument("zips", nargs="+")
    ax.add_argument("--out", required=True)
    ni = sub.add_parser("nii")
    ni.add_argument("niis", nargs="+")
    ni.add_argument("--out", required=True)
    ni.add_argument("--stride", type=int, default=1)
    fr = sub.add_parser("frontal")
    fr.add_argument("zips", nargs="+")
    fr.add_argument("--out", required=True)
    al = sub.add_parser("autolabel")
    al.add_argument("images", nargs="+")
    al.add_argument("--out", required=True)
    al.add_argument("--weights", default=None)
    rl = sub.add_parser("riblabel")
    rl.add_argument("images", nargs="+")
    rl.add_argument("--out", required=True)
    rl.add_argument("--weights", default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = args.device
    if args.cmd == "axial":
        return build_axial_dataset(args.zips, args.out, device=dev)
    if args.cmd == "nii":
        return build_nii_dataset(args.niis, args.out, stride=args.stride,
                                 device=dev)
    if args.cmd == "frontal":
        return build_frontal_dataset(args.zips, args.out, device=dev)
    if args.cmd == "riblabel":
        return auto_label_ribs(args.images, args.out, args.weights,
                               device=dev)
    return auto_label_images(args.images, args.out, args.weights, device=dev)


if __name__ == "__main__":
    main()
