"""Dataset evaluation harness (PixelLevelEvaluator parity).

Port of eitx/eval/harness.py. Runs the tissue segmenter over an
images/labels directory pair (YOLO polygon ground truth) and reports
per-class pixel metrics — the reference's scripts/accuracy_calculate.py
workflow: whole same-shape chunks of ``batch`` images go through the
segmenter's batched label path on ``device``, ragged chunks image by
image."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..io.images import decode_image
from .metrics import evaluate_dataset, mask_from_yolo_labels, print_results


class PixelLevelEvaluator:
    def __init__(
        self,
        segmenter=None,
        model_path: Optional[str] = None,
        images_dir: str = "",
        labels_dir: str = "",
        img_size: int = 512,
        batch: int = 16,
        device="cuda",
    ):
        if segmenter is None:
            from ..models.yolo.infer import TissueSegmenter

            segmenter = TissueSegmenter(imgsz=img_size, weights=model_path,
                                        device=device)
        self.segmenter = segmenter
        self.images_dir = images_dir
        self.labels_dir = labels_dir
        self.batch = batch

    def _image_files(self) -> List[str]:
        exts = (".png", ".jpg", ".jpeg", ".bmp")
        return sorted(
            f for f in os.listdir(self.images_dir)
            if f.lower().endswith(exts)
        )

    def evaluate(self, limit: Optional[int] = None) -> Dict:
        files = self._image_files()
        if limit:
            files = files[:limit]
        pairs = []
        for i in range(0, len(files), self.batch):
            chunk = files[i : i + self.batch]
            imgs = []
            shapes = []
            for f in chunk:
                with open(os.path.join(self.images_dir, f), "rb") as fh:
                    im = decode_image(fh.read())
                if im.ndim == 3:
                    im = im[..., 0]
                imgs.append(im)
                shapes.append(im.shape)
            if len({s for s in shapes}) != 1:
                # fall back to per-image on ragged chunks
                for f, im in zip(chunk, imgs):
                    pairs.append(self._one(f, im))
                continue
            labels = self.segmenter.segment_labels(np.stack(imgs))
            for f, im, lab in zip(chunk, imgs, labels):
                gt = mask_from_yolo_labels(
                    os.path.join(
                        self.labels_dir, os.path.splitext(f)[0] + ".txt"
                    ),
                    im.shape[1],
                    im.shape[0],
                )
                pairs.append((gt, (lab + 1).astype(np.uint8)))
        return evaluate_dataset(pairs)

    def _one(self, fname: str, im: np.ndarray):
        lab = self.segmenter.segment_labels(im[None])[0]
        gt = mask_from_yolo_labels(
            os.path.join(self.labels_dir, os.path.splitext(fname)[0] + ".txt"),
            im.shape[1],
            im.shape[0],
        )
        return (gt, (lab + 1).astype(np.uint8))

    def report(self, limit: Optional[int] = None) -> str:
        return print_results(self.evaluate(limit))


def main(argv=None):  # pragma: no cover - thin CLI
    """CLI: python -m eitx_torch.eval.harness --images d/images
    --labels d/labels [--weights model.msgpack] [--imgsz 512]
    [--device cuda]"""
    import argparse

    p = argparse.ArgumentParser(
        description="eitx_torch pixel-level evaluation")
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--imgsz", type=int, default=512)
    p.add_argument("--limit", type=int, default=None)
    # the port's entry points take the device they run on
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    ev = PixelLevelEvaluator(
        model_path=args.weights, images_dir=args.images,
        labels_dir=args.labels, img_size=args.imgsz, device=args.device,
    )
    ev.report(limit=args.limit)


if __name__ == "__main__":  # pragma: no cover
    main()
