"""Regenerate tests/data/torch_smoke_512.npz, the input of chip_smoke.py.

The file holds:
  - ``image``: a 512x512 uint8 phantom axial slice,
    ``eitx.train.phantoms.phantom_batch(1, 512, 12, default_rng(42))``;
  - ``labels``: the JAX package's float32 labels for that slice,
    ``eitx.models.yolo.infer.TissueSegmenter(512, weights=tissue_n_512)
    .predict_labels`` at the serving settings of ``ModelConfig``
    (per-class conf, 4 flip views, max_det 64), as int8.

chip_smoke.py reads the file with numpy only, so the card's run needs no
JAX. Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python tests/data/make_torch_smoke_fixture.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from eitx.core.config import ModelConfig
    from eitx.models.yolo.infer import TissueSegmenter
    from eitx.train.phantoms import phantom_batch

    batch = phantom_batch(1, 512, 12, np.random.default_rng(42))
    image = (batch["images"][0, ..., 0] * 255).astype(np.uint8)
    m = ModelConfig()
    seg = TissueSegmenter(
        512,
        weights=os.path.join(ROOT, "weights", "tissue_n_512.msgpack"),
        conf=m.axial_conf_per_class,
        max_det=m.max_detections,
        tta_fill=m.axial_tta_fill,
        dtype="float32",
    )
    labels, _ = seg.predict_labels(image)
    out = os.path.join(ROOT, "tests", "data", "torch_smoke_512.npz")
    np.savez_compressed(out, image=image, labels=labels.astype(np.int8))
    print(out, image.shape, np.unique(labels, return_counts=True))


if __name__ == "__main__":
    main()
