"""Regenerate tests/data/torch_series_512.npz, the reference answers of
chip_smoke.py's rib and series phases.

The input is never stored: ``tests/torch_series_phantom.series_volume(SEED,
512, 512)`` rebuilds the 512-slice thorax series (512 x 512 int16) from its
seed. The file holds what the JAX package answers for it on the CPU:

  - ``boxes_serving`` / ``valid_serving`` / ``pick_serving``: the rib
    detector (``weights/ribs_n_640.msgpack``) on the middle frontal plane
    at the serving settings of ``ModelConfig`` (max_det 64, conf 0.3,
    dtype bfloat16), and ``select_axial_slice_number`` of its boxes;
  - ``boxes_f32`` / ``valid_f32`` / ``pick_f32``: the same in float32;
  - ``slice_index``: the slice the series mode takes (the pick, clamped);
  - ``body_mask`` / ``body_image``: ``Pipeline._axial_from_dicom_slice``'s
    body mask and windowed body image of that slice, default ImageConfig.

The script refuses a seed on which eitx finds fewer than seven right-side
ribs. chip_smoke.py reads the file with numpy only. Run from the
repository root, on the CPU:

    JAX_PLATFORMS=cpu python tests/data/make_torch_series_fixture.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

SEED, SLICES, SIZE = 7, 512, 512


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from eitx.core.config import ImageConfig, ModelConfig
    from eitx.image import (
        body_mask_from_hu,
        hu_transform,
        minmax_normalize_u8,
        window_normalize,
    )
    from eitx.models.yolo.infer import RibsDetector
    from eitx.select import select_axial_slice_number
    from torch_series_phantom import series_volume

    vol = series_volume(SEED, SLICES, SIZE)
    front = np.asarray(minmax_normalize_u8(vol[:, SIZE // 2, :]))
    m = ModelConfig()
    out = {}
    for name, dtype in (("serving", m.dtype), ("f32", "float32")):
        det = RibsDetector(
            weights=os.path.join(ROOT, "weights", "ribs_n_640.msgpack"),
            conf=m.ribs_conf, max_det=m.max_detections, dtype=dtype,
        ).predict(front)
        boxes, valid = np.asarray(det.boxes), np.asarray(det.valid)
        right = boxes[valid & (boxes[:, 0] > SIZE / 2)]
        assert right.shape[0] >= 7, (
            f"seed {SEED}: {right.shape[0]} right-side ribs at {dtype}")
        pick = select_axial_slice_number(boxes[valid], 0, image_width=SIZE)
        out.update({f"boxes_{name}": boxes, f"valid_{name}": valid,
                    f"pick_{name}": np.asarray(pick)})
        print(name, int(valid.sum()), "boxes,", right.shape[0], "right, pick",
              pick)
    assert list(out["pick_serving"]) == list(out["pick_f32"])
    idx = min(max(int(out["pick_serving"][-1]), 0), SLICES - 1)
    cfg = ImageConfig()
    hu = np.asarray(hu_transform(vol[idx], 1.0, -1024.0))
    norm = np.asarray(window_normalize(hu, cfg.window_level, cfg.window_width))
    mask = np.asarray(body_mask_from_hu(
        hu, cfg.body_hu_min, cfg.body_hu_max, cfg.body_open_kernel,
        flipud=True))
    path = os.path.join(ROOT, "tests", "data", "torch_series_512.npz")
    np.savez_compressed(path, seed=SEED, slice_index=idx, body_mask=mask,
                        body_image=norm * (mask > 0), **out)
    print(path, os.path.getsize(path), "bytes; slice", idx, "body pixels",
          int((mask > 0).sum()))


if __name__ == "__main__":
    main()
