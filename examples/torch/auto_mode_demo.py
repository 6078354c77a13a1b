"""Full automatic-mode drive of the port with the in-repo trained
checkpoints.

The port's counterpart of examples/auto_mode_demo.py. Builds a synthetic
DICOM series whose reconstructed frontal view is a rib phantom (the
frontal reslice is the stack of each slice's middle row, so writing the
phantom row by row reproduces it after min-max normalization), zips it,
and runs the whole automatic mode on ``device`` (the card unless the
caller passes ``device="cpu"``):

    DICOM zip -> largest series -> frontal reslice -> trained rib
    detector -> between-ribs-6-and-7 slice selection -> HU window ->
    body mask -> trained tissue segmenter -> contours -> mesh -> EIT
    monitoring dataset -> answer JSON

All three model slots run the in-repo trained weights
(weights/ribs_n_640.msgpack, tissue_n_256.msgpack, tissue_n_512.msgpack),
found by ``find_checkpoint``.

Run:  python examples/torch/auto_mode_demo.py [cuda|cpu]
"""

import io
import json
import os
import sys
import time
import zipfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from eitx_torch.core.config import (  # noqa: E402
    ModelConfig,
    PipelineConfig,
    SimulationConfig,
)
from eitx_torch.core.weights import find_checkpoint  # noqa: E402
from eitx_torch.io.dicom import write_dicom  # noqa: E402
from eitx_torch.pipeline import Pipeline  # noqa: E402
from eitx_torch.train.phantoms import (  # noqa: E402
    frontal_rib_phantom,
    thorax_phantom_hu,
)


def build_series_zip(n_slices=192, size=256, seed=11):
    """Synthetic thoracic CT series. Every slice is the same thorax
    phantom; each slice's middle row carries one row of the frontal rib
    phantom, so the pipeline's frontal reslice reconstructs it exactly."""
    rng = np.random.default_rng(seed)
    frontal, _ = frontal_rib_phantom(rng, size)
    frontal = frontal[:n_slices]
    hu, _ = thorax_phantom_hu(rng, size)
    stored = (hu + 1024.0).astype(np.int16)

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for z in range(n_slices):
            sl = stored.copy()
            # affine-encode the frontal row; min-max normalization of the
            # frontal view recovers the phantom exactly
            sl[size // 2, :] = (frontal[z].astype(np.int32) * 3 + 600).astype(
                np.int16
            )
            zf.writestr(
                f"slice_{z:04d}.dcm",
                write_dicom(sl, instance_number=z + 1),
            )
    return buf.getvalue()


def main(device="cuda"):
    # best trained checkpoint per serving slot (s preferred over n; the
    # checkpoint's own meta fixes the graph variant at load time)
    cfg = PipelineConfig(
        model=ModelConfig(
            ribs_weights=find_checkpoint("ribs", 640),
            axial_weights_256=find_checkpoint("tissue", 256),
            axial_weights_512=find_checkpoint("tissue", 512),
        ),
        sim=SimulationConfig(n_points=25),
    )
    data = build_series_zip()
    print(f"series zip: {len(data) / 1e6:.1f} MB")
    pipe = Pipeline(cfg, device=device)
    t0 = time.time()
    ans = pipe.run_dicom_sequences_auto(data)
    wall1 = time.time() - t0
    t0 = time.time()
    ans = pipe.run_dicom_sequences_auto(build_series_zip(seed=12))
    wall2 = time.time() - t0
    summary = {
        "status": ans["status"],
        "segmentation_time_s": ans["segmentation_time"],
        "simulation_time_s": ans["simulation_time"],
        "first_request_wall_s": round(wall1, 1),
        "second_request_wall_s": round(wall2, 1),
        "tissue_classes_in_answer": sorted(
            {line.split()[0] for line in ans["text_data"][2:]}
        ),
        "dataset_file": ans["saved_file_name"],
    }
    print(json.dumps(summary, indent=1))
    assert ans["status"] == "success"
    assert len(summary["tissue_classes_in_answer"]) >= 3
    print("AUTO_MODE_DEMO_OK")
    return summary


if __name__ == "__main__":
    main(*sys.argv[1:2])
