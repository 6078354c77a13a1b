"""One typed configuration tree for the whole pipeline.

The reference scatters its numerics over three uncoordinated mechanisms
(kt_service_config.py, ai_fsi_config.toml, frontend_config.py) plus hardcoded
call sites (ai_tools.py:121,153; femm_generator.py:369;
synthetic_datasets_generator.py:300,326). Every one of those constants becomes
a default here; per-mode presets are classmethods.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class ClassMap:
    """Canonical tissue class ids.

    Segmentation-side ids (reference utils.py:1224-1229): 0=bone, 1=muscles,
    2=lung, 3=adipose(fat), 4=body/skin contour.

    The reference's FEM side uses a *conflicting* map
    (model_generator.py:13: {'2': 'fat', '3': 'lung'}), so its live pipeline
    assigns lung conductivity to adipose elements and vice versa. We default
    to the consistent map; set ``compat_swap_lung_fat=True`` to reproduce the
    reference behaviour bit-for-bit.
    """

    bone: int = 0
    muscles: int = 1
    lung: int = 2
    fat: int = 3
    skin: int = 4
    compat_swap_lung_fat: bool = False

    def id_to_name(self) -> dict:
        names = {
            self.bone: "bone",
            self.muscles: "muscles",
            self.lung: "lung",
            self.fat: "fat",
            self.skin: "skin",
        }
        if self.compat_swap_lung_fat:
            names[self.lung], names[self.fat] = names[self.fat], names[self.lung]
        return names

    def name_to_id(self) -> dict:
        return {v: k for k, v in self.id_to_name().items()}

    @property
    def n_tissues(self) -> int:
        return 5


# BGR colors used by the reference mask canvases (utils.py:467-473).
CLASS_COLORS_BGR = {
    "bone": (255, 255, 255),
    "muscles": (0, 0, 255),
    "lung": (255, 255, 0),
    "fat": (0, 255, 255),  # "adipose" in the reference
    "skin": (0, 150, 255),
}


@dataclass(frozen=True)
class ImageConfig:
    """CT preprocessing numerics (reference utils.py:272-313, 526-585)."""

    window_level: float = 40.0  # soft-tissue window (classic_norm default)
    window_width: float = 400.0
    body_hu_min: float = -500.0  # body mask HU range
    body_hu_max: float = 1000.0
    body_open_kernel: int = 5  # 5x5 morphological open
    rotate_180_after_norm: bool = True  # classic_norm rotates 180 degrees


@dataclass(frozen=True)
class ModelConfig:
    """Detector / segmenter settings (reference ai_tools.py:107-158)."""

    ribs_weights: Optional[str] = None
    axial_weights_256: Optional[str] = None
    axial_weights_512: Optional[str] = None
    ribs_imgsz: int = 640
    ribs_conf: float = 0.3
    axial_conf: float = 0.3
    # Per-class confidence thresholds (bone, muscles, lung, fat) for the
    # tissue segmenter — None keeps the reference's single conf
    # (ai_tools.py:129-158 parity). A tuple is the serving-side recall
    # lever for sub-threshold classes (round-3 OOD failure analysis);
    # adjudicated on the OOD fixture before any default change.
    # Round-4 promoted serving defaults (weights/conf_sweep_r4.json
    # protocol: 3 noise seeds x 6 poses x pv1.5 blur on the
    # patient-derived fixture + phantom clean/anatomy giveback guards).
    # Scalar conf 0.3 with no TTA restores reference parity
    # (ai_tools.py:129-158: one forward pass, one 0.3 threshold);
    # the promoted defaults raise OOD crisp macro 0.799->0.866 (256)
    # and 0.827->0.901 (512) with the phantom evals unchanged-or-better.
    axial_conf_per_class: Optional[Tuple[float, ...]] = (
        0.15, 0.05, 0.1, 0.15)
    # flip-TTA with background-fill-only merge on the tissue segmenter:
    # False/True = 1/2 views (straight / +hflip), 3 adds vflip, 4 adds
    # rot180 (n_views x device cost on the per-request quality path
    # only — bulk throughput benches construct single-pass segmenters).
    # hflip catches orientation-shaped whole-group proposal misses
    # (posed lung 0.48->0.82 at 256), vflip buys the crisp-pose gains,
    # rot180 recovers the one eval pose single flips cannot (512 posed
    # lung min 0.51->0.84).
    axial_tta_fill: Union[bool, int] = 4
    n_classes: int = 4
    max_detections: int = 64  # static NMS budget
    dtype: str = "bfloat16"
    # YOLOv11 size variant ('n'/'s'/...). The reference ships 's'
    # checkpoints; the in-repo phantom-trained checkpoints are 'n'.
    variant: str = "s"


@dataclass(frozen=True)
class MeshConfig:
    """Triangulation settings (reference femm_generator.py:369-371)."""

    lc: float = 7.0  # target element edge length (px)
    distance_threshold: float = 1.3  # collinear-merge threshold
    skin_width: float = 1.0  # >0 offset ring; 0 none; -1 boundary elems
    show_inner_contours: bool = False
    classify_samples: int = 8  # sample points per triangle for class voting
    # Classify-kernel shape-bucket FLOORS for the serving pipeline: one
    # (contours, points) shape serves essentially every real subject, so
    # a long-lived process compiles the kernel once instead of paying a
    # ~2-18 s remote-(cache-)compile per fresh shape — measured as THE
    # dominant cost of the image->dat tail (round 4). Library default
    # floors (4/64, classify.py) stay small for tests/tiny meshes.
    classify_bucket_contours: int = 32
    classify_bucket_points: int = 512


@dataclass(frozen=True)
class SimulationConfig:
    """EIT forward simulation (reference synthetic_datasets_generator.py:300)."""

    n_electrodes: int = 16
    n_spir: int = 12  # inspirations per minute
    n_points: int = 100  # time points per inspiration
    n_minutes: int = 1
    frequency_hz: float = 50_000.0
    dist_exc: int = 1  # adjacent drive
    step_meas: int = 1  # adjacent measure
    parser_meas: str = "std"
    injected_current: float = 1.0
    precision: str = "f32"  # or "f64" (CPU validation)
    starting_angle_deg: float = 180.0  # first electrode angle
    # Static-shape buckets: node/element counts round up to these multiples
    # so one compiled solver serves every subject mesh in a bucket. Coarse
    # on purpose: at lc=7 a thorax meshes to ~2-3k nodes, so one 1024-wide
    # bucket covers the whole population with a single XLA compile
    # (measured: reused-bucket subjects solve in ~0.6s vs ~3min compile
    # for each fresh shape on remote-compile TPU setups).
    pad_nodes_to: int = 1024
    pad_elems_to: int = 8192
    # Solver: 'spectral' factors the lung-conductivity pencil once on the
    # LUNG SUBSPACE (low-rank Woodbury; setup = Cholesky + two rank-bucket
    # eighs) and solves every breathing frame in O(E*n_exc*r);
    # 'spectral_full' diagonalizes the full N-pencil (one O(N^3) eigh);
    # 'cholesky' batch-factorizes per frame; 'cg' is the matrix-free
    # fallback for very large meshes.
    solver: str = "spectral"
    # Lung-subspace size bucket for the low-rank spectral setup (static
    # shapes: lung-node counts round up to this multiple).
    spectral_rank_bucket: int = 256
    # Electrode model: 'point' (pyeit parity) or 'cem' (complete electrode
    # model with contact impedance and finite electrode coverage).
    electrode_model: str = "point"
    z_contact: float = 1e-2
    electrode_coverage: float = 0.5
    # Breathing source: 'synthetic' (make_spirometry sine, the live
    # pipeline default) or 'recorded' (a ventilation capture CSV driven
    # through the FFT low-pass + volume->conductivity map, reference
    # get_spirometry_ref/filt_FFT). ventilation_csv=None uses the packaged
    # eitx/data/vent.csv trace.
    spirometry_source: str = "synthetic"
    ventilation_csv: Optional[str] = None


@dataclass(frozen=True)
class EITConfig:
    """Bundle of mesh + simulation + class map used by fem/physio layers."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    sim: SimulationConfig = field(default_factory=SimulationConfig)
    classes: ClassMap = field(default_factory=ClassMap)


@dataclass(frozen=True)
class PipelineConfig:
    """Full end-to-end pipeline configuration with per-mode presets."""

    image: ImageConfig = field(default_factory=ImageConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    sim: SimulationConfig = field(default_factory=SimulationConfig)
    classes: ClassMap = field(default_factory=ClassMap)
    # Defaults used when the input carries no spacing metadata:
    default_pixel_spacing_image: Tuple[float, float] = (0.753906, 0.753906)
    default_pixel_spacing_nii: Tuple[float, float] = (0.662, 0.662)
    results_dir: str = "generation_results"
    save_dataset: bool = True

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def jpg_png(cls) -> "PipelineConfig":
        return cls()

    @classmethod
    def dicom_frame(cls) -> "PipelineConfig":
        return cls()

    @classmethod
    def dicom_sequences_auto(cls) -> "PipelineConfig":
        return cls()

    @classmethod
    def dicom_sequences_custom(cls) -> "PipelineConfig":
        return cls()

    @classmethod
    def nii(cls) -> "PipelineConfig":
        return cls()

    @property
    def eit(self) -> EITConfig:
        return EITConfig(mesh=self.mesh, sim=self.sim, classes=self.classes)
