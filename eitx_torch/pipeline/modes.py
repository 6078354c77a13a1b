"""The five pipeline modes as one orchestrator.

Port of eitx/pipeline/modes.py. Mode template parity (reference
ai_tools.py classes DICOMSequencesToMask / ...Custom / DICOMToMask /
ImageToMask / NIIToMask, which all run the same tail): ingest ->
[frontal + ribs + slice select] -> HU window -> body mask -> segment ->
cleanup -> contours -> mesh -> batched EIT solve -> answer. The rib
detector, the HU window, the body mask, segmentation, mask cleanup,
triangle classification and the EIT forward solve run on ``device``;
container formats, the frontal reslice, contour tracing and triangulation
run on the host. An answer dict and a ``.dat`` voltage file come out.

Every mode takes an optional ``Timer`` and fills it with the request's
spans: ``ingest`` (zip, DICOM / NIfTI / image decoding), ``frontal`` and
``ribs`` (series modes), ``preprocess`` (HU window and body mask), then
the tail's ``segmentation``, ``cleanup``, ``contours``, ``mesh``,
``simulation`` and ``answer``.
"""

from __future__ import annotations

import logging
import os
import threading
from datetime import datetime
from typing import List, Optional, Tuple

import numpy as np

from ..contours.formats import build_coordinate_list, format_polygon_line
from ..contours.simplify import approx_poly_dp
from ..contours.trace import arc_length, find_external_contours
from ..core.config import PipelineConfig
from ..core.device import resolve_device, to_device
from ..core.errors import ContourError
from ..core.timing import Timer
from ..fem.forward import simulate_eit_monitoring
from ..geometry.polygon import polygon_area
from ..image import body_mask_from_hu, hu_transform, window_normalize
from ..image.normalize import minmax_normalize_u8
from ..image.orientation import (
    axial_stack_to_frontal,
    middle_frontal_slice,
    stack_axial_slices,
)
from ..io.zips import (
    extract_first_image,
    extract_nifti_middle_slice,
    largest_series_from_zip,
)
from ..masks import class_canvases, cleanup_labels, labels_to_bgr
from ..masks.colorize import overlay_with_transparency
from ..mesh import create_mesh
from ..models.yolo.infer import RibsDetector, TissueSegmenter
from ..select import select_axial_slice_number
from .answer import build_answer
from .viz import annotate_ribs, stage_grid

logger = logging.getLogger("eitx_torch.pipeline")

# polygon emission order follows the reference's color_class_map
# (utils.py:1224-1229): fat, bone, muscles, lung
_CONTOUR_CLASS_ORDER = (3, 0, 1, 2)


def labels_to_polygons(labels: np.ndarray) -> List[str]:
    """Label image -> class polygon lines (create_list_crd_from_color_output
    parity, utils.py:1191-1279)."""
    lines = []
    for cid in _CONTOUR_CLASS_ORDER:
        mask = (labels == cid).astype(np.uint8)
        if not mask.any():
            continue
        for cnt in find_external_contours(mask):
            if cnt.shape[0] < 3:
                continue
            eps = 0.001 * arc_length(cnt)
            approx = approx_poly_dp(cnt.astype(float), eps)
            if approx.shape[0] > 2 and not np.array_equal(
                approx[0], approx[-1]
            ):
                approx = np.vstack([approx, approx[:1]])
            lines.append(format_polygon_line(cid, approx))
    return lines


def body_polygon(body_mask: Optional[np.ndarray]) -> Optional[str]:
    """Body mask -> class-4 outline polygon line (get_only_body_mask_contours
    parity, utils.py:1157-1188)."""
    if body_mask is None or not np.any(body_mask):
        return None
    contours = find_external_contours(np.asarray(body_mask) > 0)
    contours = [c for c in contours if c.shape[0] >= 5]
    if not contours:
        raise ContourError("body mask produced no usable contour")
    # max-AREA contour, matching the reference's max(contourArea)
    largest = max(contours, key=lambda c: abs(polygon_area(c)))
    return format_polygon_line(4, largest)


class Pipeline:
    """Loads the models once; exposes one method per mode.

    The rib detector is built eagerly, with random weights where
    ``ModelConfig.ribs_weights`` is None (the series modes then raise
    ``SliceSelectionError``, as in the reference)."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 device="cuda", **model_kw):
        self.config = config
        self.device = resolve_device(device)
        self._model_kw = dict(model_kw, device=self.device)
        m = config.model
        self.ribs = RibsDetector(
            weights=m.ribs_weights, conf=m.ribs_conf, variant=m.variant,
            max_det=m.max_detections, dtype=m.dtype, **self._model_kw,
        )
        self.seg_512 = self._tissue_segmenter(512)
        self._seg_256: Optional[TissueSegmenter] = None
        # concurrent requests (the HTTP service) build the 256 model once
        self._seg_256_lock = threading.Lock()

    def _tissue_segmenter(self, imgsz: int) -> TissueSegmenter:
        m = self.config.model
        return TissueSegmenter(
            imgsz,
            weights=m.axial_weights_512 if imgsz == 512 else m.axial_weights_256,
            conf=m.axial_conf_per_class or m.axial_conf,
            variant=m.variant,
            max_det=m.max_detections,
            dtype=m.dtype,
            tta_fill=m.axial_tta_fill,
            **self._model_kw,
        )

    # --- segmentation model selection (get_axial_slice_size parity) -----
    def _segmenter_for(self, image: np.ndarray) -> TissueSegmenter:
        if image.shape[0] == 256:
            with self._seg_256_lock:
                if self._seg_256 is None:
                    self._seg_256 = self._tissue_segmenter(256)
            return self._seg_256
        return self.seg_512

    def _run_tail(
        self,
        axial_norm_body: np.ndarray,
        body_mask: Optional[np.ndarray],
        pixel_spacing,
        ribs_annotated: Optional[np.ndarray],
        timer: Timer,
    ) -> dict:
        cfg = self.config
        dev = self.device
        seg = self._segmenter_for(axial_norm_body)
        with timer.span("segmentation"):
            labels, seg_time = seg.predict_labels(axial_norm_body)
        with timer.span("cleanup"):
            body_arg = None if body_mask is None else np.asarray(body_mask)
            labels = cleanup_labels(labels, body_arg, device=dev).cpu().numpy()
        with timer.span("answer"):
            color_output = labels_to_bgr(labels)
            canvases = class_canvases(labels)
        with timer.span("contours"):
            poly_lines = labels_to_polygons(labels)
            body_line = body_polygon(body_mask)
            crd = build_coordinate_list(
                poly_lines,
                (float(pixel_spacing[0]), float(pixel_spacing[1])),
                body_line,
            )
        with timer.span("mesh"):
            img_mesh, mesh_data = create_mesh(
                crd[:2],
                crd[2:],
                lc=cfg.mesh.lc,
                distance_threshold=cfg.mesh.distance_threshold,
                skin_width=cfg.mesh.skin_width,
                is_show_inner_contours=cfg.mesh.show_inner_contours,
                classify_samples=cfg.mesh.classify_samples,
                classify_bucket_contours=cfg.mesh.classify_bucket_contours,
                classify_bucket_points=cfg.mesh.classify_bucket_points,
                device=dev,
            )
            if img_mesh is not None:
                img_mesh = img_mesh[::-1]  # cv2.flip(img, 0) parity
        with timer.span("simulation"):
            saved_file_name = None
            if cfg.save_dataset:
                os.makedirs(cfg.results_dir, exist_ok=True)
                # microseconds in the name: requests within one second
                # must not overwrite each other's files
                ts = datetime.now().strftime("%Y%m%d_%H%M%S_%f")
                saved_file_name = os.path.join(
                    cfg.results_dir, f"results_{ts}.dat"
                )
            v, sim_time = simulate_eit_monitoring(
                mesh_data,
                cfg.sim,
                classes=cfg.classes,
                save_to_file=cfg.save_dataset,
                filename=saved_file_name,
                device=dev,
            )
        # the stage-grid image and the answer dict are host work; they get
        # a span of their own so a request's time adds up
        with timer.span("answer"):
            combined = overlay_with_transparency(axial_norm_body, color_output)
            grid = stage_grid(
                class_canvases=canvases,
                color_output=color_output,
                ribs_annotated=ribs_annotated,
                axial_slice=axial_norm_body,
                combined_view=combined,
                mesh_image=img_mesh,
            )
            return build_answer(
                grid,
                # the reference returns the spacing-prefixed contour list
                # as the answer's text block (ai_tools.py:228)
                text_data=crd,
                segmentation_time=seg_time,
                saved_file_name=saved_file_name,
                simulation_time=sim_time,
            )

    def _axial_from_dicom_slice(self, ds) -> Tuple[np.ndarray, np.ndarray, list]:
        """One DICOM slice -> (windowed body image, body mask, spacing)."""
        cfg = self.config.image
        hu = hu_transform(ds.pixel_array, ds.rescale_slope,
                          ds.rescale_intercept, device=self.device)
        norm = window_normalize(hu, cfg.window_level, cfg.window_width)
        # reference quirk preserved: the mask is built on the flipud'd
        # image while the normalized slice is rotated 180 degrees
        # (utils.py:551 vs utils.py:309)
        mask = body_mask_from_hu(
            hu, cfg.body_hu_min, cfg.body_hu_max, cfg.body_open_kernel,
            flipud=True,
        )
        body_img = (norm * (mask > 0)).cpu().numpy()
        spacing = ds.pixel_spacing or list(
            self.config.default_pixel_spacing_image
        )
        return body_img, mask.cpu().numpy(), spacing

    # --- the five modes ---------------------------------------------------
    def run_jpg_png(self, image: np.ndarray,
                    timer: Optional[Timer] = None) -> dict:
        """Mode jpg_png: pre-normalized axial image, no body machinery
        (ImageToMask, ai_tools.py:359-400). Pass a ``Timer`` to receive
        the per-stage spans."""
        return self._run_tail(
            np.asarray(image),
            body_mask=None,
            pixel_spacing=self.config.default_pixel_spacing_image,
            ribs_annotated=None,
            timer=timer if timer is not None else Timer(),
        )

    def run_jpg_png_zip(self, zip_data,
                        timer: Optional[Timer] = None) -> dict:
        timer = timer if timer is not None else Timer()
        with timer.span("ingest"):
            image = extract_first_image(zip_data)
        return self.run_jpg_png(image, timer=timer)

    def run_dicom_frame(self, zip_data,
                        timer: Optional[Timer] = None) -> dict:
        """Mode dicom_frame: single DICOM slice (DICOMToMask)."""
        timer = timer if timer is not None else Timer()
        with timer.span("ingest"):
            slices, _ = largest_series_from_zip(zip_data)
        ds = slices[-1]
        with timer.span("preprocess"):
            body_img, mask, spacing = self._axial_from_dicom_slice(ds)
        return self._run_tail(body_img, mask, spacing, None, timer)

    def run_nii(self, zip_data, timer: Optional[Timer] = None) -> dict:
        """Mode nii: middle slice of a NIfTI volume (NIIToMask)."""
        timer = timer if timer is not None else Timer()
        cfg = self.config.image
        with timer.span("ingest"):
            sl, spacing = extract_nifti_middle_slice(zip_data)
        with timer.span("preprocess"):
            sl = to_device(sl, self.device)
            norm = window_normalize(sl, cfg.window_level, cfg.window_width)
            norm = norm.flip(0, 1)  # extra ROTATE_180 (ai_tools.py:431)
            mask = body_mask_from_hu(
                sl, cfg.body_hu_min, cfg.body_hu_max, cfg.body_open_kernel
            )
            body_img = (norm * (mask > 0)).cpu().numpy()
            mask = mask.cpu().numpy()
        return self._run_tail(body_img, mask, spacing, None, timer)

    def _dicom_series_common(self, zip_data, use_custom: bool,
                             timer: Optional[Timer]) -> dict:
        timer = timer if timer is not None else Timer()
        with timer.span("ingest"):
            slices, custom = largest_series_from_zip(zip_data)
        custom = custom if use_custom else 0
        slices.sort(key=lambda s: s.instance_number)
        with timer.span("frontal"):
            vol = stack_axial_slices([s.pixel_array for s in slices])
            frontal = axial_stack_to_frontal(
                vol,
                slices[0].patient_position or "HFS",
                slices[0].image_orientation,
                slices[0].patient_orientation,
            )
            front = minmax_normalize_u8(
                middle_frontal_slice(frontal), device=self.device
            ).cpu().numpy()
        with timer.span("ribs"):
            det = self.ribs.predict(front)
            boxes = det.boxes[det.valid]
            numbers = select_axial_slice_number(
                boxes, custom, image_width=front.shape[1]
            )
        idx = min(max(numbers[-1], 0), len(slices) - 1)
        ds = slices[idx]
        with timer.span("preprocess"):
            body_img, mask, spacing = self._axial_from_dicom_slice(ds)
        with timer.span("answer"):
            ribs_img = annotate_ribs(front, det.boxes, det.valid, numbers)
        return self._run_tail(body_img, mask, spacing, ribs_img, timer)

    def run_dicom_sequences_auto(self, zip_data,
                                 timer: Optional[Timer] = None) -> dict:
        """Mode dicom_sequences_auto (DICOMSequencesToMask)."""
        return self._dicom_series_common(zip_data, False, timer)

    def run_dicom_sequences_custom(self, zip_data,
                                   timer: Optional[Timer] = None) -> dict:
        """Mode dicom_sequences_custom: honors custom_input.txt offset."""
        return self._dicom_series_common(zip_data, True, timer)
