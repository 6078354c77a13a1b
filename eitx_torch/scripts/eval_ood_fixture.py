"""Out-of-distribution eval: segment a CT-like rendering of the
reference's patient-derived slice.

Port of eitx/scripts/eval_ood_fixture.py: the rendering and the fixture
transforms are eitx's numpy code (equal arrays); the HU window, the
pseudo-labels and the segmenter run on ``device`` (``--device``, the card
unless the caller asks for the CPU). Two paths of eitx that ignore a
flag are closed here (a deliberate difference):
  - ``evaluate_ood(..., seg=...)`` raises ``ValueError`` when ``conf``,
    ``tta_fill``, ``variant`` or ``weights`` is also given otherwise than
    at its default: the prebuilt segmenter decides them, and eitx drops
    the explicit arguments without a word;
  - ``--labeler-perturb`` scores the segmenter that the other flags
    describe (``--conf-per-class``, ``--tta-fill``, ``--tta-views``),
    where eitx's probe scored conf 0.3 without TTA whatever they said.

The tissue checkpoints train and evaluate on synthetic thorax phantoms
(eitx_torch/train/phantoms.py) — an in-distribution eval that, as round
2's verdict noted, "can't fail" in the ways real anatomy does. This script renders
the only patient-derived geometry available in this environment — the
segmented-slice polygon set the reference embeds as its de-facto E2E
fixture (femm_generator.py:748-829) — into an HU image with typical
tissue values + noise, pseudo-labels it with the same HU-threshold rule
the training targets use, and scores the serving checkpoints on it.

Distribution shift covered: real anatomy layout (asymmetric lungs,
articulated rib/spine geometry, true body outline) instead of the
phantom generator's parametric ellipses. NOT covered: real CT texture
(the rendering is piecewise-constant HU + Gaussian noise).

Usage: python -m eitx_torch.scripts.eval_ood_fixture [--report out.json]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "data")
_HU = {"air": -1000.0, "lung": -780.0, "fat": -90.0, "muscle": 35.0,
       "bone": 350.0}
_CLASS_HU = {0: _HU["bone"], 1: _HU["muscle"], 2: _HU["lung"],
             3: _HU["fat"]}
# paint order: body contour (class 4, where present) first, then fat,
# muscles, lung, bone on top — the reference polygons nest this way
# (outermost adipose ring to bone); trial6's class-4 skin contour sits
# entirely under its fat ring
_Z_ORDER = (4, 3, 1, 2, 0)
_CLASS_NAMES = ("bone", "muscles", "lung", "fat")
# the reference embeds SIX patient-derived slice polygon sets
# (mesh_service_trials.py:10-322): geometry 1 is the long-standing
# fixture (femm_generator.py:748-829); 2-6 are harvested by
# eitx_torch.scripts.harvest_trials (2-5 are four processing variants of ONE
# anatomy; 6 is a distinct anatomy — 3 distinct anatomies total)
GEOMETRIES = (1, 2, 3, 4, 5, 6)


def geometry_path(geometry: int) -> str:
    if geometry == 1:
        return os.path.join(_DATA, "real_slice_polygons.txt")
    return os.path.join(_DATA, "geometries", f"trial{geometry}.txt")


def load_fixture_polygons(path: str = None, geometry: int = 1):
    path = path or geometry_path(geometry)
    polys = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            cid = int(parts[0])
            xy = np.asarray(parts[1:], float).reshape(-1, 2)
            polys.append((cid, xy))
    return polys


def fixture_transform(seed: int):
    """Random pose/zoom transform for the fixture polygons.

    The fixture is a single patient geometry; scoring it only at its
    native pose lets a model (or a training-distribution tweak) fit the
    one layout. The family is bounded to poses thoracic CT plausibly
    serves — tilt up to ~26 degrees, left/right mirror, zoom-out to
    0.65 (also what keeps the frame-filling body in-frame), small
    shifts — NOT arbitrary 360-degree spins, which no supine axial
    series produces."""
    rng = np.random.default_rng(1000 + seed)
    return {
        "angle": float(rng.uniform(-0.45, 0.45)),
        "flip": bool(rng.random() < 0.5),
        "scale": float(rng.uniform(0.65, 0.95)),
        "shift": rng.uniform(-0.06, 0.06, 2),
    }


def _apply_transform(xy: np.ndarray, t: dict, size: int) -> np.ndarray:
    c = size / 2.0
    p = xy - c
    if t["flip"]:
        p = p * np.array([-1.0, 1.0])
    ca, sa = np.cos(t["angle"]), np.sin(t["angle"])
    p = p @ np.array([[ca, sa], [-sa, ca]])
    return c + t["scale"] * p + np.asarray(t["shift"]) * size


def render_fixture_hu(size: int = 512, noise_sigma: float = 12.0,
                      seed: int = 5, pv_sigma: float = 0.0,
                      transform: dict = None, geometry: int = 1):
    """(hu (s, s) f32, body mask (s, s) u8) rendering of the fixture.

    ``pv_sigma`` > 0 applies a scanner-PSF partial-volume blur to the
    painted tissue map BEFORE the noise draw (same rng stream either
    way, so the noise field is identical to the unblurred render of the
    same seed — only the boundaries get harder). ``transform`` (from
    fixture_transform) re-poses the polygons before rasterization."""
    from ..geometry import rasterize_polygons

    polys = load_fixture_polygons(geometry=geometry)
    scale = size / 512.0
    if transform is not None:
        polys = [(cid, _apply_transform(xy, transform, 512.0))
                 for cid, xy in polys]
    ordered = [
        (cid, xy * scale) for z in _Z_ORDER for cid, xy in polys if cid == z
    ]
    lab = rasterize_polygons(ordered, (size, size), background=-1)
    hu = np.full((size, size), _HU["air"], np.float32)
    # class 4 (body/skin contour, trial6): painted as fat — the
    # outermost soft-tissue underlay, same role trial1's adipose ring
    # plays (in practice it sits fully under the fat ring)
    for cid, val in {**_CLASS_HU, 4: _HU["fat"]}.items():
        hu[lab == cid] = val
    if pv_sigma:
        from ..train.phantoms import _partial_volume

        hu = _partial_volume(hu, pv_sigma)
    rng = np.random.default_rng(seed)
    hu += rng.normal(0.0, noise_sigma, hu.shape).astype(np.float32)
    body = (lab >= 0).astype(np.uint8) * 255
    return hu, body


def evaluate_ood(size: int, weights: str = None, variant: str = "n",
                 seed: int = 5, pv_sigma: float = 0.0,
                 transform: dict = None, hu_scale: float = 1.0,
                 conf=0.3, seg=None, tta_fill: bool = False,
                 geometry: int = 1, gt_perturb: str = None,
                 device="cuda") -> dict:
    """Score one checkpoint on one fixture rendering. ``seg`` (a prebuilt
    TissueSegmenter) skips the per-call model construction — sweeps over
    seeds/poses reuse one network; it then decides the checkpoint, the
    variant, the confidence and the TTA, and giving any of ``weights``,
    ``variant``, ``conf`` or ``tta_fill`` otherwise than at its default
    beside it raises ``ValueError``."""
    from ..eval.metrics import evaluate_dataset
    from ..image import window_normalize
    from ..models.yolo.infer import TissueSegmenter
    from .pseudo_label import pseudo_label_slice

    if seg is not None:
        given = [name for name, value, default in (
            ("weights", weights, None), ("variant", variant, "n"),
            ("conf", conf, 0.3), ("tta_fill", tta_fill, False))
            if value != default]
        if given:
            raise ValueError(
                f"evaluate_ood: seg decides {', '.join(given)}; build the "
                "segmenter with them, or pass them without seg")
        device = seg.device

    hu, body = render_fixture_hu(size, seed=seed, transform=transform,
                                 geometry=geometry)
    # serving frame: the model consumes window_normalize output, which
    # includes the reference's rot180 (classic_norm) — so the GT labels,
    # computed in the raw hu frame, rotate to match
    if gt_perturb == "psf":
        # systematic labeler-boundary error of the partial-volume kind:
        # GT derived from a PSF-blurred render while the MODEL INPUT
        # stays crisp — boundary pixels move the way a pseudo-labeler
        # running on reconstruction-blurred CT would move them
        from ..train.phantoms import _partial_volume

        gt = pseudo_label_slice(
            _partial_volume(hu, 1.0), body, hu_scale=hu_scale, device=device
        )[::-1, ::-1]
    else:
        gt = pseudo_label_slice(hu, body, hu_scale=hu_scale,
                                device=device)[::-1, ::-1]
    if gt_perturb in ("dilate", "erode"):
        # +-1 px class-boundary shift: grey dilation (max filter on
        # id+1) moves every boundary one pixel toward the LOWER class id
        # (fat>lung>muscles>bone>background win order); grey erosion
        # (min filter) moves them one pixel the other way — the pair
        # brackets systematic over/under-segmentation by the
        # pseudo-labeler's morphology chain
        from scipy import ndimage

        op = (ndimage.grey_dilation if gt_perturb == "dilate"
              else ndimage.grey_erosion)
        gt = op(gt + 1, size=(3, 3)).astype(gt.dtype) - 1
    if pv_sigma:
        # harder image, SAME ground truth: the GT above is derived from
        # the crisp render (identical noise field — see render_fixture_hu)
        hu, _ = render_fixture_hu(size, seed=seed, pv_sigma=pv_sigma,
                                  transform=transform, geometry=geometry)
    img_u8 = window_normalize(hu, 40.0, 400.0, device=device).cpu().numpy()
    # max_det matches the serving pipeline's static NMS budget
    # (ModelConfig.max_detections = 64): real anatomy fragments bone into
    # 20+ instances (ribs, spine, scapulae), and a 16-slot budget crowds
    # the muscle/fat detections out entirely
    if seg is None:
        seg = TissueSegmenter(imgsz=size, weights=weights, variant=variant,
                              max_det=64, conf=conf, tta_fill=tta_fill,
                              device=device)
    pred = seg.segment_labels(img_u8[None], chunk=1, compose_full=True)[0]
    res = evaluate_dataset([(gt + 1, pred + 1)], n_classes=4)
    per = {n: round(res[c]["iou"], 4) for c, n in enumerate(_CLASS_NAMES)}
    return {
        "macro_iou": round(
            float(np.mean([res[c]["iou"] for c in range(4)])), 4
        ),
        "per_class_iou": per,
    }


def main(argv=None):
    from ..core.weights import find_checkpoint

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--report", default=None)
    p.add_argument("--seeds", type=int, default=3,
                   help="noise seeds averaged per size")
    p.add_argument("--ckpt-256", default=None,
                   help="explicit 256 checkpoint (default: serving slot)")
    p.add_argument("--ckpt-512", default=None,
                   help="explicit 512 checkpoint (default: serving slot)")
    p.add_argument("--sizes", default="256,512")
    p.add_argument("--pv-sigma", type=float, default=0.0,
                   help="partial-volume blur (px) of the model input; GT "
                        "stays derived from the crisp render — a harder "
                        "variant of the standing eval, not a replacement")
    p.add_argument("--transforms", type=int, default=0,
                   help="additionally score N randomly re-posed fixture "
                        "variants (rotation/flip/scale 0.65-0.9/shift, "
                        "fixture_transform) per size — guards against "
                        "fitting the single native pose; reported as a "
                        "separate 'posed' section with mean and min")
    p.add_argument("--holdout", action="store_true",
                   help="FROZEN round-end protocol: noise seeds 1005+k "
                        "and pose draws fixture_transform(100+k), both "
                        "disjoint from every promotion decision to date "
                        "(which used seeds 5+k / poses 0..5). Consult "
                        "ONLY after the round's last promotion — never "
                        "to steer a training run (docs/STATUS.md).")
    p.add_argument("--conf-per-class", default=None,
                   help="comma list of per-class conf thresholds "
                        "(bone,muscles,lung,fat) replacing the scalar "
                        "0.3 — the serving-side recall lever "
                        "(ModelConfig.axial_conf_per_class)")
    p.add_argument("--tta-fill", action="store_true",
                   help="hflip TTA with background-fill merge "
                        "(ModelConfig.axial_tta_fill serving path)")
    p.add_argument("--tta-views", type=int, default=0,
                   help="explicit TTA view count (2 = +hflip, 3 = "
                        "+vflip); overrides --tta-fill")
    p.add_argument("--geometries", default="1",
                   help="comma list of fixture geometries to score, or "
                        "'all' (= 1..6). Geometry 1 is the original "
                        "fixture; 2-6 are the reference's other embedded "
                        "patient-derived trial sets (harvest_trials.py; "
                        "2-5 are variants of one anatomy, 6 distinct). "
                        "With one geometry the report shape is unchanged; "
                        "with several, each size gains a by_geometry "
                        "section plus cross-geometry mean/min.")
    p.add_argument("--device", default="cuda")
    p.add_argument("--labeler-perturb", action="store_true",
                   help="pseudo-labeler-independence probe: score each "
                        "checkpoint, with the --conf-per-class and TTA "
                        "flags, against GT derived with the HU "
                        "thresholds scaled x0.9 / x1.0 / x1.1; a serving"
                        "-vs-candidate ranking that flips under the "
                        "perturbation is a labeler artifact")
    args = p.parse_args(argv)
    tta = args.tta_views or args.tta_fill
    conf = 0.3
    if args.conf_per_class:
        conf = tuple(float(c) for c in args.conf_per_class.split(","))
    seed_base = 1005 if args.holdout else 5
    pose_base = 100 if args.holdout else 0
    if args.holdout:
        print("# HOLDOUT protocol: seeds %d+, poses fixture_transform(%d+)"
              % (seed_base, pose_base))
    override = {256: args.ckpt_256, 512: args.ckpt_512}
    out = {}
    if args.pv_sigma:
        out["pv_sigma"] = args.pv_sigma
    for size in (int(s) for s in args.sizes.split(",")):
        w = override[size] or find_checkpoint("tissue", size)
        if w is None:
            continue
        from ..models.yolo.infer import TissueSegmenter

        seg = TissueSegmenter(imgsz=size, weights=w, variant="n",
                              max_det=64, conf=conf, tta_fill=tta,
                              device=args.device)
        if args.labeler_perturb:
            # widened probe (round-5): beyond +-10% HU-threshold scaling,
            # perturb the pseudo-labeler's MORPHOLOGY — GT from a
            # PSF-blurred render (partial-volume boundary shift) and
            # +-1 px class-boundary dilation/erosion. A serving-vs-
            # candidate ranking that flips under any of these is a
            # labeler artifact, not a model difference.
            def probe(hu_scale=1.0, gt_perturb=None):
                return round(float(np.mean([
                    evaluate_ood(size, seed=seed_base + k,
                                 hu_scale=hu_scale, seg=seg,
                                 gt_perturb=gt_perturb)["macro_iou"]
                    for k in range(args.seeds)
                ])), 4)

            out[str(size)] = {
                "checkpoint": os.path.basename(w),
                "macro_iou_by_hu_scale": {
                    str(s): probe(hu_scale=s) for s in (0.9, 1.0, 1.1)
                },
                "macro_iou_by_gt_perturb": {
                    p: probe(gt_perturb=p)
                    for p in ("psf", "dilate", "erode")
                },
            }
            continue

        def score_geometry(size, geometry, seg=seg):
            runs = [evaluate_ood(size, seed=seed_base + k,
                                 pv_sigma=args.pv_sigma, seg=seg,
                                 geometry=geometry)
                    for k in range(args.seeds)]
            sec = {
                "macro_iou": round(
                    float(np.mean([r["macro_iou"] for r in runs])), 4
                ),
                "per_class_iou": {
                    n: round(
                        float(np.mean(
                            [r["per_class_iou"][n] for r in runs])), 4
                    )
                    for n in _CLASS_NAMES
                },
                "n_seeds": args.seeds,
            }
            if args.transforms:
                posed = [
                    evaluate_ood(size, seed=seed_base + k,
                                 pv_sigma=args.pv_sigma, seg=seg,
                                 geometry=geometry,
                                 transform=fixture_transform(pose_base + k))
                    for k in range(args.transforms)
                ]
                macros = [r["macro_iou"] for r in posed]
                sec["posed"] = {
                    "macro_iou_mean": round(float(np.mean(macros)), 4),
                    "macro_iou_min": round(float(np.min(macros)), 4),
                    "per_class_iou_mean": {
                        n: round(float(np.mean(
                            [r["per_class_iou"][n] for r in posed])), 4)
                        for n in _CLASS_NAMES
                    },
                    "n_transforms": args.transforms,
                }
            return sec

        geoms = (GEOMETRIES if args.geometries == "all"
                 else tuple(int(g) for g in args.geometries.split(",")))
        if len(geoms) == 1:
            out[str(size)] = score_geometry(size, geoms[0])
            out[str(size)]["checkpoint"] = os.path.basename(w)
            if geoms[0] != 1:
                out[str(size)]["geometry"] = geoms[0]
        else:
            by = {str(g): score_geometry(size, g) for g in geoms}
            macros = [by[str(g)]["macro_iou"] for g in geoms]
            out[str(size)] = {
                "by_geometry": by,
                "macro_iou_mean": round(float(np.mean(macros)), 4),
                "macro_iou_min": round(float(np.min(macros)), 4),
                "checkpoint": os.path.basename(w),
            }
    print(json.dumps(out))
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
