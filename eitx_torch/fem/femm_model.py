"""Legacy FEMM-path model preparation (geometry side).

Copy of eitx/fem/femm_model.py (host numpy only); the .fec text it writes
is byte-equal to the JAX package's.

The reference's femm_tools/model_generator.py builds a FEMM current-flow
problem over Windows COM: contour filtering, centering, polynomial surface
smoothing, skin offsetting, flat-electrode placement along the perimeter
and insertion of the electrode edge points into the skin polygon
(model_generator.py:175-346). Those geometric stages are reproduced here
verbatim-in-behaviour; the COM solver itself is replaced by the in-repo
admittance solver (eitx_torch.fem.admittance), and the .fec "model save" becomes
a JSON-text model description (export_femm_model)."""

from __future__ import annotations

import collections
import json
from typing import Dict, Tuple

import numpy as np

from ..geometry.filters import (
    calc_dist,
    calc_lin_coef,
    cut_min_area_close_points,
    filter_degr_polyfit,
    filter_inline_points,
    interpolate_big_vert_breaks_poly,
    interpolate_surface_step,
    poly_area,
)

Settings = collections.namedtuple(
    "Settings",
    ["Nelec", "Relec", "accuracy", "min_area", "polydeg", "skinthick", "I",
     "Freq", "thin_coeff"],
)

CLASSES_LIST = {"0": "bone", "1": "muscles", "2": "lung", "3": "fat", "4": "skin"}


def load_yolo(filepath: str, classes_list: Dict[str, str]) -> Dict:
    """YOLO label file -> {tissue: [(N,2) arrays]} (model_generator.py:16-55
    contract, repeated-point removal included)."""
    borders: Dict[str, list] = {}
    with open(filepath) as fh:
        for line in fh:
            parts = line.strip().split(" ")
            if not parts or not parts[0]:
                continue
            key = parts[0]
            if key not in classes_list:
                raise ValueError(f"Unknown tissue type {key}")
            tissue = classes_list[key]
            coords = [float(v) for v in parts[1:]]
            pts = np.array(coords).reshape(-1, 2)
            # drop consecutive duplicates
            if pts.shape[0] > 1:
                keep = np.ones(pts.shape[0], bool)
                keep[1:] = np.any(pts[1:] != pts[:-1], axis=1)
                pts = pts[keep]
            if pts.shape[0] >= 3:
                borders.setdefault(tissue, []).append(pts)
    return borders


def add_skin_radial(data: np.ndarray, width: float) -> np.ndarray:
    """Centroid-ray offset (model_generator.py:241-254): every point moves
    away from the vertex centroid by ``width`` along its radius."""
    cent = np.mean(data, axis=0)
    d = data - cent
    dist = np.linalg.norm(d, axis=1, keepdims=True)
    dist = np.where(dist < 1e-12, 1.0, dist)
    return data + d / dist * width


def get_electrodes_coords(
    data: np.ndarray, n_elec: int, r_elec: float
) -> np.ndarray:
    """Flat electrodes equally spaced along the polygon perimeter.

    Returns (n_elec, 3, 2): rows [right edge, left edge, center]
    (model_generator.py:257-312 semantics: walk starts at the last point
    with y<0, x>=0 — the "3 o'clock" position — and spacing is
    perimeter / n_elec)."""
    n = data.shape[0]
    ds = []
    idx = int(np.where((data[:, 1] < 0) & (data[:, 0] >= 0))[0][-1])
    # wraparound guard (the reference indexes idx+1 unchecked,
    # model_generator.py:276)
    k, b = calc_lin_coef(data[idx], data[(idx + 1) % n])
    ds.append(calc_dist(data[idx], [0, b]))
    perim = calc_dist(data[0], data[-1])
    for i in range(data.shape[0] - 1):
        perim += calc_dist(data[i], data[i + 1])
    spacing = perim / n_elec
    distidx = np.r_[idx : data.shape[0], 0:idx]
    nearidx = [(idx, idx + 1)]
    s = -ds[0]
    for i in range(data.shape[0] - 1):
        s += calc_dist(data[distidx[i]], data[distidx[i + 1]])
        if s >= spacing:
            s -= spacing
            ds.append(s)
            nearidx.append((distidx[i], distidx[i + 1]))
    elecs = []
    for i in range(len(nearidx)):
        pr = data[nearidx[i][0]]
        pl = data[nearidx[i][1]]
        k, b = calc_lin_coef(pr, pl)
        d = calc_dist(pr, pl)
        x0 = pr[0] - (pr[0] - pl[0]) * ds[i] / d
        dx = (pr[0] - pl[0]) * r_elec / d
        temp = np.empty([3, 2])
        for j in range(2):
            a = -1 if j else 1
            temp[j] = [x0 + a * dx, k * (x0 + a * dx) + b]
        temp[2] = [x0, k * x0 + b]
        elecs.append(temp)
    return np.array(elecs)[:n_elec]


def insert_electrodes_to_polygon(
    polygon: np.ndarray, elecs: np.ndarray
) -> np.ndarray:
    """Replace skin points under each electrode footprint with the
    electrode edge points (model_generator.py:315-346)."""
    out = polygon.copy()
    for i in range(elecs.shape[0]):
        er, el = elecs[i, 0:2, 0].max(), elecs[i, 0:2, 0].min()
        eu, ed = elecs[i, 0:2, 1].max(), elecs[i, 0:2, 1].min()
        hit = np.where(
            (el <= out[:, 0]) & (out[:, 0] <= er)
            & (ed <= out[:, 1]) & (out[:, 1] <= eu)
        )[0]
        if hit.size == 0:
            insidx = None
            eps = 1e-9
            m = out.shape[0]
            # include the closing segment (the reference stops one short,
            # model_generator.py:330) and tolerate float round-off
            for j in range(m):
                seg = out[[j, (j + 1) % m], :]
                pr, pl = seg[:, 0].max() + eps, seg[:, 0].min() - eps
                pu, pd = seg[:, 1].max() + eps, seg[:, 1].min() - eps
                if pl <= elecs[i, 0, 0] <= pr and pd <= elecs[i, 0, 1] <= pu:
                    insidx = j + 1
                    break
            if insidx is None:
                # nearest-segment fallback: the reference raises here
                # (model_generator.py:341) but its polynomial smoothing can
                # legitimately push an electrode epsilon off the polygon;
                # snap to the closest segment instead and warn.
                import logging

                logging.getLogger("eitx_torch.fem").warning(
                    "electrode %d off polygon; snapping to nearest segment", i
                )
                a = out
                b = np.roll(out, -1, axis=0)
                v = b - a
                L2 = np.maximum((v**2).sum(1), 1e-30)
                w = elecs[i, 2] - a
                t = np.clip((w * v).sum(1) / L2, 0, 1)
                proj = a + t[:, None] * v
                dist = np.linalg.norm(proj - elecs[i, 2], axis=1)
                insidx = int(np.argmin(dist)) + 1
        else:
            out = np.delete(out, hit, axis=0)
            insidx = hit[0]
        out = np.insert(out, insidx, elecs[i, 0:2, :], axis=0)
    return out


def prepare_data(borders: Dict, settings: Settings) -> Tuple[Dict, np.ndarray]:
    """Full FEMM model-prep chain (model_generator.py:175-211): filter,
    cut small loops, center on the largest contour, polynomial smoothing,
    skin offset, electrode placement + insertion."""
    bordersf: Dict = {}
    max_area = 0.0
    max_tissue, max_idx = None, 0
    for tissue, elements in borders.items():
        bordersf[tissue] = {"coords": [], "pos": "cutted"}
        idx = 0
        for data in elements:
            dataf = filter_inline_points(data, accuracy=settings.accuracy)
            adataf = cut_min_area_close_points(
                dataf, settings.min_area, settings.accuracy
            )
            area = poly_area(adataf[:, 0], adataf[:, 1]) if adataf.size else 0
            if adataf.shape[0] >= 3 and area >= settings.min_area:
                bordersf[tissue]["coords"].append(adataf)
                if area > max_area:
                    max_area, max_tissue, max_idx = area, tissue, idx
                idx += 1
    if max_tissue is None:
        raise ValueError("no contour above min_area")
    bias = np.mean(bordersf[max_tissue]["coords"][max_idx], axis=0)
    bordersf[max_tissue]["pos"] = "edge1"
    for tissue, info in bordersf.items():
        for i in range(len(info["coords"])):
            info["coords"][i] = info["coords"][i] - bias
            if not (tissue == max_tissue and i == max_idx):
                info["coords"][i] = info["coords"][i][:: settings.thin_coeff]
    data = filter_degr_polyfit(bordersf[max_tissue]["coords"][max_idx], 90, 3)
    data = interpolate_surface_step(data, settings.polydeg, 2, 0.9, 3)
    data = interpolate_big_vert_breaks_poly(data, 10, 5)
    bordersf[max_tissue]["coords"][max_idx] = data
    skin = add_skin_radial(data, settings.skinthick)
    elecs = get_electrodes_coords(skin, settings.Nelec, settings.Relec)
    elecs[:, 2, :] = add_skin_radial(elecs[:, 2, :], settings.Relec)
    bordersf["skin"] = {
        "coords": [insert_electrodes_to_polygon(skin, elecs)],
        "pos": "edge1",
    }
    return bordersf, elecs


def write_fec(
    fname: str,
    bordersf: Dict,
    elecs: np.ndarray,
    settings: Settings,
    materials_at_freq: Dict[str, Dict[str, float]],
    projection: int = 0,
) -> str:
    """Write one FEMM current-flow problem as a .fec-style text file.

    Mirrors what femm.ci_saveas persists per projection
    (model_generator.py:349-371 + femm_api.py:7-160): problem definition,
    material block properties at the working frequency, INJ/GND conductor
    states for THIS projection (GND at electrode ``projection``, INJ at the
    next one — calculate_EIT_projection_femm semantics), then the contour
    geometry as numbered points/segments and one block label per closed
    region. Text (not FEMM's binary-float) so the file round-trips through
    load_fec; section names follow FEMM's bracketed-key layout.

    NOTE: this is a FEMM-STYLE interchange format, not FEMM-validated —
    no FEMM-written .fec exists in this environment (or the reference
    repo) to diff against, so fidelity is guaranteed only as
    write_fec -> load_fec round-trip plus the layout conventions above.
    Treat files as eitx's model-exchange format that FEMM users will find
    familiar, not as a byte-compatible FEMM artifact.
    """
    n_elec = elecs.shape[0]
    inj = 0 if projection == n_elec - 1 else projection + 1
    lines = [
        "[Format] = 1",
        f"[Frequency] = {settings.Freq}",
        "[Precision] = 1e-08",
        "[MinAngle] = 30",
        "[Depth] = 1",
        "[LengthUnits] = millimeters",
        "[ProblemType] = planar",
        "[Coordinates] = cartesian",
        f"[Comment] = \"eitx projection {projection}\"",
        "[PointProps] = 0",
        "[BdryProps] = 0",
    ]
    mats = dict(materials_at_freq)
    lines.append(f"[BlockProps] = {len(mats)}")
    for name, props in mats.items():
        lines += [
            "  <BeginBlock>",
            f"    <BlockName> = \"{name}\"",
            f"    <ox> = {props.get('cond', 0.0)!r}",
            f"    <oy> = {props.get('cond', 0.0)!r}",
            f"    <ex> = {props.get('perm', 0.0)!r}",
            f"    <ey> = {props.get('perm', 0.0)!r}",
            "  <EndBlock>",
        ]
    lines.append("[ConductorProps] = 2")
    lines += [
        "  <BeginConductor>",
        "    <ConductorName> = \"INJ\"",
        f"    <Totalamps_re> = {settings.I!r}",
        "    <ConductorType> = 0",
        f"    <Electrode> = {inj}",
        "  <EndConductor>",
        "  <BeginConductor>",
        "    <ConductorName> = \"GND\"",
        "    <Vc_re> = 0.0",
        "    <ConductorType> = 1",
        f"    <Electrode> = {projection}",
        "  <EndConductor>",
    ]
    # geometry: every contour becomes points + closing segments; the skin
    # contour carries the electrode edge points already inserted
    pts, segs, labels = [], [], []
    for tissue, info in bordersf.items():
        for data in info["coords"]:
            base = len(pts)
            m = data.shape[0]
            pts.extend((float(x), float(y)) for x, y in data)
            segs.extend((base + j, base + (j + 1) % m) for j in range(m))
            cx, cy = np.mean(data, axis=0)
            labels.append((float(cx), float(cy), tissue))
    lines.append(f"[NumPoints] = {len(pts)}")
    lines += [f"{x!r}\t{y!r}\t0\t0" for x, y in pts]
    lines.append(f"[NumSegments] = {len(segs)}")
    lines += [f"{a}\t{b}\t-1\t0\t0\t0" for a, b in segs]
    lines.append(f"[NumBlockLabels] = {len(labels)}")
    lines += [f"{x!r}\t{y!r}\t\"{t}\"\t0" for x, y, t in labels]
    lines.append(f"[NumElectrodes] = {n_elec}")
    lines += [
        "\t".join(repr(float(v)) for v in e.reshape(-1)) for e in elecs
    ]
    with open(fname, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return fname


def load_fec(fname: str) -> Dict:
    """Parse a write_fec file back into a model dict (round-trip check)."""
    doc: Dict = {"problem": {}, "materials": {}, "conductors": {},
                 "points": [], "segments": [], "labels": [],
                 "electrodes": []}
    with open(fname) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    i = 0

    def scalar(v: str):
        v = v.strip()
        if v.startswith('"'):
            return v.strip('"')
        try:
            return float(v) if ("." in v or "e" in v or "E" in v) else int(v)
        except ValueError:
            return v

    while i < len(lines):
        ln = lines[i].strip()
        if ln.startswith("[") and "=" in ln:
            key = ln[1:ln.index("]")]
            val = scalar(ln.split("=", 1)[1])
            if key in ("BlockProps", "ConductorProps"):
                begin, end, dest, name_key = (
                    ("<BeginBlock>", "<EndBlock>", "materials", "BlockName")
                    if key == "BlockProps"
                    else ("<BeginConductor>", "<EndConductor>", "conductors",
                          "ConductorName")
                )
                for _ in range(int(val)):
                    while not lines[i].strip().startswith(begin):
                        i += 1
                    props = {}
                    i += 1
                    while not lines[i].strip().startswith(end):
                        k, v = lines[i].strip().split("=", 1)
                        props[k.strip().strip("<>")] = scalar(v)
                        i += 1
                    doc[dest][props.pop(name_key)] = props
            elif key in ("NumPoints", "NumSegments", "NumBlockLabels",
                         "NumElectrodes"):
                dest = {"NumPoints": "points", "NumSegments": "segments",
                        "NumBlockLabels": "labels",
                        "NumElectrodes": "electrodes"}[key]
                for _ in range(int(val)):
                    i += 1
                    doc[dest].append(
                        [scalar(tok) for tok in lines[i].split("\t")]
                    )
            else:
                doc["problem"][key] = val
        i += 1
    doc["electrodes"] = np.array(doc["electrodes"]).reshape(-1, 3, 2)
    return doc


def save_model(
    fname: str,
    bordersf: Dict,
    elecs: np.ndarray,
    settings: Settings,
    materials_at_freq: Dict[str, Dict[str, float]],
    n_projections: int = 0,
    dirpath: str = "",
) -> list:
    """Save the model once, or n_projections times with the projection
    number in the name — femm's save_model contract
    (model_generator.py:349-371). Returns the list of file paths."""
    import os

    fpaths = []
    dirpath = dirpath or "./models/temp/"
    os.makedirs(dirpath, exist_ok=True)
    if n_projections:
        for i in range(n_projections):
            path = os.path.join(dirpath, f"{fname}{i}.fec")
            write_fec(path, bordersf, elecs, settings, materials_at_freq,
                      projection=i)
            fpaths.append(path)
    else:
        path = os.path.join(dirpath, f"{fname}.fec")
        write_fec(path, bordersf, elecs, settings, materials_at_freq)
        fpaths.append(path)
    return fpaths


def export_femm_model(
    fname: str,
    bordersf: Dict,
    elecs: np.ndarray,
    settings: Settings,
    materials_at_freq: Dict[str, Dict[str, float]],
) -> str:
    """Text model description replacing FEMM's binary .fec save
    (model_generator.py:349-371): problem definition, per-tissue contours
    with material properties, electrode coordinates and conductors."""
    doc = {
        "problem": {
            "type": "current_flow",
            "units": "millimeters",
            "frequency_hz": settings.Freq,
            "injected_current_a": settings.I,
            "n_electrodes": settings.Nelec,
        },
        "materials": materials_at_freq,
        "contours": {
            tissue: [c.tolist() for c in info["coords"]]
            for tissue, info in bordersf.items()
        },
        "electrodes": elecs.tolist(),
        "conductors": {"INJ": {"current": settings.I}, "GND": {"voltage": 0.0}},
    }
    text = json.dumps(doc)
    with open(fname, "w") as fh:
        fh.write(text)
    return fname
