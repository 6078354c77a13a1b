"""Batched, resumable synthetic-dataset generation (the dataset factory).

Port of eitx/pipeline/batch.py. Generation over many subjects is a
manifest-driven batch job: each subject writes an idempotent per-subject
``.dat`` shard, a manifest records its status, and a rerun skips the
completed shards, so a failed shard reruns without recomputing the rest.
Pending subjects whose meshes fall in one node bucket share one batched
spectral setup on the device.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, Tuple

from ..core.config import ClassMap, SimulationConfig
from ..core.device import resolve_device
from ..fem.forward import (
    simulate_eit_monitoring,
    simulate_eit_monitoring_subjects,
    write_dat,
)

logger = logging.getLogger("eitx_torch.pipeline.batch")


def _manifest_path(out_dir: str) -> str:
    return os.path.join(out_dir, "manifest.json")


def load_manifest(out_dir: str) -> Dict:
    path = _manifest_path(out_dir)
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh)
    return {"subjects": {}}


def _save_manifest(out_dir: str, manifest: Dict) -> None:
    tmp = _manifest_path(out_dir) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
    os.replace(tmp, _manifest_path(out_dir))


def generate_batch(
    subjects: Iterable[Tuple[str, Dict]],
    out_dir: str,
    cfg: SimulationConfig = SimulationConfig(),
    classes: ClassMap = ClassMap(),
    resume: bool = True,
    batch_subjects: bool = True,
    device="cuda",
) -> Dict:
    """Run EIT monitoring for every (subject_id, mesh_data) pair on
    ``device``.

    Writes ``<out_dir>/results_<id>.dat`` per subject plus a manifest.
    Returns the final manifest. Idempotent: completed subjects are skipped
    when ``resume`` is True; failures are recorded and do not abort the
    batch.

    With ``batch_subjects`` (spectral solver, point electrodes) the pending
    subjects' pencil factorizations run as ONE batched setup per node
    bucket (fem.forward.simulate_eit_monitoring_subjects); their manifest
    entries carry ``"batched": true``. On any batched failure every pending
    subject reruns alone, on the same device, so one bad mesh cannot poison
    its bucket.
    """
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    manifest = load_manifest(out_dir) if resume else {"subjects": {}}
    pending = []
    for subject_id, mesh_data in subjects:
        entry = manifest["subjects"].get(subject_id)
        out_file = os.path.join(out_dir, f"results_{subject_id}.dat")
        if (
            resume
            and entry
            and entry.get("status") == "done"
            and os.path.exists(out_file)
        ):
            logger.info("skip %s (done)", subject_id)
            continue
        pending.append((subject_id, mesh_data, out_file))

    def run_single(subject_id, mesh_data, out_file):
        t0 = time.time()
        try:
            v, dt = simulate_eit_monitoring(
                mesh_data,
                cfg,
                classes=classes,
                save_to_file=True,
                filename=out_file,
                device=dev,
            )
            manifest["subjects"][subject_id] = {
                "status": "done",
                "file": out_file,
                "frames": int(v.shape[0]),
                "row_width": int(v.shape[1]),
                "generation_s": round(dt, 3),
            }
            logger.info("done %s in %.2fs", subject_id, time.time() - t0)
        except Exception as e:
            manifest["subjects"][subject_id] = {
                "status": "failed",
                "error": f"{type(e).__name__}: {e}",
            }
            logger.error("failed %s: %s", subject_id, e)
        _save_manifest(out_dir, manifest)

    use_batched = (
        batch_subjects and len(pending) > 1 and cfg.solver == "spectral"
        and cfg.electrode_model != "cem"
    )
    if use_batched:
        try:
            results = simulate_eit_monitoring_subjects(
                [md for _, md, _ in pending], cfg, classes=classes, device=dev
            )
            for (subject_id, _, out_file), (v, dt) in zip(pending, results):
                write_dat(out_file, v, n_repeats=cfg.n_spir * cfg.n_minutes)
                manifest["subjects"][subject_id] = {
                    "status": "done",
                    "file": out_file,
                    "frames": int(v.shape[0]),
                    "row_width": int(v.shape[1]),
                    "generation_s": round(dt, 3),
                    "batched": True,
                }
                logger.info("done %s (batched, %.2fs/subject)", subject_id, dt)
            _save_manifest(out_dir, manifest)
            return manifest
        except Exception as e:
            logger.error(
                "batched generation failed (%s); per-subject fallback", e
            )
    for subject_id, mesh_data, out_file in pending:
        run_single(subject_id, mesh_data, out_file)
    return manifest


def main(argv=None):
    """CLI: python -m eitx_torch.pipeline.batch out_dir mesh1.txt ...

    Each mesh file is a FEMM-format text mesh (subject id = file stem).
    """
    import argparse

    from ..mesh.export import read_mesh_txt

    p = argparse.ArgumentParser(description="eitx_torch batch dataset generation")
    p.add_argument("out_dir")
    p.add_argument("meshes", nargs="+")
    p.add_argument("--n-points", type=int, default=100)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    subjects = []
    for path in args.meshes:
        sid = os.path.splitext(os.path.basename(path))[0]
        subjects.append((sid, read_mesh_txt(path)))
    cfg = SimulationConfig(n_points=args.n_points)
    man = generate_batch(subjects, args.out_dir, cfg,
                         resume=not args.no_resume, device=args.device)
    done = sum(1 for s in man["subjects"].values() if s["status"] == "done")
    print(f"{done}/{len(man['subjects'])} subjects done")


if __name__ == "__main__":
    main()
