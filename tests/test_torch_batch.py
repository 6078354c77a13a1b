"""The dataset factory (eitx_torch.pipeline.batch) against eitx's on the
CPU: same manifests, statuses and ``batched`` flags, the same ``.dat``
layout, voltages within bound, resume and the per-subject fallback."""

import numpy as np
import pytest

from eitx.core.config import SimulationConfig as EitxSimulationConfig
from eitx.pipeline.batch import generate_batch as eitx_generate_batch
from eitx_torch.core.config import SimulationConfig
from eitx_torch.mesh.export import write_mesh_txt
from eitx_torch.pipeline.batch import generate_batch, load_manifest, main
from meshfix import disk_mesh_with_classes
from torch_bounds import bounded

# pads that put the three disks into two node buckets: 141 and 133 nodes
# round up to 256, 289 to 512
KW = dict(n_points=3, pad_nodes_to=256, pad_elems_to=1024)
BAD = ("bad", {"NODES": [], "TRIANGLES": [], "CLASS": []})


def _subject(name, nb, rings=6, seed=0):
    nodes, tris, cls = disk_mesh_with_classes(nb, rings)
    scale = 100.0 * (1.0 + 0.02 * np.random.default_rng(seed).standard_normal())
    return name, {"NODES": nodes * scale, "TRIANGLES": tris, "CLASS": cls}


SUBJECTS = [_subject("s0", 40, seed=0), _subject("s1", 44, 5, seed=1),
            _subject("s2", 64, 8, seed=2)]


def _entries(manifest):
    """Manifest entries without the wall time and the output directory."""
    return {sid: {k: v for k, v in e.items()
                  if k not in ("generation_s", "file", "error")}
            for sid, e in manifest["subjects"].items()}


def _rows(path):
    return np.loadtxt(path, ndmin=2)


@pytest.mark.parametrize("subjects", [SUBJECTS, SUBJECTS + [BAD]],
                         ids=["batched", "fallback"])
def test_generate_batch_matches_eitx(subjects, tmp_path, record_property):
    """All good subjects: one batched setup per bucket, every entry
    ``batched``. With a bad mesh the batched run fails and every subject
    reruns alone, as in eitx: the good ones done, without the flag."""
    man = generate_batch(subjects, str(tmp_path / "port"),
                         SimulationConfig(**KW), device="cpu")
    ref = eitx_generate_batch(subjects, str(tmp_path / "eitx"),
                              EitxSimulationConfig(**KW))
    assert _entries(man) == _entries(ref)
    assert load_manifest(str(tmp_path / "port")) == man
    batched = len(subjects) == len(SUBJECTS)
    for sid, _ in SUBJECTS:
        entry = man["subjects"][sid]
        assert entry["status"] == "done"
        assert entry.get("batched", False) is batched
        got = _rows(tmp_path / "port" / f"results_{sid}.dat")
        want = _rows(tmp_path / "eitx" / f"results_{sid}.dat")
        assert got.shape == want.shape == (3 * 12, 208)
        # the same low-rank factorization on the same small mesh
        # (tests/test_spectral.py:81)
        err = (np.abs(got - want) / (1e-7 + 2e-4 * np.abs(want))).max()
        bounded(record_property, f"{sid} allclose(2e-4, 1e-7) err", err,
                "<=", 1.0)
    if not batched:
        assert man["subjects"]["bad"]["status"] == "failed"
        assert man["subjects"]["bad"]["error"].split(":")[0] == (
            ref["subjects"]["bad"]["error"].split(":")[0])


def test_generate_batch_resumes_and_is_byte_stable(tmp_path):
    out = tmp_path / "out"
    cfg = SimulationConfig(**KW)
    subjects = SUBJECTS[:2] + [BAD]
    man = generate_batch(subjects, str(out), cfg, device="cpu")
    f0 = out / "results_s0.dat"
    mtime, data = f0.stat().st_mtime_ns, f0.read_bytes()
    # resume: done subjects skipped (file untouched), the failed one retried
    man2 = generate_batch(subjects, str(out), cfg, device="cpu")
    assert f0.stat().st_mtime_ns == mtime
    assert man2["subjects"]["bad"]["status"] == "failed"
    assert man2["subjects"]["s1"] == man["subjects"]["s1"]
    # no resume: everything reruns, batched, into the same bytes
    man3 = generate_batch(SUBJECTS[:2], str(out), cfg, resume=False,
                          device="cpu")
    assert all(e["batched"] for e in man3["subjects"].values())
    assert f0.read_bytes() == data


def test_generate_batch_refuses_a_missing_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_batch(SUBJECTS[:1], str(tmp_path))


def test_batch_cli_over_mesh_text_files(tmp_path, capsys):
    paths = []
    for sid, mesh in SUBJECTS[:2]:
        path = tmp_path / f"{sid}.txt"
        write_mesh_txt(str(path), {k: np.asarray(v).tolist()
                                   for k, v in mesh.items()})
        paths.append(str(path))
    main([str(tmp_path / "out"), *paths, "--n-points", "3", "--device",
          "cpu"])
    assert "2/2 subjects done" in capsys.readouterr().out
    man = load_manifest(str(tmp_path / "out"))
    assert set(man["subjects"]) == {"s0", "s1"}
