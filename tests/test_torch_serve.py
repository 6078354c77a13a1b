"""The port's HTTP service against eitx's: the routes, error mapping and
pages of tests/test_serve.py on a stub pipeline, the streaming multipart
parser byte for byte, two concurrent requests through the real CPU
pipeline, and a burst of concurrent requests inside the pipeline at once."""

import io
import json
import re
import sys
import threading
import urllib.error
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from eitx.core.errors import IngestError as EitxIngestError
from eitx.serve.http import _LimitedReader as EitxLimitedReader
from eitx.serve.http import _parse_multipart_stream as eitx_parse
from eitx.train.phantoms import phantom_batch
from eitx_torch.core.config import (
    ModelConfig,
    PipelineConfig,
    SimulationConfig,
)
from eitx_torch.contours import trace
from eitx_torch.core.errors import IngestError
from eitx_torch.io import to_png_bytes
from eitx_torch.mesh import triangulate
from eitx_torch.pipeline import Pipeline
from eitx_torch.serve import EitxHTTPServer, make_server
from eitx_torch.serve.client import upload, zip_files_in_memory
from eitx_torch.serve.http import _LimitedReader, _parse_multipart_stream
from test_torch_pipeline import CKPT_256

MODES = [("/uploadDicomSequence", "auto"),
         ("/uploadDicomSequenceCustom", "custom"),
         ("/uploadDicomFrame", "frame"), ("/uploadImageAxialSlice", "jpg"),
         ("/uploadNII", "nii")]


class StubPipeline:
    """tests/test_serve.py's stub, with the device the routes need and a
    count of the calls inside it at once."""

    device = torch.device("cpu")

    def __init__(self, hold: float = 0.0, together: int = 0):
        self.calls = []
        self.active = self.most_active = 0
        self._count = threading.Lock()
        self.hold = hold
        self.gate = threading.Event()  # cleared: a request waits inside
        self.gate.set()
        self.entered = threading.Event()
        # the first ``together`` requests wait inside until all of them are
        # in: served one at a time, they would break the barrier
        self.barrier = threading.Barrier(together) if together else None

    def _ok(self, name, blob):
        with self._count:
            self.active += 1
            self.most_active = max(self.most_active, self.active)
            first = len(self.calls) < (self.barrier.parties
                                        if self.barrier else 0)
            self.calls.append(name)
        self.entered.set()
        try:
            if first:
                self.barrier.wait(timeout=30)
            self.gate.wait(timeout=30)
            data = blob.read()
            if self.hold:
                threading.Event().wait(self.hold)
            # raise like the real ingest on non-zip payloads
            if not data.startswith(b"PK"):
                raise IngestError("uploaded file is not a valid ZIP archive")
            return {"status": "success", "mode": name, "bytes": len(data)}
        finally:
            with self._count:
                self.active -= 1

    def run_dicom_sequences_auto(self, b):
        return self._ok("auto", b)

    def run_dicom_sequences_custom(self, b):
        return self._ok("custom", b)

    def run_dicom_frame(self, b):
        return self._ok("frame", b)

    def run_jpg_png_zip(self, b):
        return self._ok("jpg", b)

    def run_nii(self, b):
        return self._ok("nii", b)


@pytest.fixture(scope="module")
def server():
    srv = EitxHTTPServer(StubPipeline(), host="127.0.0.1", port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _zip_bytes():
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("x.bin", b"data")
    return buf.getvalue()


def _post(port, path, body, content_type="application/octet-stream"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": content_type}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read()


def _multipart(blob, boundary="xyzBOUNDARYxyz", name="a.zip"):
    return (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="file"; filename="{name}"\r\n'
        "Content-Type: application/zip\r\n\r\n"
    ).encode() + blob + f"\r\n--{boundary}--\r\n".encode()


@pytest.mark.parametrize("path,mode", MODES)
def test_endpoints_raw_body(server, path, mode):
    code, ans = _post(server.port, path, _zip_bytes())
    assert code == 200 and ans["mode"] == mode


def test_multipart_upload(server):
    blob = _zip_bytes()
    code, ans = _post(server.port, "/uploadDicomFrame", _multipart(blob),
                      "multipart/form-data; boundary=xyzBOUNDARYxyz")
    assert code == 200 and ans["bytes"] == len(blob)


@pytest.mark.parametrize("body,ctype,what", [
    (b"this is not a zip", "application/octet-stream", "ZIP"),
    (b"--xx\r\nno blank line", "multipart/form-data; boundary=xx",
     "truncated"),
    (b"anything", "multipart/form-data", "boundary"),
])
def test_bad_upload_maps_to_400(server, body, ctype, what):
    code, ans = _post(server.port, "/uploadNII", body, ctype)
    assert code == 400 and what in ans["detail"]


def test_unknown_endpoint_404(server):
    assert _post(server.port, "/nope", b"")[0] == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(server.port, "/nope")
    assert err.value.code == 404


def test_health_and_ui(server):
    code, _, body = _get(server.port, "/health")
    ans = json.loads(body)
    assert code == 200 and ans["status"] == "ok"
    assert set(ans["endpoints"]) == {p for p, _ in MODES} | {"/createMesh"}
    code, ctype, html = _get(server.port, "/ui")
    assert code == 200 and "text/html" in ctype
    radios = re.findall(r'input type=radio name=mode value="([^"]+)"',
                        html.decode())
    assert sorted(radios) == sorted(p for p, _ in MODES)


def test_create_mesh_route_meshes_on_the_pipeline_device(server):
    """/createMesh on a square with a lung inside, as the reference's mesh
    microservice takes it; bad JSON is a 400."""
    outer = "4 " + " ".join(f"{x} {y}" for x, y in
                            [(0, 0), (60, 0), (60, 60), (0, 60), (0, 0)])
    lung = "2 " + " ".join(f"{x} {y}" for x, y in
                           [(20, 20), (40, 20), (40, 40), (20, 40), (20, 20)])
    body = json.dumps({"params": [1, 1, 8], "polygons": [outer, lung]})
    code, ans = _post(server.port, "/createMesh", body.encode(),
                      "application/json")
    assert code == 200 and ans["status"] == "success"
    assert ans["n_elements"] > 0 and ans["image"]
    code, ans = _post(server.port, "/createMesh", b"{not json",
                      "application/json")
    assert code == 400 and "createMesh" in ans["detail"]


def _bodies():
    """(name, body, content type) cases: a plain part, a payload whose
    closing marker straddles the parser's 1 MiB reads, a non-file first
    part, a payload holding a near-marker, a quoted boundary with a
    preamble and an epilogue."""
    b = "XbOuNdX"
    head = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.zip\"\r\n\r\n").encode()
    straddle = bytes(range(256)) * 4096
    straddle = straddle[:(1 << 20) - len(head) - 3]
    tricky = b"A" * 100 + b"\r\n--XbOuNd" + b"B" * 100
    ctype = f"multipart/form-data; boundary={b}"
    close = f"\r\n--{b}--\r\n".encode()
    return [
        ("plain", head + b"PK\x03\x04payload" + close, ctype),
        ("straddle", head + straddle + close, ctype),
        ("second_part", f"--{b}\r\nContent-Disposition: form-data; "
         f"name=\"comment\"\r\n\r\nnot the file\r\n".encode() + head
         + bytes(range(256)) * 9000 + close, ctype),
        ("near_marker", head + tricky + close, ctype),
        ("quoted", b"preamble\r\n" + head + b"PKdata" + close + b"epilogue",
         f'multipart/form-data; boundary="{b}"'),
    ]


@pytest.mark.parametrize("case", _bodies(), ids=lambda c: c[0])
def test_multipart_parser_bytes_equal_eitx(case):
    _, body, ctype = case
    want = eitx_parse(EitxLimitedReader(io.BytesIO(body), len(body)),
                      ctype).read()
    got = _parse_multipart_stream(_LimitedReader(io.BytesIO(body),
                                                 len(body)), ctype).read()
    assert got == want and len(got) > 0


@pytest.mark.parametrize("body,ctype", [
    (b"--b\r\nContent-Disposition: form-data; name=\"file\"\r\n\r\nPK",
     "multipart/form-data; boundary=b"),
    (b"no boundary here at all", "multipart/form-data; boundary=b"),
    (b"x", "multipart/form-data"),
])
def test_multipart_parser_rejects_as_eitx_does(body, ctype):
    with pytest.raises(EitxIngestError) as want:
        eitx_parse(EitxLimitedReader(io.BytesIO(body), len(body)), ctype)
    with pytest.raises(IngestError) as got:
        _parse_multipart_stream(_LimitedReader(io.BytesIO(body), len(body)),
                                ctype)
    assert str(got.value) == str(want.value)


def test_concurrent_requests_are_answered_one_at_a_time():
    """More client threads than cores, a short switch interval: every
    request is answered with its own bytes, four of them are inside the
    pipeline at once (the service lets requests run concurrently, as
    eitx's does; the test's name is older than that), and /health answers
    while a request holds the pipeline."""
    stub = StubPipeline(hold=0.005, together=4)
    srv = EitxHTTPServer(stub, host="127.0.0.1", port=0)
    srv.start_background()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        body = _zip_bytes()
        with ThreadPoolExecutor(max_workers=16) as pool:
            futures = [pool.submit(_post, srv.port, path, body)
                       for _ in range(4) for path, _ in MODES]
            answers = [f.result(timeout=60) for f in futures]
        assert [code for code, _ in answers] == [200] * 20
        assert [ans["bytes"] for _, ans in answers] == [len(body)] * 20
        assert sorted(ans["mode"] for _, ans in answers) == sorted(
            mode for _ in range(4) for _, mode in MODES)
        assert len(stub.calls) == 20 and stub.most_active >= 4
        stub.gate.clear()  # the next request waits inside the pipeline
        stub.entered.clear()
        with ThreadPoolExecutor(max_workers=1) as pool:
            held = pool.submit(_post, srv.port, "/uploadNII", body)
            assert stub.entered.wait(timeout=30)
            assert _get(srv.port, "/health")[0] == 200
            assert not held.done()
            stub.gate.set()
            assert held.result(timeout=60)[0] == 200
    finally:
        sys.setswitchinterval(interval)
        stub.gate.set()
        srv.shutdown()


def test_make_server_builds_the_pipeline_on_the_device(tmp_path):
    srv = make_server(host="127.0.0.1", port=0, device="cpu",
                      config=PipelineConfig(results_dir=str(tmp_path)))
    srv.httpd.server_close()
    assert srv.port > 0
    if not torch.cuda.is_available():  # the default is the card, or raise
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_server(host="127.0.0.1", port=0)


def test_real_request_dat_equals_direct_call(tmp_path, monkeypatch):
    """Two concurrent requests through HTTP to the real CPU pipeline
    (trained 256 checkpoint, one view, 3 frames), the first to load the
    native mesher and contour tracer, as on a cold server: each .dat is
    byte-equal to a direct call's."""
    for mod in (triangulate, trace):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_LIB_TRIED", False)
    b = phantom_batch(1, 256, 12, np.random.default_rng(42))
    img = (b["images"][0, ..., 0] * 255).astype(np.uint8)
    pipe = Pipeline(PipelineConfig(
        model=ModelConfig(axial_weights_256=CKPT_256, axial_tta_fill=1),
        sim=SimulationConfig(n_points=3), results_dir=str(tmp_path),
    ), device="cpu")
    srv = EitxHTTPServer(pipe, host="127.0.0.1", port=0)
    srv.start_background()
    try:
        zipped = zip_files_in_memory([("slice.png", to_png_bytes(img))])
        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = [pool.submit(
                _post, srv.port, "/uploadImageAxialSlice", _multipart(zipped),
                "multipart/form-data; boundary=xyzBOUNDARYxyz")
                for _ in range(2)]
            answers = [f.result(timeout=300) for f in futures]
        with pytest.raises(urllib.error.HTTPError) as bad:
            upload(f"http://127.0.0.1:{srv.port}", "jpg_png", b"not a zip")
    finally:
        srv.shutdown()
    for code, ans in answers:
        assert code == 200 and ans["status"] == "success", ans
    assert bad.value.code == 400
    direct = pipe.run_jpg_png(img)
    with open(direct["saved_file_name"], "rb") as d:
        want = d.read()
    assert len(want.splitlines()) == 3 * 12
    for _, ans in answers:
        assert ans["saved_file_name"] != direct["saved_file_name"]
        with open(ans["saved_file_name"], "rb") as a:
            assert a.read() == want
