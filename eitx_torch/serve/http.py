"""HTTP service exposing the five upload endpoints over the port's
``Pipeline``.

Port of eitx/serve/http.py, endpoint for endpoint (the reference's FastAPI
app, main_kt_service.py:33-142): POST /uploadDicomSequence,
/uploadDicomSequenceCustom, /uploadDicomFrame, /uploadImageAxialSlice,
/uploadNII — multipart field ``file`` carrying a zip — and /createMesh;
GET /health and /ui. Error mapping: bad upload -> 400, processing error
-> 500 with detail. Implemented on the stdlib ThreadingHTTPServer.

Requests run concurrently, as the reference's do: the pipeline switches
no process-wide torch setting per request (TF32 is switched off once,
when ``eitx_torch`` is imported; the stiffness scatter is deterministic without
a flag, ``fem.assembly.scatter_sum_fixed_order``), so a request's
``.dat`` is the same bytes whatever runs beside it. The listen backlog is
deeper than socketserver's 5, so a burst of clients is queued instead of
dropped.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from io import BytesIO
from typing import Callable, Dict, Optional

from ..core.errors import EitxError, IngestError

logger = logging.getLogger("eitx_torch.serve")


class _LimitedReader:
    """Reads at most ``length`` bytes from an underlying stream."""

    def __init__(self, raw, length: int):
        self._raw = raw
        self.remaining = length

    def read(self, n: int) -> bytes:
        if self.remaining <= 0:
            return b""
        data = self._raw.read(min(n, self.remaining))
        self.remaining -= len(data)
        return data


def _spool_body(reader: _LimitedReader, max_memory: int = 32 << 20):
    """Stream the raw body into a spooled temp file (disk past 32 MB)."""
    import tempfile

    spool = tempfile.SpooledTemporaryFile(max_size=max_memory)
    while True:
        chunk = reader.read(1 << 20)
        if not chunk:
            break
        spool.write(chunk)
    spool.seek(0)
    return spool


def _parse_multipart_stream(
    reader: _LimitedReader, content_type: str, max_memory: int = 32 << 20
):
    """Stream the FIRST file part of a multipart/form-data body to a
    spooled temp file — a multi-hundred-MB DICOM series zip never sits in
    memory twice (the reference streams through FastAPI's parser; the old
    in-memory split here doubled RSS on large uploads).
    """
    import tempfile

    if "boundary=" not in content_type:
        raise IngestError("multipart body without boundary")
    boundary = content_type.split("boundary=", 1)[1].strip().strip('"')
    marker = b"\r\n--" + boundary.encode()  # terminates a payload
    first = b"--" + boundary.encode()
    buf = b""

    def more() -> bool:
        nonlocal buf
        chunk = reader.read(1 << 20)
        if not chunk:
            return False
        buf += chunk
        return True

    # skip preamble up to and including the first boundary line
    while True:
        idx = buf.find(first)
        if idx >= 0:
            buf = buf[idx:]
            break
        buf = buf[-(len(first) + 2):]
        if not more():
            raise IngestError("no multipart boundary found")
    while True:
        # headers of the current part end at the first blank line
        while b"\r\n\r\n" not in buf:
            if not more():
                raise IngestError("truncated multipart headers")
        head, buf = buf.split(b"\r\n\r\n", 1)
        is_file = b"filename=" in head or b'name="file"' in head
        spool = (
            tempfile.SpooledTemporaryFile(max_size=max_memory)
            if is_file
            else None
        )
        # stream the payload until the next boundary marker, carrying a
        # tail so a marker straddling two chunks is still found
        while True:
            idx = buf.find(marker)
            if idx >= 0:
                if spool is not None:
                    spool.write(buf[:idx])
                buf = buf[idx + len(marker):]
                break
            keep = len(marker) - 1
            if len(buf) > keep:
                if spool is not None:
                    spool.write(buf[:-keep])
                buf = buf[-keep:]
            if not more():
                raise IngestError("truncated multipart payload")
        if spool is not None:
            spool.seek(0)
            return spool
        # not the file part: continue to the next part's headers


class _Handler(BaseHTTPRequestHandler):
    routes: Dict[str, Callable[[BytesIO], dict]] = {}

    def log_message(self, fmt, *args):  # route through logging
        logger.info("%s - %s", self.address_string(), fmt % args)

    def _send(self, code: int, payload: dict):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        path = self.path.rstrip("/")
        if path in ("", "/health"):
            self._send(200, {"status": "ok", "endpoints": sorted(self.routes)})
        elif path == "/ui":
            from .frontend import FRONTEND_HTML

            data = FRONTEND_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._send(404, {"detail": "not found"})

    def do_POST(self):  # noqa: N802
        path = self.path.rstrip("/")
        handler = self.routes.get(path)
        if handler is None:
            self._send(404, {"detail": f"unknown endpoint {path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            reader = _LimitedReader(self.rfile, length)
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                body = _parse_multipart_stream(reader, ctype)
            else:
                body = _spool_body(reader)
            answer = handler(body)
            self._send(200, answer)
        except IngestError as e:
            logger.error("bad request on %s: %s", path, e)
            self._send(400, {"detail": str(e)})
        except EitxError as e:
            logger.error("pipeline error on %s: %s", path, e)
            self._send(500, {"detail": f"processing error: {e}"})
        except Exception as e:  # pragma: no cover
            logger.exception("unexpected error on %s", path)
            self._send(500, {"detail": f"internal error: {e}"})


def _create_mesh_route(body: BytesIO, device) -> dict:
    """Standalone mesh microservice (reference main_mesh_service.py:18-44):
    POST JSON {"params": [sx, sy, lc?, distance_threshold?, skin_width?],
    "polygons": [...]} -> base64 PNG of the classed mesh + element count.
    The triangles are classified on ``device`` (the pipeline's)."""
    import numpy as np

    from ..io.images import encode_png_base64
    from ..mesh import create_mesh

    try:
        payload = json.loads(body.read().decode("utf-8"))
        params = payload["params"]
        polygons = payload["polygons"]
    except (ValueError, KeyError) as e:
        raise IngestError(f"bad /createMesh payload: {e}") from e
    kw = {}
    if len(params) > 2:
        kw["lc"] = float(params[2])
    if len(params) > 3:
        kw["distance_threshold"] = float(params[3])
    if len(params) > 4:
        kw["skin_width"] = float(params[4])
    img, mesh_data = create_mesh(params[:2], list(polygons), device=device,
                                 **kw)
    return {
        "status": "success",
        "image": encode_png_base64(np.asarray(img)),
        "n_elements": len(mesh_data["TRIANGLES"]),
        "n_nodes": len(mesh_data["NODES"]),
    }


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: a burst of more clients
    # than that, with the host busy, overflows the accept queue, and a
    # client whose connection was not queued sees it reset
    request_queue_size = 128


class EitxHTTPServer:
    """Wraps ThreadingHTTPServer with the pipeline routes, which run
    concurrently (see the module docstring); ``/createMesh`` classifies on
    the pipeline's device."""

    def __init__(self, pipeline, host: str = "0.0.0.0", port: int = 5001):
        handler = type("BoundHandler", (_Handler,), {})
        routes = {
            "/uploadDicomSequence": pipeline.run_dicom_sequences_auto,
            "/uploadDicomSequenceCustom": pipeline.run_dicom_sequences_custom,
            "/uploadDicomFrame": pipeline.run_dicom_frame,
            "/uploadImageAxialSlice": pipeline.run_jpg_png_zip,
            "/uploadNII": pipeline.run_nii,
            "/createMesh": lambda body: _create_mesh_route(body,
                                                           pipeline.device),
        }
        handler.routes = routes
        self.httpd = _Server((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start_background(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        logger.info("eitx_torch service listening on :%d", self.port)
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


def make_server(
    pipeline=None, host: str = "0.0.0.0", port: int = 5001, device="cuda",
    **pipeline_kw
) -> EitxHTTPServer:
    """A server over ``pipeline``, or over a new ``Pipeline`` built on
    ``device`` (the port's entry points take the device they run on)."""
    if pipeline is None:
        from ..pipeline import Pipeline

        pipeline = Pipeline(device=device, **pipeline_kw)
    return EitxHTTPServer(pipeline, host, port)


def main():  # pragma: no cover
    """CLI: python -m eitx_torch.serve.http [--device cuda] [--port 5001].

    Unlike the reference's entry point it enables no compile cache: the
    port compiles nothing at run time but its kernels, and those are
    built once and kept by the hash of their source and flags
    (``eitx_torch/_build.py``)."""
    import argparse
    import os

    # Default checkpoint discovery mirrors the reference's fixed weight
    # paths (kt_service_config.py:1-3): env var, else the best in-repo
    # trained checkpoint for each slot (s-variant preferred over n).
    from ..core.weights import find_checkpoint

    def default_ckpt(env: str, stem: str, size: int):
        return os.environ.get(env) or find_checkpoint(stem, size)

    p = argparse.ArgumentParser(description="eitx_torch CT->EIT service")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5001)
    # the port's entry points take the device they run on
    p.add_argument("--device", default="cuda")
    p.add_argument("--ribs-weights",
                   default=default_ckpt("EITX_RIBS_WEIGHTS", "ribs", 640))
    p.add_argument("--axial-weights-256",
                   default=default_ckpt("EITX_AXIAL_WEIGHTS_256",
                                        "tissue", 256))
    p.add_argument("--axial-weights-512",
                   default=default_ckpt("EITX_AXIAL_WEIGHTS_512",
                                        "tissue", 512))
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)

    from ..core.config import ModelConfig, PipelineConfig
    from ..pipeline import Pipeline

    def existing(path):
        return path if path and os.path.exists(path) else None

    cfg = PipelineConfig(
        model=ModelConfig(
            ribs_weights=existing(args.ribs_weights),
            axial_weights_256=existing(args.axial_weights_256),
            axial_weights_512=existing(args.axial_weights_512),
        )
    )
    make_server(Pipeline(cfg, device=args.device), host=args.host,
                port=args.port).serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
