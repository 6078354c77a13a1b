"""Client helpers: zip-in-memory uploads to the service (copy of
eitx/serve/client.py).

Parity with the reference frontend's transport layer
(frontend/frontend_utils.py:9-85: zip the selected files in memory, POST
multipart to the kt_service endpoint, return the JSON answer)."""

from __future__ import annotations

import io
import json
import urllib.request
import zipfile
from typing import Dict, Iterable, Optional, Tuple

ENDPOINTS = {
    "dicom_sequences_auto": "/uploadDicomSequence",
    "dicom_sequences_custom": "/uploadDicomSequenceCustom",
    "dicom_frame": "/uploadDicomFrame",
    "jpg_png": "/uploadImageAxialSlice",
    "nii": "/uploadNII",
}


def zip_files_in_memory(
    files: Iterable[Tuple[str, bytes]], custom_input: Optional[int] = None
) -> bytes:
    """[(name, bytes)...] -> zip archive bytes; optional custom_input.txt
    carries the manual slice offset for the custom mode."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in files:
            zf.writestr(name, data)
        if custom_input is not None:
            zf.writestr("custom_input.txt", str(int(custom_input)))
    return buf.getvalue()


def upload(
    base_url: str,
    mode: str,
    zip_bytes: bytes,
    timeout: float = 600.0,
) -> Dict:
    """POST a zip to the endpoint for ``mode``; returns the answer dict."""
    path = ENDPOINTS[mode]
    req = urllib.request.Request(
        base_url.rstrip("/") + path,
        data=zip_bytes,
        headers={"Content-Type": "application/zip"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())
