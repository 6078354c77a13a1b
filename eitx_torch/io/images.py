"""Host-side image decode/encode (PIL, native C) and base64 helpers."""

from __future__ import annotations

import base64
from io import BytesIO
from typing import Union

import numpy as np
from PIL import Image

from ..core.errors import IngestError


def decode_image(data: Union[bytes, BytesIO]) -> np.ndarray:
    """PNG/JPEG bytes -> ndarray (H, W) or (H, W, 3) uint8 — the
    uploadImageAxialSlice ingest (main_kt_service.py:110-114)."""
    try:
        if isinstance(data, (bytes, bytearray)):
            data = BytesIO(data)
        img = Image.open(data)
        return np.array(img)
    except Exception as e:
        raise IngestError(f"cannot decode image: {e}") from e


def to_png_bytes(image: np.ndarray) -> bytes:
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    buf = BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def encode_png_base64(image: np.ndarray) -> str:
    """BGR->RGB swap + PNG + base64, the answer-image contract
    (utils.py:1036-1045)."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = arr[:, :, ::-1]  # BGR -> RGB
    return base64.b64encode(to_png_bytes(arr)).decode("utf-8")
