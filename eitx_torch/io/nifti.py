"""Minimal NIfTI-1 reader/writer (nibabel replacement for this pipeline).

Handles single-file .nii / .nii.gz, the numeric dtypes CT exports use, and
the header fields the pipeline reads (dim, pixdim, scl_slope/scl_inter,
vox_offset). Mirrors nib.load(...).get_fdata() semantics including the
scaling rule (reference utils.py:1088-1098 reads pixdim[1:3] for spacing).
"""

from __future__ import annotations

import gzip
import struct
from typing import BinaryIO, Tuple, Union

import numpy as np

from ..core.errors import IngestError

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_nifti(data: Union[bytes, BinaryIO, str]):
    """Returns (volume ndarray in header dtype scaling applied -> float64,
    pixdim tuple)."""
    if isinstance(data, str):
        with open(data, "rb") as fh:
            data = fh.read()
    elif hasattr(data, "read"):
        data = data.read()
    buf = bytes(data)
    if buf[:2] == b"\x1f\x8b":
        buf = gzip.decompress(buf)
    if len(buf) < 352:
        raise IngestError("truncated NIfTI file")
    (sizeof_hdr,) = struct.unpack_from("<i", buf, 0)
    if sizeof_hdr != 348:
        raise IngestError(f"bad NIfTI header size {sizeof_hdr}")
    magic = buf[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise IngestError(f"bad NIfTI magic {magic!r}")
    dim = struct.unpack_from("<8h", buf, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise IngestError(f"bad NIfTI ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    (datatype,) = struct.unpack_from("<h", buf, 70)
    pixdim = struct.unpack_from("<8f", buf, 76)
    (vox_offset,) = struct.unpack_from("<f", buf, 108)
    scl_slope, scl_inter = struct.unpack_from("<2f", buf, 112)
    dtype = _DTYPES.get(datatype)
    if dtype is None:
        raise IngestError(f"unsupported NIfTI datatype {datatype}")
    count = int(np.prod(shape))
    off = int(vox_offset) if vox_offset else 352
    arr = np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder("<"),
                        count=count, offset=off)
    # NIfTI is Fortran (column-major) ordered.
    vol = arr.reshape(shape, order="F").astype(np.float64)
    if scl_slope not in (0.0, 1.0):
        vol = vol * scl_slope + scl_inter
    elif scl_inter not in (0.0,) and scl_slope == 1.0:
        vol = vol + scl_inter
    return vol, tuple(float(p) for p in pixdim)


def write_nifti(
    volume: np.ndarray,
    pixdim: Tuple[float, ...] = (1.0, 0.662, 0.662, 1.0),
    gzipped: bool = True,
) -> bytes:
    """Encode a volume as NIfTI-1 bytes (.nii or .nii.gz)."""
    vol = np.asarray(volume)
    code = _CODES.get(vol.dtype)
    if code is None:
        vol = vol.astype(np.int16)
        code = _CODES[np.dtype(np.int16)]
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [vol.ndim] + list(vol.shape) + [1] * (7 - vol.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)  # bitpix
    pd = list(pixdim) + [0.0] * (8 - len(pixdim))
    struct.pack_into("<8f", hdr, 76, *pd[:8])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00\x00\x00\x00" + vol.tobytes(order="F")
    if gzipped:
        return gzip.compress(payload)
    return payload
