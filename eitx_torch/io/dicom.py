"""Minimal DICOM reader/writer (pydicom replacement for this pipeline).

Supports the transfer syntaxes CT exports actually use uncompressed:
  - Implicit VR Little Endian (1.2.840.10008.1.2)
  - Explicit VR Little Endian (1.2.840.10008.1.2.1)
and the tags the pipeline needs (SURVEY component 3/5): SeriesInstanceUID,
InstanceNumber, PatientPosition, ImageOrientationPatient,
PatientOrientation, RescaleIntercept/Slope, PixelSpacing, Rows, Columns,
BitsAllocated, PixelRepresentation, SamplesPerPixel, PixelData. Sequences
are skipped structurally (items parsed to find their ends). Compressed
pixel data raises IngestError.

The writer emits Explicit VR LE files — used by the dataset scripts and
as the test fixture generator.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Optional, Tuple, Union

import numpy as np

from ..core.errors import IngestError

Tag = Tuple[int, int]

# Tags we decode into python values.
TAG_SPECIFIC_CHARSET = (0x0008, 0x0005)
TAG_SOP_CLASS = (0x0008, 0x0016)
TAG_SOP_INSTANCE = (0x0008, 0x0018)
TAG_SERIES_UID = (0x0020, 0x000E)
TAG_INSTANCE_NUMBER = (0x0020, 0x0013)
TAG_PATIENT_POSITION = (0x0018, 0x5100)
TAG_IMAGE_ORIENTATION = (0x0020, 0x0037)
TAG_PATIENT_ORIENTATION = (0x0020, 0x0020)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_BITS_STORED = (0x0028, 0x0101)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_SAMPLES_PER_PIXEL = (0x0028, 0x0002)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)

IMPLICIT_LE = "1.2.840.10008.1.2"
EXPLICIT_LE = "1.2.840.10008.1.2.1"

# VRs with the 4-byte length form in explicit encoding.
_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"}

# VR assignments for the tags the writer emits.
_VR_FOR_TAG: Dict[Tag, bytes] = {
    TAG_SPECIFIC_CHARSET: b"CS",
    TAG_SOP_CLASS: b"UI",
    TAG_SOP_INSTANCE: b"UI",
    TAG_SERIES_UID: b"UI",
    TAG_INSTANCE_NUMBER: b"IS",
    TAG_PATIENT_POSITION: b"CS",
    TAG_IMAGE_ORIENTATION: b"DS",
    TAG_PATIENT_ORIENTATION: b"CS",
    TAG_PIXEL_SPACING: b"DS",
    TAG_ROWS: b"US",
    TAG_COLS: b"US",
    TAG_BITS_ALLOCATED: b"US",
    TAG_BITS_STORED: b"US",
    TAG_PIXEL_REPRESENTATION: b"US",
    TAG_SAMPLES_PER_PIXEL: b"US",
    TAG_RESCALE_INTERCEPT: b"DS",
    TAG_RESCALE_SLOPE: b"DS",
}

_STRING_VRS = {b"AE", b"AS", b"CS", b"DA", b"DS", b"DT", b"IS", b"LO", b"LT",
               b"PN", b"SH", b"ST", b"TM", b"UI", b"UC", b"UR", b"UT"}


@dataclass
class DicomDataset:
    """Parsed dataset: raw elements + typed accessors the pipeline uses."""

    elements: Dict[Tag, bytes] = field(default_factory=dict)
    vrs: Dict[Tag, bytes] = field(default_factory=dict)
    transfer_syntax: str = EXPLICIT_LE

    def _text(self, tag: Tag) -> Optional[str]:
        raw = self.elements.get(tag)
        if raw is None:
            return None
        return raw.decode("ascii", errors="replace").strip("\x00 ").strip()

    def _multi(self, tag: Tag):
        t = self._text(tag)
        return None if t is None else [s.strip() for s in t.split("\\")]

    def _ushort(self, tag: Tag) -> Optional[int]:
        raw = self.elements.get(tag)
        if raw is None or len(raw) < 2:
            return None
        return struct.unpack("<H", raw[:2])[0]

    # --- pipeline accessors -------------------------------------------------
    @property
    def series_instance_uid(self) -> Optional[str]:
        return self._text(TAG_SERIES_UID)

    # pydicom-compatible attribute aliases (used by orchestration code)
    @property
    def SeriesInstanceUID(self):  # noqa: N802
        return self.series_instance_uid

    @property
    def instance_number(self) -> int:
        t = self._text(TAG_INSTANCE_NUMBER)
        return int(t) if t else 0

    @property
    def InstanceNumber(self):  # noqa: N802
        return self.instance_number

    @property
    def patient_position(self) -> Optional[str]:
        return self._text(TAG_PATIENT_POSITION)

    @property
    def image_orientation(self):
        m = self._multi(TAG_IMAGE_ORIENTATION)
        return None if m is None else [float(x) for x in m]

    @property
    def patient_orientation(self):
        return self._multi(TAG_PATIENT_ORIENTATION)

    @property
    def pixel_spacing(self):
        m = self._multi(TAG_PIXEL_SPACING)
        return None if m is None else [float(x) for x in m]

    @property
    def rescale_intercept(self) -> float:
        t = self._text(TAG_RESCALE_INTERCEPT)
        return float(t) if t else 0.0

    @property
    def rescale_slope(self) -> float:
        t = self._text(TAG_RESCALE_SLOPE)
        return float(t) if t else 1.0

    @property
    def rows(self) -> int:
        return self._ushort(TAG_ROWS) or 0

    @property
    def cols(self) -> int:
        return self._ushort(TAG_COLS) or 0

    @property
    def pixel_array(self) -> np.ndarray:
        raw = self.elements.get(TAG_PIXEL_DATA)
        if raw is None:
            raise IngestError("no PixelData element")
        bits = self._ushort(TAG_BITS_ALLOCATED) or 16
        signed = (self._ushort(TAG_PIXEL_REPRESENTATION) or 0) == 1
        samples = self._ushort(TAG_SAMPLES_PER_PIXEL) or 1
        if bits == 16:
            dtype = np.int16 if signed else np.uint16
        elif bits == 8:
            dtype = np.int8 if signed else np.uint8
        else:
            raise IngestError(f"unsupported BitsAllocated {bits}")
        arr = np.frombuffer(raw, dtype=dtype)
        r, c = self.rows, self.cols
        need = r * c * samples
        if arr.size < need:
            raise IngestError(
                f"PixelData too short: {arr.size} < {need} (compressed?)"
            )
        arr = arr[:need]
        if samples == 1:
            return arr.reshape(r, c)
        return arr.reshape(r, c, samples)


def _parse_elements(buf: bytes, pos: int, explicit: bool, stop_at_group=None):
    """Yield (tag, vr, value_bytes) until buffer end or group change."""
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        if stop_at_group is not None and group != stop_at_group:
            return pos
        pos += 4
        vr = b""
        if explicit:
            vr = buf[pos : pos + 2]
            pos += 2
            if vr in _LONG_VRS:
                pos += 2  # reserved
                (length,) = struct.unpack_from("<I", buf, pos)
                pos += 4
            else:
                (length,) = struct.unpack_from("<H", buf, pos)
                pos += 2
        else:
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4

        if vr == b"SQ" or length == 0xFFFFFFFF:
            pos = _skip_sequence(buf, pos, length)
            yield (group, elem), vr, b""
            continue
        value = buf[pos : pos + length]
        pos += length
        yield (group, elem), vr, value
    return pos


def _skip_sequence(buf: bytes, pos: int, length: int) -> int:
    """Skip a sequence value (defined or undefined length)."""
    if length != 0xFFFFFFFF:
        return pos + length
    # undefined: walk items until SequenceDelimitationItem (FFFE,E0DD)
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        (ilen,) = struct.unpack_from("<I", buf, pos + 4)
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            return pos
        if (group, elem) == (0xFFFE, 0xE000):
            if ilen == 0xFFFFFFFF:
                # undefined-length item: scan to ItemDelimitationItem
                while pos + 8 <= n:
                    g2, e2 = struct.unpack_from("<HH", buf, pos)
                    (l2,) = struct.unpack_from("<I", buf, pos + 4)
                    pos += 8
                    if (g2, e2) == (0xFFFE, 0xE00D):
                        break
                    pos += 0 if l2 == 0xFFFFFFFF else l2
            else:
                pos += ilen
        else:
            pos += 0 if ilen == 0xFFFFFFFF else ilen
    return pos


def read_dicom(data: Union[bytes, BinaryIO]) -> DicomDataset:
    """Parse a DICOM Part-10 file (or raw dataset without preamble)."""
    if hasattr(data, "read"):
        data = data.read()
    buf = bytes(data)
    ds = DicomDataset()
    pos = 0
    transfer = EXPLICIT_LE
    if len(buf) > 132 and buf[128:132] == b"DICM":
        pos = 132
        # file meta group (0002) is always explicit VR LE
        gen = _parse_elements(buf, pos, explicit=True, stop_at_group=0x0002)
        try:
            while True:
                tag, vr, value = next(gen)
                if tag == TAG_TRANSFER_SYNTAX:
                    transfer = value.decode("ascii").strip("\x00 ").strip()
        except StopIteration as si:
            pos = si.value if si.value is not None else pos
    if transfer not in (IMPLICIT_LE, EXPLICIT_LE):
        raise IngestError(f"unsupported transfer syntax {transfer}")
    ds.transfer_syntax = transfer
    explicit = transfer == EXPLICIT_LE
    gen = _parse_elements(buf, pos, explicit=explicit)
    try:
        while True:
            tag, vr, value = next(gen)
            ds.elements[tag] = value
            if vr:
                ds.vrs[tag] = vr
    except StopIteration:
        pass
    if TAG_ROWS not in ds.elements:
        raise IngestError("not a DICOM image dataset (no Rows)")
    return ds


def _encode_element(tag: Tag, vr: bytes, value: bytes) -> bytes:
    head = struct.pack("<HH", tag[0], tag[1])
    if vr in _LONG_VRS:
        return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + vr + struct.pack("<H", len(value)) + value


def _pad(value: bytes, pad_byte: bytes = b" ") -> bytes:
    return value + pad_byte if len(value) % 2 else value


def write_dicom(
    pixel_array: np.ndarray,
    series_uid: str = "1.2.826.0.1.3680043.2.1",
    instance_number: int = 1,
    patient_position: str = "HFS",
    image_orientation=(1, 0, 0, 0, 1, 0),
    patient_orientation=("L", "P"),
    pixel_spacing=(0.753906, 0.753906),
    rescale_intercept: float = -1024.0,
    rescale_slope: float = 1.0,
) -> bytes:
    """Encode an int16 image as an Explicit VR LE DICOM file."""
    arr = np.asarray(pixel_array)
    if arr.dtype not in (np.int16, np.uint16):
        arr = arr.astype(np.int16)
    rows, cols = arr.shape

    def ds_str(x) -> bytes:
        return _pad(str(x).encode("ascii"))

    body = b""
    items = [
        (TAG_SOP_CLASS, _pad(b"1.2.840.10008.5.1.4.1.1.2", b"\x00")),
        (TAG_SOP_INSTANCE, _pad(f"{series_uid}.{instance_number}".encode(), b"\x00")),
        (TAG_PATIENT_ORIENTATION, _pad("\\".join(patient_orientation).encode())),
        (TAG_PATIENT_POSITION, _pad(patient_position.encode())),
        (TAG_SERIES_UID, _pad(series_uid.encode(), b"\x00")),
        (TAG_INSTANCE_NUMBER, ds_str(instance_number)),
        (TAG_IMAGE_ORIENTATION, _pad("\\".join(str(v) for v in image_orientation).encode())),
        (TAG_SAMPLES_PER_PIXEL, struct.pack("<H", 1)),
        (TAG_ROWS, struct.pack("<H", rows)),
        (TAG_COLS, struct.pack("<H", cols)),
        (TAG_PIXEL_SPACING, _pad("\\".join(str(v) for v in pixel_spacing).encode())),
        (TAG_BITS_ALLOCATED, struct.pack("<H", 16)),
        (TAG_BITS_STORED, struct.pack("<H", 16)),
        (TAG_PIXEL_REPRESENTATION, struct.pack("<H", 1 if arr.dtype == np.int16 else 0)),
        (TAG_RESCALE_INTERCEPT, ds_str(rescale_intercept)),
        (TAG_RESCALE_SLOPE, ds_str(rescale_slope)),
    ]
    items.sort(key=lambda kv: kv[0])
    for tag, value in items:
        body += _encode_element(tag, _VR_FOR_TAG[tag], value)
    pix = arr.astype("<i2" if arr.dtype == np.int16 else "<u2").tobytes()
    body += _encode_element(TAG_PIXEL_DATA, b"OW", _pad(pix, b"\x00"))

    # file meta
    meta_elems = b""
    meta_elems += _encode_element(
        (0x0002, 0x0002), b"UI", _pad(b"1.2.840.10008.5.1.4.1.1.2", b"\x00")
    )
    meta_elems += _encode_element(
        (0x0002, 0x0003),
        b"UI",
        _pad(f"{series_uid}.{instance_number}".encode(), b"\x00"),
    )
    meta_elems += _encode_element(
        (0x0002, 0x0010), b"UI", _pad(EXPLICIT_LE.encode(), b"\x00")
    )
    meta = _encode_element((0x0002, 0x0000), b"UL", struct.pack("<I", len(meta_elems)))
    meta += meta_elems
    return b"\x00" * 128 + b"DICM" + meta + body
