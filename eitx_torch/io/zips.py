"""Zip-archive ingest: DICOM series grouping, NIfTI and image extraction.

Parity with create_dicom_dict (utils.py:26-70): read every non-.txt entry
as DICOM, group by SeriesInstanceUID, keep the largest series; an optional
custom_input.txt carries a manual slice offset. NIfTI extraction mirrors
get_nii_mean_slice (utils.py:1062-1119) including the 90-degrees-clockwise
rotation and pixdim[1:3] spacing.
"""

from __future__ import annotations

import io
import logging
import zipfile
from collections import defaultdict
from typing import BinaryIO, List, Optional, Tuple, Union

import numpy as np

from ..core.errors import IngestError
from .dicom import DicomDataset, read_dicom
from .images import decode_image
from .nifti import read_nifti

logger = logging.getLogger("eitx_torch.io")


def _open_zip(zip_data: Union[bytes, BinaryIO, zipfile.ZipFile]) -> zipfile.ZipFile:
    if isinstance(zip_data, zipfile.ZipFile):
        return zip_data
    try:
        return zipfile.ZipFile(zip_data if hasattr(zip_data, "read") else
                               io.BytesIO(zip_data))
    except zipfile.BadZipFile as e:
        raise IngestError("uploaded file is not a valid ZIP archive") from e


def largest_series_from_zip(
    zip_data,
) -> Tuple[List[DicomDataset], int]:
    """(slices of the largest series, custom slice offset)."""
    zf = _open_zip(zip_data)
    custom_input: Optional[int] = None
    series = defaultdict(list)
    if "custom_input.txt" in zf.namelist():
        with zf.open("custom_input.txt") as f:
            try:
                custom_input = int(f.read().decode("utf-8").strip())
            except ValueError:
                custom_input = 0
    for name in zf.namelist():
        low = name.lower()
        if low.endswith("/") or low.endswith(".txt"):
            continue
        try:
            with zf.open(name) as f:
                ds = read_dicom(f.read())
            series[ds.series_instance_uid].append(ds)
        except Exception as e:
            logger.warning("skipping %s: %s", name, e)
            continue
    if not series:
        raise IngestError("no readable DICOM files in archive")
    largest = max(series.values(), key=len)
    return largest, int(custom_input or 0)


def extract_nifti_middle_slice(zip_data) -> Tuple[np.ndarray, List[float]]:
    """First .nii.gz/.nii in the archive -> (middle axial slice rotated 90
    degrees clockwise, [dx, dy] spacing)."""
    zf = _open_zip(zip_data)
    pixel_spacing = [0.662, 0.662]
    for name in zf.namelist():
        low = name.lower()
        if (low.endswith(".nii.gz") and not low.endswith(".tar.gz")) or low.endswith(".nii"):
            with zf.open(name) as f:
                vol, pixdim = read_nifti(f.read())
            if len(pixdim) >= 3 and pixdim[1] > 0 and pixdim[2] > 0:
                pixel_spacing = [float(pixdim[1]), float(pixdim[2])]
            mid = int(vol.shape[-1] / 2)
            sl = np.asarray(vol[:, :, mid], dtype=np.int16)
            # cv2.ROTATE_90_CLOCKWISE == transpose + fliplr
            sl = np.fliplr(sl.T)
            return sl, pixel_spacing
    raise IngestError("no NIfTI file in archive")


def extract_first_image(zip_data) -> np.ndarray:
    """First file in the archive decoded as an image
    (uploadImageAxialSlice contract, main_kt_service.py:96-114)."""
    zf = _open_zip(zip_data)
    names = [n for n in zf.namelist() if not n.endswith("/")]
    if not names:
        raise IngestError("ZIP archive is empty")
    with zf.open(names[0]) as f:
        return decode_image(f.read())
