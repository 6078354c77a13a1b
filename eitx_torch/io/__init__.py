from .dicom import DicomDataset, read_dicom, write_dicom
from .nifti import read_nifti, write_nifti
from .images import decode_image, encode_png_base64, to_png_bytes
from .zips import (
    extract_first_image,
    extract_nifti_middle_slice,
    largest_series_from_zip,
)

__all__ = [
    "DicomDataset",
    "read_dicom",
    "write_dicom",
    "read_nifti",
    "write_nifti",
    "decode_image",
    "encode_png_base64",
    "to_png_bytes",
    "extract_first_image",
    "extract_nifti_middle_slice",
    "largest_series_from_zip",
]
