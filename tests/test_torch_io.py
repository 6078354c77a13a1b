"""Container formats of the port against eitx: DICOM, NIfTI and zip
ingest. The port's readers and writers are copies, so bytes and arrays
must be equal, each must read what the other wrote, and garbage must raise
the port's ``IngestError``."""

import io
import zipfile

import numpy as np
import pytest

from eitx import io as ref
from eitx.core.errors import IngestError as RefIngestError
from eitx_torch import io as port
from eitx_torch.core.errors import IngestError


def _pixels(seed=0, shape=(48, 40), dtype=np.int16):
    rng = np.random.default_rng(seed)
    return rng.integers(0 if dtype == np.uint16 else -50, 3000,
                        shape).astype(dtype)


DICOM_CASES = {
    "defaults": {},
    "ffs": dict(series_uid="1.2.3.4", instance_number=7,
                patient_position="FFS", pixel_spacing=(0.7, 0.8),
                rescale_intercept=-1000, rescale_slope=2),
    "flipped": dict(image_orientation=(-1, 0, 0, 0, -1, 0),
                    patient_orientation=("R", "A"), instance_number=123),
}


@pytest.mark.parametrize("dtype", [np.int16, np.uint16])
@pytest.mark.parametrize("case", list(DICOM_CASES))
def test_dicom_bytes_equal_and_read_both_ways(case, dtype):
    px = _pixels(1, dtype=dtype)
    kw = DICOM_CASES[case]
    blob = port.write_dicom(px, **kw)
    assert blob == ref.write_dicom(px, **kw)
    a, b = port.read_dicom(blob), ref.read_dicom(blob)
    assert np.array_equal(a.pixel_array, px)
    assert a.pixel_array.dtype == b.pixel_array.dtype == dtype
    for field in ("series_instance_uid", "instance_number",
                  "patient_position", "image_orientation",
                  "patient_orientation", "pixel_spacing",
                  "rescale_intercept", "rescale_slope", "rows", "cols"):
        assert getattr(a, field) == getattr(b, field), field


def test_dicom_reads_a_file_object():
    blob = port.write_dicom(_pixels(2))
    assert np.array_equal(port.read_dicom(io.BytesIO(blob)).pixel_array,
                          _pixels(2))


@pytest.mark.parametrize("dtype,gz", [(np.int16, True), (np.int16, False),
                                      (np.float32, True), (np.uint8, False)])
def test_nifti_bytes_equal_and_read_both_ways(dtype, gz):
    vol = _pixels(3, (20, 24, 5), np.int16).astype(dtype)
    pixdim = (1.0, 0.7, 0.9, 2.5)
    blob = port.write_nifti(vol, pixdim=pixdim, gzipped=gz)
    if not gz:  # gzip stamps the time of writing into its header
        assert blob == ref.write_nifti(vol, pixdim=pixdim, gzipped=gz)
    (a, pa), (b, pb) = port.read_nifti(blob), ref.read_nifti(blob)
    assert a.shape == (20, 24, 5) and pa == pb
    assert np.array_equal(a, b) and np.array_equal(a.astype(dtype), vol)
    c, pc = port.read_nifti(ref.write_nifti(vol, pixdim=pixdim, gzipped=gz))
    assert np.array_equal(c, a) and pc == pa


def _zip_of(entries):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, data in entries:
            zf.writestr(name, data)
    return buf.getvalue()


def _series_entries(custom=None):
    entries = [(f"a/s{i}.dcm", port.write_dicom(
        _pixels(i), series_uid="1.1", instance_number=5 - i))
        for i in range(5)]
    entries += [(f"b/s{i}.dcm", port.write_dicom(
        _pixels(10 + i), series_uid="2.2", instance_number=i + 1))
        for i in range(3)]
    entries.append(("a/readme.txt", b"not a dicom"))
    entries.append(("junk.bin", b"\x01\x02" * 40))
    if custom is not None:
        entries.append(("custom_input.txt", custom))
    return entries


@pytest.mark.parametrize("custom,offset", [(None, 0), (b" 3\n", 3),
                                           (b"-2", -2), (b"three", 0),
                                           (b"", 0)])
def test_largest_series_choice_and_offset(custom, offset):
    data = _zip_of(_series_entries(custom))
    got, got_off = port.largest_series_from_zip(data)
    want, want_off = ref.largest_series_from_zip(data)
    assert got_off == want_off == offset
    assert [d.series_instance_uid for d in got] == ["1.1"] * 5
    assert [d.instance_number for d in got] == \
        [d.instance_number for d in want]
    for a, b in zip(got, want):
        assert np.array_equal(a.pixel_array, b.pixel_array)


def test_zip_inputs_of_every_kind():
    data = _zip_of(_series_entries())
    for given in (data, io.BytesIO(data), zipfile.ZipFile(io.BytesIO(data))):
        assert len(port.largest_series_from_zip(given)[0]) == 5


@pytest.mark.parametrize("name", ["scan.nii.gz", "deep/dir/scan.nii"])
def test_nifti_middle_slice_equal(name):
    vol = _pixels(4, (20, 24, 7))
    blob = port.write_nifti(vol, pixdim=(1.0, 0.7, 0.9, 2.5),
                            gzipped=name.endswith(".gz"))
    data = _zip_of([("notes.txt", b"x"), (name, blob)])
    sl, spacing = port.extract_nifti_middle_slice(data)
    want, want_spacing = ref.extract_nifti_middle_slice(data)
    assert sl.dtype == np.int16 and sl.shape == (24, 20)
    assert np.array_equal(sl, want) and spacing == want_spacing
    assert np.array_equal(sl, np.fliplr(vol[:, :, 3].T))  # 90 deg clockwise


def test_first_image_equal():
    img = np.random.default_rng(5).integers(0, 255, (32, 24)).astype(np.uint8)
    data = _zip_of([("slice.png", port.to_png_bytes(img)),
                    ("other.png", port.to_png_bytes(img[::-1]))])
    got = port.extract_first_image(data)
    assert np.array_equal(got, img)
    assert np.array_equal(got, ref.extract_first_image(data))


@pytest.mark.parametrize("call,data", [
    (port.read_dicom, b"not a dicom file at all" * 10),
    (port.read_nifti, b"\x00" * 400),
    (port.largest_series_from_zip, b"no zip"),
    (port.largest_series_from_zip, _zip_of([("a.txt", b"x")])),
    (port.largest_series_from_zip, _zip_of([("a.dcm", b"garbage" * 30)])),
    (port.extract_nifti_middle_slice, _zip_of([("a.dcm", b"x")])),
    (port.extract_first_image, _zip_of([])),
    (port.extract_first_image, _zip_of([("a.png", b"not an image")])),
], ids=["dicom", "nifti", "not-a-zip", "only-text", "no-readable-dicom",
        "no-nifti", "empty-zip", "bad-image"])
def test_garbage_raises_ingest_error(call, data):
    with pytest.raises(IngestError) as err:
        call(data)
    assert not isinstance(err.value, RefIngestError)  # the port's own type
