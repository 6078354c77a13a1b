"""Typed error taxonomy.

The reference swallows every exception behind bare ``except`` + emoji logs
(e.g. utils.py:68-69, ai_tools.py:229-230 in the reference tree), hiding latent
NameErrors. Here every failure raises a typed error; the serve layer converts
them to HTTP status codes.
"""


class EitxError(Exception):
    """Base class for all framework errors."""


class IngestError(EitxError):
    """Malformed or unsupported input data (zip, DICOM, NIfTI, image)."""


class SliceSelectionError(EitxError):
    """Rib detection / slice selection could not produce a slice index."""


class SegmentationError(EitxError):
    """Model inference failure or empty segmentation output."""


class ContourError(EitxError):
    """Mask -> polygon extraction failure."""


class MeshingError(EitxError):
    """Triangulation or element classification failure."""


class SimulationError(EitxError):
    """FEM forward solve failure."""


class ModelError(EitxError):
    """Model construction / weight loading failure."""


class ConfigError(EitxError):
    """Invalid configuration value."""
