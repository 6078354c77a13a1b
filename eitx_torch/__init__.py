"""eitx_torch — the PyTorch/CUDA port of eitx (CT slice -> EIT dataset).

A package beside ``eitx`` with the same layout. It imports neither JAX
nor anything of ``eitx``. Entry points take ``device`` (default
``"cuda"``); the CPU runs only when a caller asks for it.
"""

from .core.config import PipelineConfig
from .pipeline import Pipeline

__all__ = ["Pipeline", "PipelineConfig"]
