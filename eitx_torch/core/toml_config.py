"""TOML configuration loading (copy of eitx/core/toml_config.py).

The reference keeps a TOML twin of its Python config
(ai_fsi_config.toml); here TOML files map onto the typed config tree so
deployments can override any numeric without code edits:

    [image]
    window_level = 40
    [sim]
    n_points = 100
    frequency_hz = 50000
    [model]
    ribs_weights = "/app/weights/ribs.pt"
"""

from __future__ import annotations

import dataclasses
import tomllib
from typing import Any, Dict

from .config import (
    ClassMap,
    ImageConfig,
    MeshConfig,
    ModelConfig,
    PipelineConfig,
    SimulationConfig,
)

_SECTIONS = {
    "image": ImageConfig,
    "model": ModelConfig,
    "mesh": MeshConfig,
    "sim": SimulationConfig,
    "classes": ClassMap,
}


def _build(section_cls, values: Dict[str, Any]):
    valid = {f.name for f in dataclasses.fields(section_cls)}
    unknown = set(values) - valid
    if unknown:
        raise ValueError(
            f"unknown keys for [{section_cls.__name__}]: {sorted(unknown)}"
        )
    return section_cls(**values)


def load_pipeline_config(path: str) -> PipelineConfig:
    with open(path, "rb") as fh:
        doc = tomllib.load(fh)
    kwargs: Dict[str, Any] = {}
    for name, cls in _SECTIONS.items():
        if name in doc:
            kwargs[name] = _build(cls, doc[name])
    top_fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    for key, value in doc.items():
        if key in _SECTIONS:
            continue
        if key not in top_fields:
            raise ValueError(f"unknown top-level config key: {key}")
        if key in ("default_pixel_spacing_image", "default_pixel_spacing_nii"):
            value = tuple(value)
        kwargs[key] = value
    return PipelineConfig(**kwargs)
