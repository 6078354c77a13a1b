"""JSON answer contract (create_answer parity, utils.py:1019-1059)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..io.images import encode_png_base64


def build_answer(
    grid_image: np.ndarray,
    text_data="",
    segmentation_time: float = 0.0,
    saved_file_name: Optional[str] = None,
    simulation_time: float = 0.0,
) -> dict:
    """The exact response dict the reference's endpoints return: a base64
    PNG of the stage grid (BGR source converted to RGB), the contour text
    block, and the two headline timings."""
    return {
        "image": encode_png_base64(np.asarray(grid_image)),
        "text_data": text_data,
        "segmentation_time": segmentation_time,
        "saved_file_name": saved_file_name,
        "simulation_time": simulation_time,
        "status": "success",
        "message": "Processing completed successfully",
    }
