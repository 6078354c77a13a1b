"""Plain-PyTorch reference of YOLO12's training step: the network written
from ultralytics' ``yolo12-seg.yaml`` and arXiv:2502.12524 with
functional operations (``model.py``), on the frozen training step of
``reference/yolo`` (``trainer.py``). It imports nothing of eitx_torch and
takes nothing it made: the caller hands it the same initial parameters
and sample store as the program."""
