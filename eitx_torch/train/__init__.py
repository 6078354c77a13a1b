from .trainer import TrainConfig, Trainer, TrainState
from .data import device_batches, synthetic_ct_batch

__all__ = ["TrainConfig", "Trainer", "TrainState", "device_batches",
           "synthetic_ct_batch"]
