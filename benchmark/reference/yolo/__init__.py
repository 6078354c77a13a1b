"""Frozen plain-PyTorch reference of the training step: YOLOv11's network,
the trainer (TAL, the four losses, clip + AdamW, EMA) and the device batch
stream with its threefry draws, copied from eitx_torch as of commit
82a40b4 so that a later change to the program cannot move the yardstick.
It imports nothing of eitx_torch and takes nothing it made: the caller
hands it the same initial parameters and sample store as the program."""
