"""Milliseconds a step in which the card is busy (the union of its kernel
and copy intervals in the traced steps, over the steps): the work of
``train/trainer.py`` and ``models/yolo/``."""


def read(ctx):
    busy = ctx["trace"].busy_us()
    if busy <= 0 or not ctx["steps"]:
        return None
    return busy / ctx["steps"] / 1e3
