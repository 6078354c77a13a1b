"""Host milliseconds a step in ``train/data.py``: the host clock around
``next(stream)`` of ``device_batches`` (the draws, a block of 64 steps'
threefry on the host every 64 steps, and the gather, flips and mosaic
queued on the card)."""


def read(ctx):
    spans = ctx["spans"]
    n = spans.count("bench.train.data")
    if not n:
        return None
    return spans.seconds("bench.train.data") / n * 1e3
