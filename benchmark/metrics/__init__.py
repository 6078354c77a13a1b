"""One reader a per-layer metric, ``<metric name>.py`` with ``read(ctx)``.

``ctx`` holds ``trace`` (``lib.trace.Trace``), ``spans`` (``lib.spans.Spans``),
``window_s`` (the traced window's host seconds, ended by a device
synchronisation), ``steps`` (calls in it), ``work`` (subjects or images),
``peaks`` ((bf16, f32, bytes/s) or None) and ``layer`` (the driver's own
counts). A reader that finds nothing to read returns None, and the metric
is left out of the result line.
"""
