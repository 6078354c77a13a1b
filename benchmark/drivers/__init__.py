"""One driver a kind of configuration (``kind`` in its file): set-up, the
window's call, the spans of the traced run and the comparison."""
