"""The benchmark of eitx_torch: cells, configurations, traffic and
per-layer metric readers, found by name (see README.md)."""
