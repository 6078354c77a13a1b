"""Host milliseconds a subject in ``fem/forward.py``'s preparation: mesh
dict to ``MeshInfo``, node compaction and electrode placement (host
clock around the program's ``prepare_mesh_info``, ``compact_mesh_nodes``
and ``_electrodes``)."""


def read(ctx):
    n = ctx["layer"].get("subjects", 0)
    if not n or not ctx["spans"].count("bench.fem.prep"):
        return None
    return ctx["spans"].seconds("bench.fem.prep") / n * 1e3
