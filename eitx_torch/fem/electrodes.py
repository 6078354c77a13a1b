"""Boundary extraction and electrode placement on unstructured 2-D meshes.

Equivalent of pyeit's place_electrodes_equal_spacing as used by the
reference (model_generator.py:156-172): n electrodes equally spaced along
the mesh boundary perimeter, the first at the boundary node whose angle from
the mesh centroid is closest to ``starting_angle`` (180 degrees in the live
pipeline), walking the boundary loop in counter-clockwise orientation.

The boundary edges and the connectivity check are computed by numpy and
scipy with no Python loop over triangles (``boundary_loop``); Python walks
only the boundary loop itself.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.errors import MeshingError


def boundary_loop(
    tris: np.ndarray, nodes: np.ndarray = None
) -> np.ndarray:
    """Ordered closed loop of boundary node indices.

    Boundary edges are triangle edges referenced by exactly one element.
    Without ``nodes`` the boundary must be a single manifold loop (every
    boundary node has exactly two boundary neighbours) or MeshingError is
    raised. With ``nodes`` the walk is geometric and robust to real-world
    meshes (the patient-derived fixture, tests/test_realfixture.py):
    pinch (bowtie) nodes with 4+ boundary neighbours are traversed by an
    outer-face turn rule, and interior hole loops are ignored — the
    returned loop is the OUTER boundary, which is what electrode
    placement needs. Pinch nodes appear in the loop once per visit.

    Each edge is counted by one int64 key ``min * n + max`` (``n`` past the
    largest node index) in a 1-D ``np.unique``; the boundary keeps the
    edges' row order. The geometric walk first rejects a disconnected
    triangulation, counting the components of the triangles' node graph
    with scipy's compiled ``connected_components`` (triangles that share
    only a vertex are one component).
    """
    tris = np.asarray(tris)
    edges = np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0
    )
    if edges.shape[0] == 0:
        raise MeshingError("mesh has no boundary edges")
    n = np.int64(tris.max()) + 1
    lo = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64)
    hi = np.maximum(edges[:, 0], edges[:, 1]).astype(np.int64)
    _, inv, counts = np.unique(
        lo * n + hi, return_inverse=True, return_counts=True
    )
    boundary = edges[counts[inv] == 1]
    if boundary.shape[0] == 0:
        raise MeshingError("mesh has no boundary edges")
    # Undirected adjacency (element winding may be inconsistent, so
    # directed edges cannot be trusted).
    adj: dict = {}
    for a, b in boundary:
        adj.setdefault(int(a), []).append(int(b))
        adj.setdefault(int(b), []).append(int(a))
    manifold = all(len(n) == 2 for n in adj.values())
    if nodes is None:
        for node, nbrs in adj.items():
            if len(nbrs) != 2:
                raise MeshingError(
                    f"non-manifold boundary at node {node} "
                    f"({len(nbrs)} neighbours); pass nodes for the "
                    "geometric outer-loop walk"
                )
    if manifold and nodes is None:
        start = int(boundary[0, 0])
        loop = [start]
        prev, cur = None, start
        while True:
            a, b = adj[cur]
            nxt = b if a == prev else a
            if nxt == start:
                break
            loop.append(nxt)
            prev, cur = cur, nxt
            if len(loop) > len(adj):
                raise MeshingError(
                    "boundary walk did not close (non-manifold mesh)"
                )
        if len(loop) != len(adj):
            raise MeshingError(
                f"multiple boundary loops ({len(loop)} of {len(adj)} "
                "nodes walked)"
            )
        return np.array(loop, dtype=np.int64)

    # Reject disconnected triangulations outright: the outer-face walk
    # below would silently trace only the fragment holding the
    # bottommost node and electrodes would all land on one fragment
    # (the manifold path guards the same failure via its loop-coverage
    # check). Components of the graph joining each triangle's first node
    # to its other two, over the used nodes relabelled 0..k-1.
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    used, local = np.unique(tris, return_inverse=True)
    local = local.reshape(tris.shape)
    graph = coo_matrix(
        (
            np.ones(2 * local.shape[0]),
            (np.tile(local[:, 0], 2), local[:, 1:].T.ravel()),
        ),
        shape=(used.size, used.size),
    )
    n_components, _ = connected_components(graph, directed=False)
    if n_components > 1:
        raise MeshingError(
            f"mesh has {n_components} disconnected components; electrode "
            "placement needs a single connected triangulation"
        )

    # Geometric outer-face walk. Start at the bottommost (then leftmost)
    # boundary node — guaranteed to lie on the outer loop — heading to
    # the neighbour that keeps the interior on the left (CCW); at every
    # node pick the most-counterclockwise candidate relative to the
    # reversed incoming direction, which follows the outer face through
    # pinch nodes without crossing into it.
    pts = np.asarray(nodes, np.float64)
    bnodes = np.fromiter(adj.keys(), dtype=np.int64)
    bxy = pts[bnodes]
    start = int(bnodes[np.lexsort((bxy[:, 0], bxy[:, 1]))[0]])

    def turn_key(cur, prev_dir, cand):
        v = pts[cand] - pts[cur]
        # angle of v measured CCW from the reversed incoming direction;
        # smallest positive angle = sharpest left turn = outer face when
        # walking CCW with interior on the left
        a = math.atan2(v[1], v[0]) - math.atan2(-prev_dir[1], -prev_dir[0])
        return a % (2.0 * math.pi)

    # initial direction: fake incoming from straight below (heading +y),
    # valid because start is the bottommost node so the exterior is below
    first = min(
        set(adj[start]),
        key=lambda c: turn_key(start, np.array([0.0, 1.0]), c),
    )
    loop = [start]
    cur, prev = first, start
    first_edge = (start, first)
    guard = 4 * boundary.shape[0] + 8
    while (prev, cur) != first_edge or len(loop) == 1:
        loop.append(cur)
        prev_dir = pts[cur] - pts[prev]
        cands = [c for c in adj[cur] if c != prev] or [prev]
        nxt = min(cands, key=lambda c: turn_key(cur, prev_dir, c))
        prev, cur = cur, nxt
        if len(loop) > guard:
            raise MeshingError("outer boundary walk did not close")
    return np.array(loop[:-1] if loop[-1] == start else loop, dtype=np.int64)


def _orient_ccw(nodes: np.ndarray, loop: np.ndarray) -> np.ndarray:
    pts = nodes[loop]
    x, y = pts[:, 0], pts[:, 1]
    signed2 = float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return loop if signed2 > 0 else loop[::-1].copy()


def place_electrodes_equal_spacing(
    nodes: np.ndarray,
    tris: np.ndarray,
    n_electrodes: int = 16,
    starting_angle: float = math.pi,
    starting_offset: float = 0.0,
) -> np.ndarray:
    """Electrode node indices, equally spaced by arc length along the
    boundary, starting at the node closest to ``starting_angle`` (radians,
    measured from the centroid) plus ``starting_offset`` (fraction of the
    inter-electrode spacing)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    loop = _orient_ccw(nodes, boundary_loop(tris, nodes))
    pts = nodes[loop]
    centroid = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - centroid[1], pts[:, 0] - centroid[0])
    dang = np.abs(np.angle(np.exp(1j * (ang - starting_angle))))
    start_i = int(np.argmin(dang))
    loop = np.roll(loop, -start_i)
    pts = nodes[loop]

    seg = np.linalg.norm(np.diff(np.vstack([pts, pts[:1]]), axis=0), axis=1)
    arclen = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    perim = float(seg.sum())
    spacing = perim / n_electrodes
    targets = (np.arange(n_electrodes) + starting_offset) * spacing
    el_nodes = []
    for t in targets:
        i = int(np.argmin(np.abs(arclen - (t % perim))))
        el_nodes.append(int(loop[i]))
    if len(set(el_nodes)) != n_electrodes:
        raise MeshingError(
            "electrode placement collided (boundary too coarse for "
            f"{n_electrodes} electrodes; refine lc)"
        )
    return np.array(el_nodes, dtype=np.int32)


def electrode_coordinates(nodes: np.ndarray, el_pos: np.ndarray) -> np.ndarray:
    return np.asarray(nodes)[np.asarray(el_pos)]
