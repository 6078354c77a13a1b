// External-contour extraction: 8-connected component labeling +
// Moore-neighbour boundary tracing (Jacob's stopping criterion).
//
// Native twin of eitx/contours/trace.py (which replaces the reference's
// OpenCV findContours(RETR_EXTERNAL), utils.py:572,1173,1246): components
// are labeled in raster-scan discovery order (scipy.ndimage.label
// ordering), each component's topmost-then-leftmost pixel seeds a
// clockwise Moore walk, and the walk stops when the state (pixel,
// backtrack direction) after a move repeats the state after the very
// first move. Output points are (x, y), closing duplicate dropped —
// bit-identical to the Python tracer (tests/test_contours.py pins this).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -o libeitxcontours.so contours.cpp

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// Moore neighbourhood in clockwise order starting from W (dx, dy).
const int MOORE_DX[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
const int MOORE_DY[8] = {0, -1, -1, -1, 0, 1, 1, 1};

struct DSU {
    std::vector<int32_t> parent;
    explicit DSU(size_t n) : parent(n) {
        for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
    }
    int32_t find(int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    }
    void unite(int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a != b) parent[b < a ? a : b] = (b < a ? b : a);
    }
};

}  // namespace

extern "C" {

// Returns the number of contours written, or -1 if a capacity was
// exceeded (caller falls back to the Python tracer).
//   mask:      h*w uint8 (nonzero = foreground)
//   out_xy:    capacity cap_pts pairs, filled with x,y per point
//   starts:    capacity max_contours+1, point offsets per contour
int eitx_trace_external_contours(
    const uint8_t* mask, int h, int w, int min_pixels,
    int64_t* out_xy, int64_t cap_pts,
    int64_t* starts, int max_contours) {
    const int64_t n = static_cast<int64_t>(h) * w;
    // --- pass 1: union-find over 8-connected foreground ---------------
    std::vector<int32_t> lab(n, -1);
    DSU dsu(static_cast<size_t>(n));
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const int64_t i = static_cast<int64_t>(y) * w + x;
            if (!mask[i]) continue;
            lab[i] = static_cast<int32_t>(i);
            // connect to already-visited neighbours (W, NW, N, NE)
            if (x > 0 && mask[i - 1]) dsu.unite((int32_t)i, (int32_t)(i - 1));
            if (y > 0) {
                const int64_t up = i - w;
                if (x > 0 && mask[up - 1])
                    dsu.unite((int32_t)i, (int32_t)(up - 1));
                if (mask[up]) dsu.unite((int32_t)i, (int32_t)up);
                if (x < w - 1 && mask[up + 1])
                    dsu.unite((int32_t)i, (int32_t)(up + 1));
            }
        }
    }
    // --- relabel by raster discovery order + stats ---------------------
    std::vector<int32_t> comp_of(n, -1);  // meaningful at root pixels only
    std::vector<int64_t> count;
    std::vector<int64_t> seed;  // first pixel in raster order = topmost/left
    for (int64_t i = 0; i < n; ++i) {
        if (lab[i] < 0) continue;
        const int32_t root = dsu.find((int32_t)i);
        if (comp_of[root] < 0) {
            comp_of[root] = static_cast<int32_t>(count.size());
            count.push_back(0);
            seed.push_back(i);
        }
        count[comp_of[root]] += 1;
    }
    const int n_comp = static_cast<int32_t>(count.size());
    if (n_comp > max_contours) return -1;
    // --- pass 2: Moore trace per component ----------------------------
    int64_t pt = 0;
    int out_c = 0;
    for (int c = 0; c < n_comp; ++c) {
        if (count[c] < min_pixels) continue;
        const int64_t s = seed[c];
        const int sx = static_cast<int>(s % w);
        const int sy = static_cast<int>(s / w);
        starts[out_c] = pt;
        if (pt + 1 > cap_pts) return -1;
        out_xy[2 * pt] = sx;
        out_xy[2 * pt + 1] = sy;
        ++pt;
        int cx = sx, cy = sy, b = 0;
        int s0x = -1, s0y = -1, s0b = -1;
        const int64_t max_len = 4 * n;
        int64_t steps = 0;
        while (true) {
            int found_d = -1, nx = 0, ny = 0;
            for (int k = 1; k <= 8; ++k) {
                const int d = (b + k) & 7;
                const int tx = cx + MOORE_DX[d];
                const int ty = cy + MOORE_DY[d];
                if (tx < 0 || tx >= w || ty < 0 || ty >= h) continue;
                const int64_t ti = static_cast<int64_t>(ty) * w + tx;
                if (lab[ti] >= 0 &&
                    comp_of[dsu.find((int32_t)ti)] == c) {
                    found_d = d;
                    nx = tx;
                    ny = ty;
                    break;
                }
            }
            if (found_d < 0) break;  // isolated pixel
            const int nb = (found_d + 4) & 7;
            if (s0x < 0) {
                s0x = nx;
                s0y = ny;
                s0b = nb;
            } else if (nx == s0x && ny == s0y && nb == s0b) {
                break;  // loop closed: same pixel entered the same way
            }
            cx = nx;
            cy = ny;
            b = nb;
            if (pt + 1 > cap_pts) return -1;
            out_xy[2 * pt] = cx;
            out_xy[2 * pt + 1] = cy;
            ++pt;
            if (++steps > max_len) return -1;  // runaway guard
        }
        // drop a closing duplicate of the start point
        const int64_t first = starts[out_c];
        if (pt - first > 1 && out_xy[2 * (pt - 1)] == out_xy[2 * first] &&
            out_xy[2 * (pt - 1) + 1] == out_xy[2 * first + 1]) {
            --pt;
        }
        ++out_c;
    }
    starts[out_c] = pt;
    return out_c;
}

}  // extern "C"
