// Even-odd point-in-polygon containment on Hopper (sm_90a).
//
// Replaces the TPU kernel `_pip_kernel`, launched by
// `points_in_polys_pallas` (eitx/mesh/pallas_pip.py:37-97): Q points
// against C closed polygons of P vertices each, giving a (Q, C) byte
// matrix of crossing-count parities. Edge k of polygon c runs from vertex k
// to vertex (k + 1) mod P. Like the TPU kernel, it never forms the
// (Q, C, P) crossing tensor in device memory.
//
// Bound on an H100: the work is Q * C * P (point, edge) tests of 7 fp32
// operations each (y - y1, a product, a division, an addition and three
// comparisons), plus 3 per edge (x2 - x1, y2 - y1, dy == 0) that do not
// depend on the point. Inputs and output together are under 2 MB at the
// main path's shape (Q 32768, C 32, P 512), so the kernel is bound by
// operations, not bytes: ~5.4e8 tests, ~3.8e9 operations, 0.056 ms at the
// card's 67 TFLOP/s fp32 peak. This kernel recomputes the per-edge terms
// in every thread.
//
// Design: one thread per point and one block row per polygon
// (grid = (ceil(Q / 128), C)), so the launch has thousands of blocks and
// every thread writes exactly one output byte. Each block stages its
// polygon's vertices through shared memory in tiles of 512 vertices
// (4 KB), plus the first vertex of the next tile, so edge k always finds
// vertex k + 1 in the tile. The parity accumulates in a register.
//
// Rounding: the crossing test must round exactly as the plain PyTorch
// version (eitx_torch/mesh/pip.py: points_in_polys_ref), which computes
// (x2 - x1) * (y - y1) / dy + x1 as separately rounded IEEE operations.
// nvcc contracts a*b+c into a fused multiply-add by default, so every
// operation is written with its round-to-nearest intrinsic, which the
// compiler never contracts. Never build this file with --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;

__global__ void pip_kernel(const float* __restrict__ pts,
                           const float* __restrict__ polys,
                           uint8_t* __restrict__ out,
                           int Q, int C, int P) {
  __shared__ float sx[kTile + 1];
  __shared__ float sy[kTile + 1];

  const int c = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool live = q < Q;
  const float x = live ? pts[2 * q] : 0.0f;
  const float y = live ? pts[2 * q + 1] : 0.0f;
  const float* poly = polys + static_cast<int64_t>(c) * P * 2;

  unsigned parity = 0u;
  for (int k0 = 0; k0 < P; k0 += kTile) {
    const int n = min(kTile, P - k0);
    // vertices k0 .. k0 + n, the last one wrapping to vertex 0
    for (int i = threadIdx.x; i <= n; i += kThreads) {
      int k = k0 + i;
      if (k >= P) k -= P;
      sx[i] = poly[2 * k];
      sy[i] = poly[2 * k + 1];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float x1 = sx[i], y1 = sy[i];
      const float x2 = sx[i + 1], y2 = sy[i + 1];
      float dy = __fsub_rn(y2, y1);
      if (dy == 0.0f) dy = 1e-30f;
      const float xc = __fadd_rn(
          __fdiv_rn(__fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y, y1)), dy), x1);
      const bool straddles = (y1 > y) != (y2 > y);
      parity ^= static_cast<unsigned>(straddles && (x < xc));
    }
    __syncthreads();
  }
  if (live) out[static_cast<int64_t>(q) * C + c] = static_cast<uint8_t>(parity);
}

}  // namespace

extern "C" int eitx_pip(const float* pts, const float* polys, uint8_t* out,
                        int Q, int C, int P, void* stream) {
  dim3 grid((Q + kThreads - 1) / kThreads, C);
  pip_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, polys, out, Q, C, P);
  return static_cast<int>(cudaGetLastError());
}
