// Even-odd point-in-polygon containment on Hopper (sm_90a).
//
// Replaces the TPU kernel `_pip_kernel`, launched by
// `points_in_polys_pallas` (eitx/mesh/pallas_pip.py:37-97): Q points
// against C closed polygons of P vertices each, giving a (Q, C) byte
// matrix of crossing-count parities. Edge k of polygon c runs from vertex k
// to vertex (k + 1) mod P. Like the TPU kernel, it never forms the
// (Q, C, P) crossing tensor in device memory.
//
// Bound on an H100: operations, not bytes. The function is Q * C * P
// (point, edge) tests of 7 fp32 operations each (y - y1, a product, a
// division, an addition and three comparisons) plus 3 per edge that do not
// depend on the point (x2 - x1, y2 - y1, dy == 0); inputs and output
// together are under 2 MB at the main path's shape (Q 32768, C 32, P 512).
// That is 3.8e9 operations, 0.056 ms at the card's 67 TFLOP/s fp32 peak.
// The peak counts a fused multiply-add as two operations and none of the
// seven may fuse here (see Rounding), so no exact kernel issues them in
// less than twice that on input where every edge is live.
//
// What the design does about it: it does not run the tests that cannot
// count. The caller pads to fixed shapes (polygons far outside the scene,
// the last vertex repeated), so on the main path under 3 % of the edges
// have y1 != y2, and an edge with y1 == y2 straddles no point at all:
// (y1 > y) != (y2 > y) is false for every y, -0.0 and 0.0 included. And a
// warp's points are samples of neighbouring triangles, a few pixels apart,
// so that few of the live edges pass their level at all.
//
//   1. Prologue, two small kernels of one block per polygon.
//      `pip_count_kernel` counts each polygon's live edges (y2 != y1);
//      `pip_fill_kernel` sums the counts of the polygons before its own and
//      writes its live edges as 16-byte records (y1, y2, x1, dx = x2 - x1),
//      polygon after polygon, with C + 1 offsets. What belongs to the edge
//      alone is computed here once; with dead edges gone, dy == 0 cannot
//      occur.
//   2. `pip_main_kernel`: a block takes 32 * PPT points; each of its warps
//      holds all of them, PPT per lane, in registers, and a share of the
//      edges; the warps' parities meet in shared memory. PPT is 1: 2 and 4
//      points per lane were slower on both inputs at Q 32768 (PERF.md).
//      The record list is walked in groups of 32 records whatever polygons
//      they belong to, and read straight from global memory through the
//      read-only cache (`__ldg`): lane g loads record g of a group to look
//      at its reach, and a record that has to be tested is one load that
//      every lane shares. The list is not staged through shared memory: two
//      stages of 8 KB filled by `cp.async` were no faster (PERF.md has both
//      times).
//      Each point keeps the parities of 32 polygons as bits of one
//      register (C > 32 is a loop of passes); a row goes out as 16-byte
//      stores (byte stores where C is not a multiple of 16).
//      Splitting the edges over the warps of a block, not only the points
//      over blocks, is what fills the card: 32768 points are 1024 warps of
//      one point per lane, under eight per SM.
//   3. Only exact rejections, all by comparisons alone.
//      - Reach. Lane g looks at record g of the group: an edge with both
//        ends above the warp's greatest y, or both at or below its least
//        (`!(y1 > lo) && !(y2 > lo)`), straddles none of the warp's points.
//        One vote gives the group's records in reach. On the main path that
//        is a few of the 32, often none.
//      - Few in reach (`test_sparse`): they are tested one by one, the four
//        rounded operations of the crossing only behind `__any_sync` of the
//        lanes' straddle bits.
//      - Many in reach (`test_dense`, the dense case): first the straddle
//        bits of all 32 records by the two comparisons, free of branches,
//        one 8-byte load each that every lane shares; then every lane
//        works off its own bits, so that the crossing runs
//        max-over-lanes(straddling edges) times per group, not 32 times.
//        `pip_fill_kernel` deals a polygon's edges out over its groups in
//        turn, because a point straddles runs of neighbouring edges and
//        the maximum over the lanes sets the pace.
//      There is no rejection by x: the rounded crossing may leave
//      [min(x1, x2), max(x1, x2)] by an ulp.
//
// Rounding: the crossing must round exactly as the plain PyTorch version
// (eitx_torch/mesh/pip.py: points_in_polys_ref), which computes
// (x2 - x1) * (y - y1) / (y2 - y1) + x1 as separately rounded IEEE
// operations. nvcc contracts a * b + c into a fused multiply-add by
// default, so every operation is written with its round-to-nearest
// intrinsic, which the compiler never contracts. Never build this file
// with --use_fast_math.
//
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a; chip_smoke.py prints them from its
// own build): pip_main_kernel<1> 32 registers, 260 B shared memory;
// pip_fill_kernel 32 registers, 32 B; pip_count_kernel 29 registers, 0 B;
// no spills in any of them.
//
// tests/torch_pip_variants.py times this file built with other tuning
// constants and with parts cut out; PERF.md holds its numbers.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads of a main-kernel block
constexpr int kWarps = kThreads / 32;
constexpr int kPPT = 1;      // points per thread
constexpr int kGroup = 32;   // records of a group, one per lane: at most 32
constexpr int kSparse = 8;   // a group with at most this many records in
                             // reach is tested record by record
constexpr int kPrologueThreads = 256;
constexpr int kPrologueWarps = kPrologueThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kThreads >= 64,
              "a block is whole warps and loads 33 offsets at once");
static_assert(kGroup >= 1 && kGroup <= 32, "a group has one record per lane");

// The second and the third kernel of a call are launched so that each may
// start while the one before it still runs (programmatic dependent launch):
// `let_next_start` in a kernel lets the next one's blocks take their places,
// and `wait_for_previous` holds the next one until the kernel before it has
// ended and its writes can be seen. The main kernel loads its points first
// and waits then.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_overlapped(void (*kernel)(Params...), int blocks,
                              int threads, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
}

__device__ __forceinline__ int next_vertex(int k, int P) {
  return k + 1 == P ? 0 : k + 1;
}

// Prologue, first kernel. One block per polygon: its number of live edges
// (y2 != y1).
__global__ void __launch_bounds__(kPrologueThreads)
pip_count_kernel(const float2* __restrict__ polys, int* __restrict__ counts,
                 int P) {
  let_next_start();
  const float2* poly = polys + static_cast<int64_t>(blockIdx.x) * P;
  int n = 0;
  for (int k0 = 0; k0 < P; k0 += kPrologueThreads) {
    const int k = k0 + threadIdx.x;
    const bool live = k < P && poly[next_vertex(k, P)].y != poly[k].y;
    n += __syncthreads_count(live);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

// Prologue, second kernel. One block per polygon: its offset in the record
// list (the live edges of the polygons before it) and its own live edges as
// records (y1, y2, x1, dx = x2 - x1). The main kernel tests records in
// groups of kGroup neighbours in the list, and a point straddles runs of
// neighbouring edges; so the n live edges are dealt out over
// ceil(n / kGroup) groups in turn, live edge r going to group r % groups,
// which evens out the lanes' numbers of crossings per group. The order of a
// polygon's records is free: parity is a sum modulo 2.
__global__ void __launch_bounds__(kPrologueThreads)
pip_fill_kernel(const float2* __restrict__ polys,
                const int* __restrict__ counts, float4* __restrict__ records,
                int* __restrict__ offsets, int C, int P) {
  __shared__ int s_warp[kPrologueWarps];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float2* poly = polys + static_cast<int64_t>(c) * P;
  let_next_start();
  wait_for_previous();

  int before = 0;
  for (int i = threadIdx.x; i < c; i += kPrologueThreads) before += counts[i];
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(kFull, before, o);
  if (lane == 0) s_warp[warp] = before;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < kPrologueWarps; ++w) base += s_warp[w];
  __syncthreads();
  const int n = counts[c];
  if (threadIdx.x == 0) {
    offsets[c] = base;
    if (c == C - 1) offsets[C] = base + n;
  }
  // group j holds n / groups records, the first n % groups one more
  const int groups = max(1, (n + kGroup - 1) / kGroup);
  const int least = n / groups, longer = n % groups;

  int seen = 0;  // live edges before this round of the loop
  for (int k0 = 0; k0 < P; k0 += kPrologueThreads) {
    const int k = k0 + threadIdx.x;
    bool live = false;
    float4 rec = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < P) {
      const float2 a = poly[k];
      const float2 b = poly[next_vertex(k, P)];
      live = b.y != a.y;
      rec = make_float4(a.y, b.y, a.x, __fsub_rn(b.x, a.x));
    }
    const unsigned votes = __ballot_sync(kFull, live);
    if (lane == 0) s_warp[warp] = __popc(votes);
    __syncthreads();
    int rank = seen + __popc(votes & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < kPrologueWarps; ++w) {
      if (w < warp) rank += s_warp[w];
      total += s_warp[w];
    }
    if (live) {
      const int j = rank % groups;
      records[base + j * least + min(j, longer) + rank / groups] = rec;
    }
    seen += total;
    __syncthreads();
  }
}

// four parity bits -> four bytes of 0 or 1 (the products' bits do not meet)
__device__ __forceinline__ uint32_t spread4(uint32_t bits) {
  return ((bits & 0xfu) * 0x00204081u) & 0x01010101u;
}

// x < the crossing of the edge r = (y1, y2, x1, dx) with the level y; dy is
// never 0, the edge being live. Four separately rounded operations.
__device__ __forceinline__ bool left_of_crossing(float x, float y, float4 r) {
  return x < __fadd_rn(__fdiv_rn(__fmul_rn(r.w, __fsub_rn(y, r.x)),
                                 __fsub_rn(r.y, r.x)),
                       r.z);
}

// A warp's points in the lanes, PPT each, with the least and the greatest of
// their y (NaN passed over): no edge wholly above `hi` or wholly at or
// below `lo` straddles any of them. Bit c of `par` is the point's parity
// against polygon c of the pass.
template <int PPT>
struct WarpPoints {
  float x[PPT], y[PPT];
  float lo, hi;
  uint32_t par[PPT];
};

// The records of a group that are in the warp's reach, one by one: few of
// them, as where the warp's points lie close together. The crossing runs
// only where a lane straddles. Lane g holds record g's polygon in `poly`.
template <int PPT>
__device__ __forceinline__ void test_sparse(const float4* __restrict__ rec,
                                            int poly, uint32_t reach,
                                            WarpPoints<PPT>& w) {
  while (reach != 0u) {
    const int g = __ffs(reach) - 1;
    reach &= reach - 1u;
    const float4 r = __ldg(rec + g);  // every lane loads the same
    bool straddles[PPT], any = false;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      straddles[p] = (r.x > w.y[p]) != (r.y > w.y[p]);
      any |= straddles[p];
    }
    if (__any_sync(kFull, any)) {
      const int bit = __shfl_sync(kFull, poly, g);
#pragma unroll
      for (int p = 0; p < PPT; ++p)
        w.par[p] ^= static_cast<uint32_t>(straddles[p] &&
                                          left_of_crossing(w.x[p], w.y[p], r))
                    << bit;
    }
  }
}

// All `count` records of a group. First the straddle bits of the whole
// group, free of branches (record g ends in bit count - 1 - g of `hits`);
// then, while any lane of the warp has a bit left,
// every lane takes its lowest one and computes that crossing (a lane with
// none left computes on rec[0] and drops the result). The rounded
// operations so run max-over-lanes(straddling edges) times per group, not
// once per edge.
template <int PPT, bool kWhole>
__device__ __forceinline__ void test_dense(const float4* __restrict__ rec,
                                           int poly, int count,
                                           WarpPoints<PPT>& w) {
  uint32_t hits[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) hits[p] = 0u;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    if (kWhole || g < count) {
      // y1, y2: one 8-byte load that every lane shares
      const float2 y12 = __ldg(reinterpret_cast<const float2*>(rec + g));
#pragma unroll
      for (int p = 0; p < PPT; ++p)
        hits[p] = (hits[p] << 1) | static_cast<uint32_t>(
                                       (y12.x > w.y[p]) != (y12.y > w.y[p]));
    }
  }
  const int last = (kWhole ? kGroup : count) - 1;
  uint32_t left = 0u;
#pragma unroll
  for (int p = 0; p < PPT; ++p) left |= hits[p];
  while (__any_sync(kFull, left != 0u)) {
    left = 0u;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const bool valid = hits[p] != 0u;
      const int g = valid ? last - (__ffs(hits[p]) - 1) : 0;
      hits[p] &= hits[p] - 1u;  // 0 stays 0
      left |= hits[p];
      const int bit = __shfl_sync(kFull, poly, g);
      w.par[p] ^= static_cast<uint32_t>(
                      valid && left_of_crossing(w.x[p], w.y[p], __ldg(rec + g)))
                  << bit;
    }
  }
}

// One group: records `first`.. of the list, `count` of them. Lane g first
// looks at record g alone: is it in the warp's reach? Where any is, lane g
// finds record g's polygon, the greatest c with off[c] <= its index, by
// bisection in the pass's 33 offsets (those past the last polygon hold
// INT_MAX). Where few are in reach, only those are tested.
template <int PPT>
__device__ __forceinline__ void test_group(const float4* __restrict__ records,
                                           const int* off, int first,
                                           int count, int lane,
                                           WarpPoints<PPT>& w) {
  const float4* rec = records + first;
  bool in_reach = false;
  if (lane < count) {
    const float2 y12 = __ldg(reinterpret_cast<const float2*>(rec + lane));
    const bool above = y12.x > w.hi && y12.y > w.hi;
    const bool below = !(y12.x > w.lo) && !(y12.y > w.lo);
    in_reach = !(above || below);
  }
  const uint32_t reach = __ballot_sync(kFull, in_reach);
  if (reach == 0u) return;
  int poly = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (off[poly + step] <= first + lane) poly += step;
  if (__popc(reach) <= kSparse)
    test_sparse<PPT>(rec, poly, reach, w);
  else if (count == kGroup)
    test_dense<PPT, true>(rec, poly, kGroup, w);
  else
    test_dense<PPT, false>(rec, poly, count, w);
}

// A block takes 32 * PPT points; each of its warps holds all of them (PPT
// per lane) and takes every kWarps-th group of kGroup records, whatever
// polygons they belong to; the warps' parities meet in shared memory.
template <int PPT>
__global__ void __launch_bounds__(kThreads)
pip_main_kernel(const float2* __restrict__ pts,
                const float4* __restrict__ records,
                const int* __restrict__ offsets, uint8_t* __restrict__ out,
                int Q, int C) {
  static_assert(PPT <= kWarps, "one thread writes one point's row");
  __shared__ int s_off[33];
  __shared__ uint32_t s_par[32 * PPT];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t q_block = static_cast<int64_t>(blockIdx.x) * (32 * PPT);
  WarpPoints<PPT> w;
  w.lo = INFINITY;
  w.hi = -INFINITY;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int64_t q = q_block + p * 32 + lane;
    // a point past the end straddles nothing
    const float2 pt = q < Q ? pts[q] : make_float2(0.0f, NAN);
    w.x[p] = pt.x;
    w.y[p] = pt.y;
    w.lo = fminf(w.lo, pt.y);  // fminf and fmaxf pass over a NaN
    w.hi = fmaxf(w.hi, pt.y);
  }
  for (int o = 16; o > 0; o >>= 1) {
    w.lo = fminf(w.lo, __shfl_xor_sync(kFull, w.lo, o));
    w.hi = fmaxf(w.hi, __shfl_xor_sync(kFull, w.hi, o));
  }

  wait_for_previous();  // the record list is the prologue's
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int ncols = min(32, C - c0);
    if (threadIdx.x <= 32)
      s_off[threadIdx.x] =
          threadIdx.x <= ncols ? offsets[c0 + threadIdx.x] : INT_MAX;
    if (threadIdx.x < 32 * PPT) s_par[threadIdx.x] = 0u;
    __syncthreads();
    const int e_begin = s_off[0], e_end = s_off[ncols];
#pragma unroll
    for (int p = 0; p < PPT; ++p) w.par[p] = 0u;

    for (int i = e_begin + warp * kGroup; i < e_end; i += kWarps * kGroup)
      test_group<PPT>(records, s_off, i, min(kGroup, e_end - i), lane, w);

#pragma unroll
    for (int p = 0; p < PPT; ++p)
      if (w.par[p] != 0u) atomicXor(&s_par[p * 32 + lane], w.par[p]);
    __syncthreads();
    const int64_t q = q_block + threadIdx.x;
    if (threadIdx.x < 32 * PPT && q < Q) {
      const uint32_t bits = s_par[threadIdx.x];
      uint8_t* row = out + q * C + c0;
      if (C % 16 == 0) {  // rows start on 16 bytes, ncols is 16 or 32
        for (int j = 0; j < ncols; j += 16)
          *reinterpret_cast<uint4*>(row + j) = make_uint4(
              spread4(bits >> j), spread4(bits >> (j + 4)),
              spread4(bits >> (j + 8)), spread4(bits >> (j + 12)));
      } else {
        for (int j = 0; j < ncols; ++j)
          row[j] = static_cast<uint8_t>((bits >> j) & 1u);
      }
    }
    __syncthreads();  // before the next pass rewrites s_off and s_par
  }
}

int launch_prologue(const void* polys, void* records, void* offsets,
                    void* counts, int C, int P, cudaStream_t stream) {
  pip_count_kernel<<<C, kPrologueThreads, 0, stream>>>(
      static_cast<const float2*>(polys), static_cast<int*>(counts), P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_overlapped(pip_fill_kernel, C, kPrologueThreads, stream, polys,
                          counts, records, offsets, C, P);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// The prologue alone: `records` (C * P, 4) f32 and `offsets` (C + 1) i32
// receive the live-edge list; `counts` (C) i32 is scratch.
extern "C" int eitx_pip_edges(const void* polys, void* records, void* offsets,
                              void* counts, int C, int P, void* stream) {
  return launch_prologue(polys, records, offsets, counts, C, P,
                         static_cast<cudaStream_t>(stream));
}

// Prologue and main kernel on `stream`; scratch as for eitx_pip_edges.
// Returns the first CUDA error of a launch, or 0.
extern "C" int eitx_pip(const void* pts, const void* polys, void* out,
                        void* records, void* offsets, void* counts, int Q,
                        int C, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_prologue(polys, records, offsets, counts, C, P, s);
  if (err != 0) return err;
  constexpr int kPerBlock = 32 * kPPT;
  const cudaError_t launched = launch_overlapped(
      pip_main_kernel<kPPT>, (Q + kPerBlock - 1) / kPerBlock, kThreads, s, pts,
      records, offsets, out, Q, C);
  return static_cast<int>(launched != cudaSuccess ? launched
                                                  : cudaGetLastError());
}
