// The tile stepper of K1 (windowed.cu) and K3 (resident.cu), written for
// Hopper. K2, K7 and K9 keep the first stepper (gs_tile.cuh), whose per-cell
// naive code this one keeps for the cells on the domain's edge; the two
// agree bit for bit.
//
// What differs from gs_tile.cuh:
//
//   - Interior tiles. A tile whose whole window lies inside the domain steps
//     only cells in rows [1, rows-2] and columns [1, cols-2], where the naive
//     boundary's clamped window is the plain centred 3x3 one. Such a tile
//     runs without the per-cell domain test, the out-of-domain zeroing and
//     the clamp arithmetic: it adds a fixed term list at fixed offsets (the
//     role of `specialize` in grayscott_tpu/ops/megakernel.py:217-269). The
//     decision is made once a tile, uniformly across the block. Edge tiles
//     test each cell: outside the domain it is 0.0; in the domain's first or
//     last row or column of the naive boundary it runs gs_tile.cuh's
//     per-cell code (naive_laplacian); elsewhere it takes the fixed list.
//   - The term lists. Naive: every tap of nonzero weight and the centre
//     term w * (x - x) even when the centre weight is 0, in row-major order,
//     exactly the terms naive_laplacian adds when no tap is clamped; so an
//     interior cell equals the clamped form bit for bit, NaN and Inf
//     included. Zero: every tap of nonzero weight, as zero_laplacian.
//   - The tap set is a template parameter (TAPS: bit t set iff weight t is
//     nonzero), so a cell-step tests no weight at run time. The host picks
//     the instantiation from the weights (tap_mask); the three zero patterns
//     of the shipped stencils have their own, and any other pattern runs
//     TAPS_ANY, which tests each weight at run time as gs_tile.cuh does.
//   - Register strips. A thread steps a vertical strip of R cells of one
//     column and keeps a rolling 3-row window of each species in registers:
//     a new output row costs 3 shared loads a species (its left, centre and
//     right), not 9. The terms keep the oracle's row-major order; registers
//     change where a value comes from, not the order in which it is added.
//   - Windows load with cp.async (load_window): 16-byte copies where the
//     row pitch and the pointers are 16-byte aligned and the chunk lies in
//     the domain, 4-byte copies (or __ldcg, for a kernel that reads what
//     other blocks wrote in the same launch) at a ragged edge and wherever
//     the pitch is not aligned, and 0.0 stored directly outside the domain.
//     16-byte copies are cp.async.cg: cached in L2 only, like __ldcg.
//
// Numerics: the expressions of gs_tile.cuh, built with -fmad=false and
// without -ftz, so every kernel equals the plain PyTorch step
// (grayscott_tpu_torch/ops/stencil.py) bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "gs_tile.cuh"

namespace gs {
namespace sm90 {

// Tap sets (bit t: weight t, row-major, is nonzero).
constexpr int TAPS_RING = 0x1EF;   // 8 taps, no centre: oono-puri and
                                   // patra-karttunen
constexpr int TAPS_ALL = 0x1FF;    // 9 taps: pretty
constexpr int TAPS_CROSS = 0x0AA;  // 4 taps, no centre: 5points
constexpr int TAPS_ANY = -1;       // any other set: tested at run time

// The tap set of the weights, as the kernels' `w == 0.0f` skip reads them.
inline int tap_mask(const Constants& k) {
  int mask = 0;
  for (int t = 0; t < 9; ++t) {
    if (k.w[t] != 0.0f) mask |= 1 << t;
  }
  return mask;
}

template <int TAPS>
__device__ __forceinline__ bool has_tap(const Constants& k, int t) {
  if (TAPS == TAPS_ANY) return k.w[t] != 0.0f;
  return (TAPS >> t) & 1;
}

// The laplacian of an interior cell from its 3x3 neighbourhood, rows top,
// mid (mid[1] is the cell) and bot: the naive or the zero term list.
template <int TAPS, bool NAIVE>
__device__ __forceinline__ float fixed_laplacian(const float (&top)[3],
                                                 const float (&mid)[3],
                                                 const float (&bot)[3],
                                                 const Constants& k) {
  const float x = mid[1];
  float full = 0.0f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float n = t < 3 ? top[t] : (t < 6 ? mid[t - 3] : bot[t - 6]);
    if ((NAIVE && t == 4) || has_tap<TAPS>(k, t)) {
      full = full + k.w[t] * (n - x);
    }
  }
  return full;
}

// The reaction and the Euler update (gs_tile.cuh: step_tile_at).
__device__ __forceinline__ void react(float uc, float vc, float full_u,
                                      float full_v, const Constants& k,
                                      float* un, float* vn) {
  const float uv_square = (uc * vc) * vc;
  const float du = ((k.du * full_u) - uv_square) + (k.feed * (1.0f - uc));
  const float dv = ((k.dv * full_v) + uv_square) + (k.min_feed_kill * vc);
  *un = uc + du * k.dt;
  *vn = vc + dv * k.dt;
}

// One cell in the domain's first or last row or column on the naive
// boundary: gs_tile.cuh's per-cell code (the clamped window). Window cell
// (lr, lc) lies at global (gr, gc).
template <int PITCH>
__device__ __forceinline__ void naive_edge_cell(const float* su,
                                                const float* sv, int lr,
                                                int lc, int gr, int gc,
                                                int rows, int cols,
                                                const Constants& k, float* un,
                                                float* vn) {
  const float uc = su[lr * PITCH + lc], vc = sv[lr * PITCH + lc];
  react(uc, vc,
        naive_laplacian<PITCH>(su, lr, lc, uc, gr, gc, rows, cols, k),
        naive_laplacian<PITCH>(sv, lr, lc, vc, gr, gc, rows, cols, k), k,
        un, vn);
}

// Where a strip lies in the domain, for the per-cell tests of an edge tile:
// its first cell's global row, its column, and the domain.
struct StripAt {
  int gr0, gc, rows, cols;
};

// One strip: cells (lr0 + i, lc), i < n <= R, of a window with row pitch
// PITCH in shared memory (su, sv), each of whose taps lies in the window.
// Hands each cell's new values to sink(i, un, vn).
//
// EDGE = false (an interior tile): every cell takes the fixed term list.
// EDGE = true: a cell outside the domain comes out as exactly 0.0; on the
// naive boundary a cell in the domain's first or last row or column takes
// gs_tile.cuh's clamped form (naive_edge_cell); every other cell takes the
// fixed list, which equals the per-cell code there (on the zero boundary the
// window's cells outside the domain hold 0.0, as zero_laplacian reads them).
template <int TAPS, bool NAIVE, int R, int PITCH, bool EDGE, typename Sink>
__device__ __forceinline__ void step_strip(const float* su, const float* sv,
                                           int lr0, int lc, int n,
                                           const StripAt& at,
                                           const Constants& k, Sink&& sink) {
  const float* pu = su + (lr0 - 1) * PITCH + lc;
  const float* pv = sv + (lr0 - 1) * PITCH + lc;
  float u0[3] = {pu[-1], pu[0], pu[1]};
  float v0[3] = {pv[-1], pv[0], pv[1]};
  float u1[3] = {pu[PITCH - 1], pu[PITCH], pu[PITCH + 1]};
  float v1[3] = {pv[PITCH - 1], pv[PITCH], pv[PITCH + 1]};
  const bool col_inside = at.gc >= 0 && at.gc < at.cols;
  const bool edge_col = at.gc == 0 || at.gc == at.cols - 1;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < n) {
      const float* qu = pu + (i + 2) * PITCH;
      const float* qv = pv + (i + 2) * PITCH;
      const float u2[3] = {qu[-1], qu[0], qu[1]};
      const float v2[3] = {qv[-1], qv[0], qv[1]};
      float un, vn;
      react(u1[1], v1[1], fixed_laplacian<TAPS, NAIVE>(u0, u1, u2, k),
            fixed_laplacian<TAPS, NAIVE>(v0, v1, v2, k), k, &un, &vn);
      if (EDGE) {
        const int gr = at.gr0 + i;
        if (!col_inside || gr < 0 || gr >= at.rows) {
          un = 0.0f;
          vn = 0.0f;
        } else if (NAIVE && (edge_col || gr == 0 || gr == at.rows - 1)) {
          naive_edge_cell<PITCH>(su, sv, lr0 + i, lc, gr, at.gc, at.rows,
                                 at.cols, k, &un, &vn);
        }
      }
      sink(i, un, vn);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        u0[j] = u1[j];
        u1[j] = u2[j];
        v0[j] = v1[j];
        v1[j] = v2[j];
      }
    }
  }
}

// --- asynchronous window loads ----------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start loading the WR x (4 * NCH) block of U and V whose cell (0, 0) lies at
// global (gr0, gc0), gc0 a multiple of 4, into su and sv (row pitch PITCH,
// 16-byte aligned); cells outside the domain as 0.0. `aligned`: cols is a
// multiple of 4 and u, v are 16-byte aligned. COHERENT: the block may read
// what other blocks wrote earlier in the same launch, so no copy may go
// through L1 (4-byte cp.async is .ca only): the ragged cells load with
// __ldcg instead. The copies land after cp_async_commit() and
// cp_async_wait(), and are visible to the block after a __syncthreads().
template <int WR, int NCH, int PITCH, int NT, bool COHERENT>
__device__ __forceinline__ void load_window(const float* u, const float* v,
                                            float* su, float* sv, int gr0,
                                            int gc0, int rows, int cols,
                                            bool aligned) {
  for (int idx = threadIdx.x; idx < WR * NCH; idx += NT) {
    const int lr = idx / NCH, q = idx - lr * NCH;
    const int gr = gr0 + lr, gc = gc0 + 4 * q;
    float* du = su + lr * PITCH + 4 * q;
    float* dv = sv + lr * PITCH + 4 * q;
    if (gr < 0 || gr >= rows || gc + 3 < 0 || gc >= cols) {
      *reinterpret_cast<float4*>(du) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(dv) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const size_t g = static_cast<size_t>(gr) * cols + gc;
    if (aligned && gc >= 0 && gc + 4 <= cols) {
      cp_async16(du, u + g);
      cp_async16(dv, v + g);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (gc + e < 0 || gc + e >= cols) {
        du[e] = 0.0f;
        dv[e] = 0.0f;
      } else if (COHERENT) {
        du[e] = __ldcg(u + g + e);
        dv[e] = __ldcg(v + g + e);
      } else {
        cp_async4(du + e, u + g + e);
        cp_async4(dv + e, v + g + e);
      }
    }
  }
}

// --- host side --------------------------------------------------------------

// Whether a window may load with 16-byte copies: rows of `cols` floats and
// every state pointer 16-byte aligned.
inline bool rows_aligned(int cols, const void* a, const void* b,
                         const void* c, const void* d) {
  auto ok = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  return cols % 4 == 0 && ok(a) && ok(b) && ok(c) && ok(d);
}

// Launch::run<TAPS>(args...) for the instantiation of the weights' tap
// set.
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_taps(const Constants& k, Args&&... args) {
  switch (tap_mask(k)) {
    case TAPS_RING:
      return Launch<TAPS_RING>::run(args...);
    case TAPS_ALL:
      return Launch<TAPS_ALL>::run(args...);
    case TAPS_CROSS:
      return Launch<TAPS_CROSS>::run(args...);
    default:
      return Launch<TAPS_ANY>::run(args...);
  }
}

}  // namespace sm90
}  // namespace gs
