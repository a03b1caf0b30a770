// The tile stepper of K1 (windowed.cu), K2 (mega.cu), K3 (resident.cu), K7
// (sharded_mega.cu) and K9 (ilpsplit.cu), written for Hopper. The ablation
// part 0 of K2 and K9 keeps the first stepper (gs_tile.cuh), whose per-cell
// naive code this one keeps for the cells on the domain's edge; the two
// agree bit for bit. The packed stepper of K4, K5 and K6
// (gs_packed_sm90.cuh) reuses its window loads, geometries and interior
// test.
//
// What differs from gs_tile.cuh:
//
//   - Interior tiles. A tile whose whole window lies inside the domain steps
//     only cells in rows [1, rows-2] and columns [1, cols-2], where the naive
//     boundary's clamped window is the plain centred 3x3 one. Such a tile
//     runs without the per-cell domain test, the out-of-domain zeroing and
//     the clamp arithmetic: it adds a fixed term list at fixed offsets (the
//     role of `specialize` in grayscott_tpu/ops/megakernel.py:217-269). The
//     decision is made once a tile, uniformly across the block, in global
//     coordinates (so a shard seam is never a domain edge). Edge tiles
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
//     the pitch is not aligned, and 0.0 stored directly outside the domain
//     and where the buffer does not hold the cell (a shard's layout).
//     16-byte copies are cp.async.cg: cached in L2 only, like __ldcg.
//   - Windows of K halo cells (Geometry, step_window: K1's 64^2 tiles in
//     80^2 windows of dynamic shared memory), stepped K <= HALO times with
//     the valid region shrinking a cell a step; the megakernels walk their
//     tiles through one time block with the next window loading while the
//     finished tile is written out (time_block).
//   - K3's 32^2 tiles in 34^2 windows, one step a window (ring: load_tile,
//     step_tile), which the resident kernels K3 and K9 walk every step.
//   - bf16 storage (K1, K1's shard entry, K2, K7): the state's element type
//     T is a template parameter of the window load and of the store; the
//     windows and every step stay float32. A bf16 window loads through
//     registers, 16-byte loads of 8 cells (or one cell at a time at a
//     ragged edge), widened exactly on the way into shared memory:
//     cp.async has no 2-byte copy, and a staging buffer for the raw bytes
//     would cost the second block on each SM. The store rounds to nearest
//     even once (narrow: cvt.rn.bf16.f32, the instruction PyTorch's
//     .to(torch.bfloat16) runs on the card), so a launch of k <= HALO steps
//     rounds once, as grayscott_tpu/ops/pallas_stencil.py:970-993 does.
//
// Numerics: the expressions of gs_tile.cuh, built with -fmad=false and
// without -ftz, so every kernel equals the plain PyTorch step
// (grayscott_tpu_torch/ops/stencil.py) bit for bit.

#pragma once

#include <cuda_bf16.h>
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

// --- the state's element type -----------------------------------------------

using bf16 = __nv_bfloat16;

// Cells of one 16-byte copy of T.
template <typename T>
__host__ __device__ constexpr int vec_cells() {
  return 16 / static_cast<int>(sizeof(T));
}

// A state element rounded for the store: float32 as it is, bfloat16 to
// nearest even (NaN to the canonical quiet NaN), subnormals kept (no -ftz).
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// A load of one element through L2 only (coherent with what other blocks
// wrote before a barrier).
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 load_cg(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// 16 bytes of T: float4 for float32, 8 bfloat16 as a uint4.
template <typename T>
struct Vec16 {
  using type = float4;
};
template <>
struct Vec16<bf16> {
  using type = uint4;
};

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
// 16-byte aligned), from buffers laid out as `mem` says (gs_tile.cuh:
// FlatLayout, ShardLayout); cells outside the domain, and cells the buffer
// does not hold, as 0.0. `aligned`: the layout's rows and the u, v pointers
// are 16-byte aligned, and the layout's held columns start and end on
// multiples of 4. COHERENT: the block may read what other blocks wrote
// earlier in the same launch, so no copy may go through L1 (4-byte cp.async
// is .ca only): the ragged cells load with __ldcg instead. The copies land
// after cp_async_commit() and cp_async_wait(), and are visible to the block
// after a __syncthreads().
template <int WR, int NCH, int PITCH, int NT, bool COHERENT, typename Layout>
__device__ __forceinline__ void load_window(const Layout& mem, const float* u,
                                            const float* v, float* su,
                                            float* sv, int gr0, int gc0,
                                            int rows, int cols,
                                            bool aligned) {
  for (int idx = threadIdx.x; idx < WR * NCH; idx += NT) {
    const int lr = idx / NCH, q = idx - lr * NCH;
    const int gr = gr0 + lr, gc = gc0 + 4 * q;
    float* du = su + lr * PITCH + 4 * q;
    float* dv = sv + lr * PITCH + 4 * q;
    // (held columns are one interval of at least 4 cells)
    if (gr < 0 || gr >= rows || gc + 3 < 0 || gc >= cols ||
        (!mem.holds(gr, gc) && !mem.holds(gr, gc + 3))) {
      *reinterpret_cast<float4*>(du) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(dv) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    // (a row's cells are consecutive in both layouts: cell gc + e lies at
    // g + e)
    const size_t g = mem.at(gr, gc);
    if (aligned && gc >= 0 && gc + 4 <= cols && mem.holds(gr, gc) &&
        mem.holds(gr, gc + 3)) {
      cp_async16(du, u + g);
      cp_async16(dv, v + g);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (gc + e < 0 || gc + e >= cols || !mem.holds(gr, gc + e)) {
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

// The exact float32 values of the 8 bfloat16 cells of w (little-endian:
// cell 0 in the low half of w.x), stored at d (16-byte aligned).
__device__ __forceinline__ void widen8(float* d, uint4 w) {
  const unsigned hi = 0xffff0000u;
  reinterpret_cast<float4*>(d)[0] =
      make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & hi),
                  __uint_as_float(w.y << 16), __uint_as_float(w.y & hi));
  reinterpret_cast<float4*>(d)[1] =
      make_float4(__uint_as_float(w.z << 16), __uint_as_float(w.z & hi),
                  __uint_as_float(w.w << 16), __uint_as_float(w.w & hi));
}

template <bool COHERENT>
__device__ __forceinline__ uint4 load8(const bf16* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  return COHERENT ? __ldcg(q) : __ldg(q);
}

template <bool COHERENT>
__device__ __forceinline__ float load1(const bf16* p) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  const unsigned bits = COHERENT ? __ldcg(q) : __ldg(q);
  return __uint_as_float(bits << 16);
}

// load_window for bfloat16 storage, in chunks of 8 cells (NCH / 2 of them
// a row; gc0 a multiple of 8): each cell widened exactly to float32 on its
// way into the window. `aligned`: the layout's rows and the u, v pointers
// are 16-byte aligned, and the layout's held columns start and end on
// multiples of 8. The loads go through registers (there is no 2-byte
// cp.async): the window is in place, for the block, after the caller's
// __syncthreads(); the caller's cp.async commit and wait find no copy in
// flight. COHERENT: loads through L2 only (__ldcg), else through the
// read-only path (__ldg).
template <int WR, int NCH, int PITCH, int NT, bool COHERENT, typename Layout>
__device__ __forceinline__ void load_window(const Layout& mem, const bf16* u,
                                            const bf16* v, float* su,
                                            float* sv, int gr0, int gc0,
                                            int rows, int cols,
                                            bool aligned) {
  static_assert(NCH % 2 == 0, "8-cell chunks");
  constexpr int N8 = NCH / 2;
  for (int idx = threadIdx.x; idx < WR * N8; idx += NT) {
    const int lr = idx / N8, q = idx - lr * N8;
    const int gr = gr0 + lr, gc = gc0 + 8 * q;
    float* du = su + lr * PITCH + 8 * q;
    float* dv = sv + lr * PITCH + 8 * q;
    // (held columns are one interval, its ends multiples of 8)
    if (gr < 0 || gr >= rows || gc + 7 < 0 || gc >= cols ||
        (!mem.holds(gr, gc) && !mem.holds(gr, gc + 7))) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      reinterpret_cast<float4*>(du)[0] = z;
      reinterpret_cast<float4*>(du)[1] = z;
      reinterpret_cast<float4*>(dv)[0] = z;
      reinterpret_cast<float4*>(dv)[1] = z;
      continue;
    }
    const size_t g = mem.at(gr, gc);
    if (aligned && gc >= 0 && gc + 8 <= cols && mem.holds(gr, gc) &&
        mem.holds(gr, gc + 7)) {
      widen8(du, load8<COHERENT>(u + g));
      widen8(dv, load8<COHERENT>(v + g));
      continue;
    }
    // (not unrolled: unrolled, K7's zero-boundary instantiations spilled
    // at their 64 registers)
#pragma unroll 1
    for (int e = 0; e < 8; ++e) {
      if (gc + e < 0 || gc + e >= cols || !mem.holds(gr, gc + e)) {
        du[e] = 0.0f;
        dv[e] = 0.0f;
      } else {
        du[e] = load1<COHERENT>(u + g + e);
        dv[e] = load1<COHERENT>(v + g + e);
      }
    }
  }
}

// --- windows of HALO cells around a tile ------------------------------------

constexpr int HALO = 8;  // most steps a window takes (K1's K, K2's and K7's
                         // time block)

// Tile rows and columns, threads, strip length.
template <int TR_, int TC_, int NT_, int R_>
struct Geometry {
  static constexpr int TR = TR_, TC = TC_, NT = NT_, R = R_;
  static constexpr int WR = TR + 2 * HALO, WC = TC + 2 * HALO;
  static constexpr int CELLS = WR * WC;  // of one buffer of one species
  static constexpr size_t BYTES = 4 * sizeof(float) * CELLS;  // 2 buffers
  // blocks an SM: as many as the 227 KB of shared memory hold
  static constexpr int MIN_BLOCKS = BYTES <= 113 * 1024 ? 2 : 1;
  // blocks an SM at 64 registers a thread (the megakernels' bound: the
  // 64^2 tiles' two blocks, and four of the 32^2 tiles where, left at two,
  // ptxas takes up to 109 registers)
  static constexpr int BLOCKS_AT_64_REGS = 65536 / (64 * NT);
  static_assert(WC % 4 == 0 && HALO % 4 == 0, "16-byte window rows");
};

// K1's tile: 64^2 in an 80^2 window, 512 threads, strips of 4 (PERF.md §6).
using Main = Geometry<64, 64, 512, 4>;
// The former tile: 32^2 in a 48^2 window, 256 threads.
using Small = Geometry<32, 32, 256, 4>;

// One step of the window cells [lo, W - lo)^2, in strips of G::R cells,
// from (in_u, in_v) into (out_u, out_v); the window's cell (0, 0) lies at
// global (r0, c0) of the rows x cols domain. INTERIOR: the window lies
// inside the domain.
template <typename G, int TAPS, bool NAIVE, bool INTERIOR>
__device__ __forceinline__ void step_window(const float* in_u,
                                            const float* in_v, float* out_u,
                                            float* out_v, int lo, int r0,
                                            int c0, int rows, int cols,
                                            const Constants& k) {
  const int hi_r = G::WR - lo, ncols = G::WC - 2 * lo;
  const int items = ncols * ((hi_r - lo + G::R - 1) / G::R);
  for (int it = threadIdx.x; it < items; it += G::NT) {
    const int strip = it / ncols;
    const int lc = lo + (it - strip * ncols), lr0 = lo + strip * G::R;
    step_strip<TAPS, NAIVE, G::R, G::WC, !INTERIOR>(
        in_u, in_v, lr0, lc, min(G::R, hi_r - lr0),
        {r0 + lr0, c0 + lc, rows, cols}, k, [&](int i, float un, float vn) {
          out_u[(lr0 + i) * G::WC + lc] = un;
          out_v[(lr0 + i) * G::WC + lc] = vn;
        });
  }
}

// Whether the G window whose cell (0, 0) lies at global (r0, c0) lies inside
// the rows x cols domain.
template <typename G>
__device__ __forceinline__ bool window_inside(int r0, int c0, int rows,
                                              int cols) {
  return r0 >= 0 && c0 >= 0 && r0 + G::WR <= rows && c0 + G::WC <= cols;
}

// One time block of a megakernel (K2, K7): the block advances tiles first,
// first + stride, ... (< n_tiles) of a grid tiles_x tiles wide, whose tile
// (0, 0) starts at global (row0, col0), by `steps` (1..HALO) steps from
// (u, v) into (u_out, v_out), both laid out as `mem` says, through two
// window buffers at `base` (dynamic shared memory). Reads are coherent (the
// state was written by other blocks before the caller's barrier); only the
// cells in the domain that `mem` stores are written.
//
// PREFETCH: once a tile's last step is done the buffer that held that step's
// input is free, and the next tile's window starts loading into it before
// the finished tile is written out. The first tile loads when the call
// begins, so no load crosses the caller's barrier. Returns after a
// __syncthreads() unless PREFETCH, whose buffers are free once every thread
// is past the caller's next barrier.
template <typename G, int TAPS, bool NAIVE, bool SPECIALIZE, bool PREFETCH,
          typename Layout, typename T>
__device__ __forceinline__ void time_block(
    const Layout& mem, const T* u, const T* v, T* u_out,
    T* v_out, int first, int stride, int n_tiles, int tiles_x, int row0,
    int col0, int rows, int cols, int steps, const Constants& k,
    bool aligned, float* base) {
  auto load = [&](int i, int b) {
    const int ti = i / tiles_x, tj = i - ti * tiles_x;
    float* su = base + 2 * b * G::CELLS;
    load_window<G::WR, G::WC / 4, G::WC, G::NT, true>(
        mem, u, v, su, su + G::CELLS, row0 + ti * G::TR - HALO,
        col0 + tj * G::TC - HALO, rows, cols, aligned);
    cp_async_commit();
  };
  int i = first;
  int win = 0;  // the buffer that holds (or receives) the tile's window
  if (PREFETCH && i < n_tiles) load(i, win);
  while (i < n_tiles) {
    int next = i + stride;
    if (!PREFETCH) load(i, win);
    cp_async_wait<0>();
    __syncthreads();  // the window of tile i is in place
    const int ti = i / tiles_x, tj = i - ti * tiles_x;
    const int r0 = row0 + ti * G::TR - HALO, c0 = col0 + tj * G::TC - HALO;
    const bool interior =
        SPECIALIZE && window_inside<G>(r0, c0, rows, cols);
    // `steps` steps between buffer `done` and `other`; the result in `done`
    int done = win, other = (win + 1) % 2;
    for (int st = 0; st < steps; ++st) {
      const float* in_u = base + 2 * done * G::CELLS;
      float* out_u = base + 2 * other * G::CELLS;
      if (interior) {
        step_window<G, TAPS, NAIVE, true>(in_u, in_u + G::CELLS, out_u,
                                          out_u + G::CELLS, st + 1, r0, c0,
                                          rows, cols, k);
      } else {
        step_window<G, TAPS, NAIVE, false>(in_u, in_u + G::CELLS, out_u,
                                           out_u + G::CELLS, st + 1, r0, c0,
                                           rows, cols, k);
      }
      __syncthreads();
      const int t = done;
      done = other;
      other = t;
    }
    if (PREFETCH && next < n_tiles) load(next, done ^ 1);
    const float* fu = base + 2 * done * G::CELLS;
    const float* fv = fu + G::CELLS;
    for (int idx = threadIdx.x; idx < G::TR * G::TC; idx += G::NT) {
      const int lr = HALO + idx / G::TC, lc = HALO + idx % G::TC;
      const int gr = r0 + lr, gc = c0 + lc;
      if (gr < rows && gc < cols && mem.stores(gr, gc)) {
        const size_t g = mem.at(gr, gc);
        u_out[g] = narrow<T>(fu[lr * G::WC + lc]);
        v_out[g] = narrow<T>(fv[lr * G::WC + lc]);
      }
    }
    if (PREFETCH) {
      win = done ^ 1;
    } else {
      __syncthreads();  // the buffers are free for the next window
    }
    i = next;
  }
}

// --- K3's tiles: 32^2 in 34^2 windows, one step a window (K3, K9) ----------
//
// The resident kernels' tile (resident.cu, and ilpsplit.cu, which is K3 in
// row slabs): every step reloads each tile's window, the tile and its
// one-cell ring. A window row is the 16-byte span [32j - 4, 32j + 36)
// around the ring [32j - 1, 32j + 33), so that rows load as 16-byte copies;
// window column lc (0..33) lies at shared column lc + LEFT. The block is the
// tile: NT threads, each stepping a strip of R rows of one column. `Walk`
// holds the grid's width in tiles (`tiles_x`), in shared memory.
namespace ring {

constexpr int TILE = gs::TILE;  // 32: the tile edge
constexpr int WR = TILE + 2;    // window rows: the tile and its ring
constexpr int PITCH = TILE + 8;
constexpr int LEFT = 3;
constexpr int CELLS = WR * PITCH;  // of one buffer of one species
constexpr int R = 4;
constexpr int NT = TILE * (TILE / R);

// Start loading the window of tile t into (su, sv). Coherent: the state was
// written by other blocks of the launch before the caller's barrier.
template <typename Walk>
__device__ __forceinline__ void load_tile(const float* u, const float* v,
                                          float* su, float* sv, int t,
                                          const Walk& w, int rows, int cols,
                                          bool aligned) {
  const int ti = t / w.tiles_x, tj = t - ti * w.tiles_x;
  load_window<WR, PITCH / 4, PITCH, NT, true>(
      FlatLayout{cols}, u, v, su, sv, ti * TILE - 1, tj * TILE - 4, rows,
      cols, aligned);
  cp_async_commit();
}

// Step tile t from its window (su, sv) into (out_u, out_v). SPECIALIZE =
// false takes every tile as an edge tile (an ablation).
template <int TAPS, bool NAIVE, bool SPECIALIZE, typename Walk>
__device__ __forceinline__ void step_tile(const float* su, const float* sv,
                                          float* out_u, float* out_v, int t,
                                          const Walk& w, int rows, int cols,
                                          const Constants& k) {
  const int ti = t / w.tiles_x, tj = t - ti * w.tiles_x;
  const int lane = threadIdx.x % TILE, strip = threadIdx.x / TILE;
  const int gr0 = ti * TILE + strip * R, gc = tj * TILE + lane;
  const int lr0 = 1 + strip * R, lc = 1 + lane;  // window cell
  const StripAt at = {gr0, gc, rows, cols};
  float* pu = out_u + static_cast<size_t>(gr0) * cols + gc;
  float* pv = out_v + static_cast<size_t>(gr0) * cols + gc;
  if (SPECIALIZE && ti > 0 && tj > 0 && (ti + 1) * TILE + 1 <= rows &&
      (tj + 1) * TILE + 1 <= cols) {  // the window lies inside the domain
    step_strip<TAPS, NAIVE, R, PITCH, false>(
        su + LEFT, sv + LEFT, lr0, lc, R, at, k,
        [&](int i, float un, float vn) {
          pu[static_cast<size_t>(i) * cols] = un;
          pv[static_cast<size_t>(i) * cols] = vn;
        });
  } else {
    step_strip<TAPS, NAIVE, R, PITCH, true>(
        su + LEFT, sv + LEFT, lr0, lc, R, at, k,
        [&](int i, float un, float vn) {
          if (gr0 + i < rows && gc < cols) {  // the domain's cells only
            pu[static_cast<size_t>(i) * cols] = un;
            pv[static_cast<size_t>(i) * cols] = vn;
          }
        });
  }
}

}  // namespace ring

// --- host side --------------------------------------------------------------

// Whether a window may load with 16-byte copies: rows of `cols` elements of
// T a whole number of 16-byte copies (4 float32, 8 bfloat16) and every
// state pointer 16-byte aligned.
template <typename T = float>
inline bool rows_aligned(int cols, const void* a, const void* b,
                         const void* c, const void* d) {
  auto ok = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  return cols % vec_cells<T>() == 0 && ok(a) && ok(b) && ok(c) && ok(d);
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
