// The species-packed tile stepper of K4 (packed.cu), K5 (packed_resident.cu)
// and K6 (packed_mega.cu), written for Hopper on the parts of the unpacked
// tile stepper (gs_tile_sm90.cuh: load_window, the cp.async helpers,
// Geometry, window_inside, rows_aligned). It replaces the first packed
// stepper (gs_packed.cuh: step_packed_tile) for those three kernels; their
// ablation part 0 still steps on that one, and the two agree bit for bit.
//
// The state is one (rows, 2*cols) row-major array [U | V] (gs_packed.cuh).
// Windows load through gs::FlatLayout{2*cols}, U at x and V at x + cols,
// with the domain `cols` wide (one species): a cell past U's last column
// loads as 0.0, never as V's first. 16-byte copies need cols % 4 == 0 and
// 16-byte aligned pointers (1920 and 4096 qualify, 1917 does not; then
// every cell loads with a 4-byte copy or __ldcg).
//
// What differs from step_packed_tile:
//
//   - Register strips (step_packed_strip). A thread steps a vertical strip
//     of R cells of one column. For each of the strip's R + 2 rows it
//     computes the row pass t = h1*x + h0*(x[c-1] + x[c+1]) of both
//     species from 3 shared loads a species, and keeps a rolling window of
//     3 rows of t in registers; the column pass s = h1*t + h0*(t[r-1] +
//     t[r+1]), q = (u*v)*v and the fold then come from registers. t never
//     touches shared memory: 6 shared loads and 2 stores a cell-step
//     (against 14 and 4), and one __syncthreads() a step (against two).
//     The price: a strip recomputes the row pass of its two neighbours'
//     edge rows, 34 float32 operations a cell-step at R = 4 against 30.
//   - Ping-pong buffers. A step writes the window's other buffer, not in
//     place: a neighbouring thread's row pass reads x[c-1] and x[c+1] of the
//     step being computed.
//   - Edge tiles (EDGE = true) write exactly 0.0 for window cells outside
//     the domain, so the next step's row pass reads the zero boundary. A row
//     outside the domain then gives t = h1*0 + h0*(0 + 0) = +0.0 (h0 > 0:
//     the separable plan's side tap is sqrt(w[0][0])), as packed_step's
//     padding of t does. Interior tiles (EDGE = false: the window inside the
//     domain, decided once a tile) run no domain test.
//   - Larger windows loaded with cp.async: K4 and K6 step Main's 64^2 tiles
//     in 80^2 windows of dynamic shared memory, K4 one tile a block in K1's
//     code shape (packed.cu), K6 walking them as time_block does, the next
//     tile's window loading during the write-out (packed_time_block); K5
//     steps 32^2 tiles in 34^2 windows in K3's code shape
//     (packed_resident.cu).
//
// Numerics: packed_step's tree (grayscott_tpu_torch/ops/packed.py), each
// operation rounded once in its order (built with -fmad=false and without
// -ftz). Registers change where an operand comes from, not which
// operations combine it or in what order, so every result equals the plain
// version bit for bit, NaN and +-Inf included: a cell outside the domain is
// stored as 0.0 and never computed from the state, so a NaN or an Inf
// reaches exactly the cells it reaches through packed_step.
//
// Shared memory: two buffers of two species, no t buffer. Main: 4 x 80^2
// floats, 102,400 B, 2 blocks an SM; Small (K4's ablation part 2, K6's part
// 3): 36,864 B; K5's 34 x 40 windows: 21,760 B.

#pragma once

#include "gs_packed.cuh"
#include "gs_tile_sm90.cuh"

namespace gs {
namespace sm90 {

// One strip: cells (lr0 + i, lc), i < n <= R, of a packed window with row
// pitch `pitch` (Fixed, or an int: gs_tile.cuh) in shared memory (su, sv),
// each of whose neighbours lies in the window. Hands each cell's new values
// to sink(i, un, vn). EDGE: a cell outside the domain (`at` says where the
// strip lies) comes out as exactly 0.0.
template <int R, bool EDGE, typename P, typename Sink>
__device__ __forceinline__ void step_packed_strip(const float* su,
                                                  const float* sv, P pitch,
                                                  int lr0, int lc, int n,
                                                  const StripAt& at,
                                                  const PackedConstants& k,
                                                  Sink&& sink) {
  const float* pu = su + (lr0 - 1) * pitch + lc;
  const float* pv = sv + (lr0 - 1) * pitch + lc;
  // the row pass of rows lr0 - 1 and lr0, and the centre of row lr0
  float tu0 = k.h1 * pu[0] + k.h0 * (pu[-1] + pu[1]);
  float tv0 = k.h1 * pv[0] + k.h0 * (pv[-1] + pv[1]);
  float u = pu[pitch], v = pv[pitch];
  float tu1 = k.h1 * u + k.h0 * (pu[pitch - 1] + pu[pitch + 1]);
  float tv1 = k.h1 * v + k.h0 * (pv[pitch - 1] + pv[pitch + 1]);
  const bool col_inside = at.gc >= 0 && at.gc < at.cols;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < n) {
      // the row below the cell
      const float* qu = pu + (i + 2) * pitch;
      const float* qv = pv + (i + 2) * pitch;
      const float u2 = qu[0], v2 = qv[0];
      const float tu2 = k.h1 * u2 + k.h0 * (qu[-1] + qu[1]);
      const float tv2 = k.h1 * v2 + k.h0 * (qv[-1] + qv[1]);
      const float s_u = k.h1 * tu1 + k.h0 * (tu0 + tu2);
      const float s_v = k.h1 * tv1 + k.h0 * (tv0 + tv2);
      const float q = (u * v) * v;
      float un = ((k.cu * s_u + k.qu * q) + k.e) + k.au * u;
      float vn = ((k.cv * s_v + k.qv * q) + 0.0f) + k.bv * v;
      if (EDGE) {
        const int gr = at.gr0 + i;
        if (!col_inside || gr < 0 || gr >= at.rows) {
          un = 0.0f;
          vn = 0.0f;
        }
      }
      sink(i, un, vn);
      tu0 = tu1;
      tu1 = tu2;
      tv0 = tv1;
      tv1 = tv2;
      u = u2;
      v = v2;
    }
  }
}

// One packed step of the window cells [lo, g.wr - lo) x [lo, g.wc - lo) of
// g (FixedShape, or PinGeometry: gs_tile_sm90.cuh), in strips of S::R
// cells, from (in_u, in_v) into (out_u, out_v); the window's cell (0, 0)
// lies at global (r0, c0) of the rows x cols domain (one species wide).
// INTERIOR: the window lies inside the domain.
template <bool INTERIOR, typename S>
__device__ __forceinline__ void step_packed_window(
    const S& g, const float* in_u, const float* in_v, float* out_u,
    float* out_v, int lo, int r0, int c0, int rows, int cols,
    const PackedConstants& k) {
  const int hi_r = g.wr - lo, ncols = g.wc - 2 * lo;
  const int items = ncols * ((hi_r - lo + S::R - 1) / S::R);
  for (int it = threadIdx.x; it < items; it += S::NT) {
    const int strip = it / ncols;
    const int lc = lo + (it - strip * ncols), lr0 = lo + strip * S::R;
    step_packed_strip<S::R, !INTERIOR>(
        in_u, in_v, g.pitch, lr0, lc, min(S::R, hi_r - lr0),
        {r0 + lr0, c0 + lc, rows, cols}, k, [&](int i, float un, float vn) {
          out_u[(lr0 + i) * g.pitch + lc] = un;
          out_v[(lr0 + i) * g.pitch + lc] = vn;
        });
  }
}

// One block of K4 (packed.cu, its compiled and pinned entries): tile
// (blockIdx.y, blockIdx.x) of g advanced by `steps` (1..g.halo) steps from
// x into x_out (both rows x 2*cols), through two window buffers at `base`
// (dynamic shared memory, 4 * g.cells floats). Nothing writes x in the
// launch, so the copies may go through L1. SPECIALIZE = false takes every
// tile as an edge tile (an ablation).
template <bool SPECIALIZE, typename S>
__device__ __forceinline__ void packed_window_multistep(
    const S& g, const float* x, float* x_out, int rows, int cols, int steps,
    const PackedConstants& k, bool aligned, float* base) {
  const int r0 = blockIdx.y * g.tr - g.halo, c0 = blockIdx.x * g.tc - g.halo;

  load_window<S::NT, false>(FlatLayout{2 * cols}, x, x + cols, base,
                            base + g.cells, g.wr, g.pitch, r0, c0, rows,
                            cols, aligned);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const bool interior = SPECIALIZE && window_inside(g, r0, c0, rows, cols);
  int cur = 0;
  for (int st = 0; st < steps; ++st) {
    const float* in_u = base + 2 * cur * g.cells;
    float* out_u = base + 2 * (cur ^ 1) * g.cells;
    if (interior) {
      step_packed_window<true>(g, in_u, in_u + g.cells, out_u,
                               out_u + g.cells, st + 1, r0, c0, rows, cols,
                               k);
    } else {
      step_packed_window<false>(g, in_u, in_u + g.cells, out_u,
                                out_u + g.cells, st + 1, r0, c0, rows, cols,
                                k);
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* fu = base + 2 * cur * g.cells;
  const float* fv = fu + g.cells;
  for (int idx = threadIdx.x; idx < g.tr * g.tc; idx += S::NT) {
    const int lr = g.halo + idx / g.tc, lc = g.halo + idx % g.tc;
    const int gr = r0 + lr, gc = c0 + lc;
    if (gr < rows && gc < cols) {
      const size_t at = static_cast<size_t>(gr) * 2 * cols + gc;
      x_out[at] = fu[lr * g.pitch + lc];
      x_out[at + cols] = fv[lr * g.pitch + lc];
    }
  }
}

// One time block of K6 on the tiles of g (FixedShape of a compiled
// geometry, or the PinGeometry of the row-tile pin): time_block's walk
// (gs_tile_sm90.cuh) on the packed state. The block advances tiles first, first + stride, ... (< n_tiles) of
// a grid tiles_x tiles wide by `steps` (1..g.halo) steps from x into x_out
// (both rows x 2*cols), through two window buffers at `base` (dynamic
// shared memory). Reads are coherent (the state was written by other
// blocks before the caller's barrier). A copy of time_block, not a step
// policy shared with K2 and K7: K2's instantiations sit at the 64 registers
// they are bound to, and a rewrite of that loop has spilled there before.
//
// PREFETCH: once a tile's last step is done the buffer that held that
// step's input is free, and the next tile's window starts loading into it
// before the finished tile is written out. The first tile loads when the
// call begins, so no load crosses the caller's barrier. Returns after a
// __syncthreads() unless PREFETCH, whose buffers are free once every thread
// is past the caller's next barrier.
template <bool SPECIALIZE, bool PREFETCH, typename S>
__device__ __forceinline__ void packed_time_block_on(
    const S& g, const float* x, float* x_out, int first, int stride,
    int n_tiles, int tiles_x, int rows, int cols, int steps,
    const PackedConstants& k, bool aligned, float* base) {
  const FlatLayout mem{2 * cols};
  auto load = [&](int i, int b) {
    const int ti = i / tiles_x, tj = i - ti * tiles_x;
    float* su = base + 2 * b * g.cells;
    load_window<S::NT, true>(mem, x, x + cols, su, su + g.cells, g.wr,
                             g.pitch, ti * g.tr - g.halo,
                             tj * g.tc - g.halo, rows, cols, aligned);
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
    const int r0 = ti * g.tr - g.halo, c0 = tj * g.tc - g.halo;
    const bool interior =
        SPECIALIZE && window_inside(g, r0, c0, rows, cols);
    // `steps` steps between buffer `done` and `other`; the result in `done`
    int done = win, other = (win + 1) % 2;
    for (int st = 0; st < steps; ++st) {
      const float* in_u = base + 2 * done * g.cells;
      float* out_u = base + 2 * other * g.cells;
      if (interior) {
        step_packed_window<true>(g, in_u, in_u + g.cells, out_u,
                                 out_u + g.cells, st + 1, r0, c0, rows, cols,
                                 k);
      } else {
        step_packed_window<false>(g, in_u, in_u + g.cells, out_u,
                                  out_u + g.cells, st + 1, r0, c0, rows,
                                  cols, k);
      }
      __syncthreads();
      const int t = done;
      done = other;
      other = t;
    }
    if (PREFETCH && next < n_tiles) load(next, done ^ 1);
    const float* fu = base + 2 * done * g.cells;
    const float* fv = fu + g.cells;
    for (int idx = threadIdx.x; idx < g.tr * g.tc; idx += S::NT) {
      const int lr = g.halo + idx / g.tc, lc = g.halo + idx % g.tc;
      const int gr = r0 + lr, gc = c0 + lc;
      if (gr < rows && gc < cols) {
        const size_t at = mem.at(gr, gc);
        x_out[at] = fu[lr * g.pitch + lc];
        x_out[at + cols] = fv[lr * g.pitch + lc];
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

// packed_time_block_on on the compiled geometry G.
template <typename G, bool SPECIALIZE, bool PREFETCH>
__device__ __forceinline__ void packed_time_block(
    const float* x, float* x_out, int first, int stride, int n_tiles,
    int tiles_x, int rows, int cols, int steps, const PackedConstants& k,
    bool aligned, float* base) {
  packed_time_block_on<SPECIALIZE, PREFETCH>(FixedShape<G>{}, x, x_out,
                                             first, stride, n_tiles, tiles_x,
                                             rows, cols, steps, k, aligned,
                                             base);
}

// The slot copy of K6 after an odd number of time blocks: slot 1 to slot 0
// of the pair (`plane` floats a slot), by the whole grid of blocks of
// `threads` threads; `tid` is the thread's flat index in its block.
__device__ __forceinline__ void packed_copy_slot(float* x_pair, size_t plane,
                                                 int threads, int tid) {
  const size_t stride = static_cast<size_t>(gridDim.x) * threads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * threads + tid;
       i < plane; i += stride) {
    x_pair[i] = __ldcg(x_pair + plane + i);
  }
}

// One launch of K6 on the tiles of g (FixedShape<Main> in packed_mega.cu,
// the PinGeometry of the row-tile pin in mega_pins.cu): `n_blocks` time
// blocks of packed_time_block_on, slot t % 2 into slot 1 - t % 2, a grid
// barrier after each, and the slot copy after an odd count.
template <bool SPECIALIZE, bool PREFETCH, typename S>
__device__ __forceinline__ void packed_mega_run(
    const S& g, float* x_pair, int rows, int cols, int n_blocks, int steps,
    const PackedConstants& k, int aligned, unsigned long long* barrier,
    float* base) {
  const size_t plane = static_cast<size_t>(rows) * 2 * cols;
  const int tiles_x = (cols + g.tc - 1) / g.tc;
  const int n_tiles = tiles_x * ((rows + g.tr - 1) / g.tr);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    packed_time_block_on<SPECIALIZE, PREFETCH>(
        g, x_pair + src, x_pair + dst, blockIdx.x, gridDim.x, n_tiles,
        tiles_x, rows, cols, steps, k, aligned, base);
    if (t + 1 < n_blocks || (n_blocks & 1)) grid_barrier(barrier, t + 1);
  }
  if (n_blocks & 1) packed_copy_slot(x_pair, plane, S::NT, threadIdx.x);
}

inline bool packed_aligned(int cols, const float* a, const float* b) {
  return rows_aligned(cols, a, a + cols, b, b + cols);
}

}  // namespace sm90
}  // namespace gs
