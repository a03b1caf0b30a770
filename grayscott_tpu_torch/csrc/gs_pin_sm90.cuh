// The forms of K1's pinned entries (windowed_pins.cu: the pinned entry and
// the pinned shard entry) beyond the first, on the tile stepper of
// gs_tile_sm90.cuh: the ablation parts of their split
// (splits/windowed_pins_ablation.cu) and the second form the entries run.
//
//   - FixedPin: a pinned geometry's sizes compiled in (gs::Fixed), the
//     form of FixedShape with any halo and the pinned pitch.
//   - 2-D register blocks (pin_step_blocks): on an interior tile a thread
//     steps 4 rows x 4 columns of the oracle's tree, each new row of its
//     block one 16-byte shared load a species (LDS.128) and two scalar
//     loads of its neighbour columns, where a strip of 4 cells of one
//     column loads 18 floats a species; the block's rows go out as 16-byte
//     stores. The valid region's columns are rounded outward to multiples
//     of 4, as the fold's second form rounds them (gs_fold_sm90.cuh): a
//     cell stepped outside the valid region is never read by a valid one.
//     A block of column 0 takes 0.0 for its left neighbour column, which
//     feeds only cells outside the valid region: the first step would read
//     it one float before the first buffer. No read passes the last buffer:
//     the last block of a row reads up to its row's pitch, and the last row
//     a step reads is the window's last only at the first step, which reads
//     buffer 0.
//   - The cluster (cluster_window_multistep_on): a thread-block cluster of
//     2 x 2 blocks steps a group of 2 x 2 tiles. Each block holds its tile
//     and the group's halo on the group's outer sides only, and one ghost
//     row and column on its inner sides; a cell of a block's inner edge
//     goes, as it is stepped, into the ghost cells of the neighbours that
//     read it (distributed shared memory: stores through
//     cluster.map_shared_rank), and one cluster barrier a step (in place of
//     the block's __syncthreads) orders them before the next step reads.
//     So a block recomputes the halo on the group's outer sides only: 64x64
//     tiles at a halo of 16 step 1.25x their output cell-steps where alone
//     they step 1.54x, and the block's buffers (81 x 88 floats a buffer, a
//     species) leave room for two blocks an SM where the 96 x 96 windows
//     leave one. Every cell takes the tree it takes in the first form on
//     the same inputs, so the result is the same bit for bit.
//
// The cluster's group. Group coordinates put the group's first tile at
// (0, 0); the group's window is rows [-H, gr_hi) x columns [-H, gc_hi),
// gr_hi = 2*tr + H (tr + H where the group has one real tile row), the
// same for columns. Block (bi, bj) owns rows [-H, tr) (bi = 0) or
// [tr, gr_hi) (bi = 1), and columns alike; at step s it steps the cells
// it owns in the group's valid region [-H + s, gr_hi - s). A block past
// the grid's last tile row or column (the grid is padded to whole
// clusters) stores nothing; it owns the group's halo band beside its real
// neighbour, which it steps as the neighbour's own window would have
// (those cells are a neighbour shard's, in a shard's layout), unless the
// band lies past the domain, where every cell stays 0.0 and the block
// steps nothing. Every block takes part in every cluster barrier, the
// first after the load (so that no block writes into a neighbour before
// it exists) and one after each step (the last before any block exits).
// A block's window is rows [-H, tr] (bi = 0) or [tr - 1, tr - 1 + wr),
// and columns [-H, tc + M) (bj = 0) or [tc - M, tc - M + wc): wr = tr + H
// + 1 rows and wc = tc + H + M columns, M = CLUSTER_MARGIN, so that a
// right-hand block's window starts on a multiple of 8 columns (16-byte and
// bf16 chunked loads); the M - 1 columns past the ghost column (bj = 0)
// or before it (bj = 1) load and are never read.

#pragma once

#include <cooperative_groups.h>

#include "gs_tile_sm90.cuh"

namespace gs {
namespace sm90 {

// --- compiled pinned sizes ---------------------------------------------------

// A pinned geometry of tr x tc tiles at a halo of H, its sizes compiled in
// (pin_geometry's window and pitch), stepped by NT threads in strips of
// Main's R.
template <int TR_, int TC_, int H_, int NT_ = Main::NT>
struct FixedPin {
  static constexpr int NT = NT_, R = Main::R;
  static constexpr int TR = TR_, TC = TC_, H = H_;
  static constexpr int WR = TR + 2 * H, WC = TC + 2 * H;
  static constexpr int PITCH = (WC + 7) / 8 * 8;
  Fixed<TR> tr;
  Fixed<TC> tc;
  Fixed<H> halo;
  Fixed<WR> wr;
  Fixed<WC> wc;
  Fixed<PITCH> pitch;
  Fixed<WR * PITCH> cells;
};

// --- 2-D register blocks on interior tiles ----------------------------------

// Row cells -1 .. 4 of a block at p (16-byte aligned): one vector load and
// the two neighbour columns; `first`: the block is its row's first (column
// 0), whose left neighbour column is taken as 0.0.
__device__ __forceinline__ void pin_row(const float* p, float (&x)[6],
                                        bool first) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = first ? 0.0f : p[-1];
  x[1] = q.x;
  x[2] = q.y;
  x[3] = q.z;
  x[4] = q.w;
  x[5] = p[4];
}

// The block of cells (lr0 + i, lc + j), i < n <= 4, j < 4, of an interior
// window (row pitch `pitch`; every tap in the window or its pads), from
// (su, sv) into (out_u, out_v): each cell the fixed term list and the
// reaction, as step_strip's interior cells.
template <int TAPS, bool NAIVE, typename P>
__device__ __forceinline__ void pin_block(const float* su, const float* sv,
                                          float* out_u, float* out_v,
                                          P pitch, int lr0, int lc, int n,
                                          const Constants& k) {
  const float* pu = su + (lr0 - 1) * pitch + lc;
  const float* pv = sv + (lr0 - 1) * pitch + lc;
  const bool first = lc == 0;
  float u0[6], v0[6], u1[6], v1[6];
  pin_row(pu, u0, first);
  pin_row(pv, v0, first);
  pin_row(pu + pitch, u1, first);
  pin_row(pv + pitch, v1, first);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < n) {
      float u2[6], v2[6], un[4], vn[4];
      pin_row(pu + (i + 2) * pitch, u2, first);
      pin_row(pv + (i + 2) * pitch, v2, first);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float tu[3] = {u0[j], u0[j + 1], u0[j + 2]};
        const float mu[3] = {u1[j], u1[j + 1], u1[j + 2]};
        const float bu[3] = {u2[j], u2[j + 1], u2[j + 2]};
        const float tv[3] = {v0[j], v0[j + 1], v0[j + 2]};
        const float mv[3] = {v1[j], v1[j + 1], v1[j + 2]};
        const float bv[3] = {v2[j], v2[j + 1], v2[j + 2]};
        react(mu[1], mv[1], fixed_laplacian<TAPS, NAIVE>(tu, mu, bu, k),
              fixed_laplacian<TAPS, NAIVE>(tv, mv, bv, k), k, &un[j],
              &vn[j]);
      }
      const int at = (lr0 + i) * pitch + lc;
      *reinterpret_cast<float4*>(out_u + at) =
          make_float4(un[0], un[1], un[2], un[3]);
      *reinterpret_cast<float4*>(out_v + at) =
          make_float4(vn[0], vn[1], vn[2], vn[3]);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        u0[j] = u1[j];
        u1[j] = u2[j];
        v0[j] = v1[j];
        v1[j] = v2[j];
      }
    }
  }
}

// One step of an interior window of g (pitch a multiple of 4) on 4 x 4
// blocks: the valid region [lo, g.wr - lo) x [lo, g.wc - lo) with its
// columns rounded outward to multiples of 4, item `it` row-major over
// strips of 4 rows and blocks of 4 columns.
template <int TAPS, int MODE, typename S>
__device__ __forceinline__ void pin_step_blocks(const S& g,
                                                const float* in_u,
                                                const float* in_v,
                                                float* out_u, float* out_v,
                                                int lo, const Constants& k) {
  const int c_lo = lo / 4 * 4;
  const int nblk = (g.wc - lo + 3) / 4 - lo / 4;
  const int hi_r = g.wr - lo;
  const int items = nblk * ((hi_r - lo + 3) / 4);
  for (int it = threadIdx.x; it < items; it += S::NT) {
    const int strip = it / nblk, q = it - strip * nblk;
    const int lr0 = lo + 4 * strip;
    pin_block<TAPS, MODE == MODE_NAIVE>(in_u, in_v, out_u, out_v, g.pitch,
                                        lr0, c_lo + 4 * q,
                                        min(4, hi_r - lr0), k);
  }
}

// Call f(row, col) for the items threadIdx.x, threadIdx.x + NT, ... of a
// row-major nrows x ncols grid, with two integer divisions a walk where
// it / ncols takes one an item: the thread's next item is NT further, NT /
// ncols rows and NT % ncols columns on, one row more where the columns
// wrap (NT % ncols < ncols, so once at most).
template <int NT, typename F>
__device__ __forceinline__ void walk_items(int nrows, int ncols, F&& f) {
  int row = threadIdx.x / ncols, col = threadIdx.x - row * ncols;
  const int dq = NT / ncols, dr = NT - dq * ncols;
  while (row < nrows) {
    f(row, col);
    col += dr;
    row += dq;
    if (col >= ncols) {
      col -= ncols;
      ++row;
    }
  }
}

// pin_step_blocks walked without a division an item (walk_items).
template <int TAPS, int MODE, typename S>
__device__ __forceinline__ void pin_step_blocks_walk(
    const S& g, const float* in_u, const float* in_v, float* out_u,
    float* out_v, int lo, const Constants& k) {
  const int c_lo = lo / 4 * 4;
  const int nblk = (g.wc - lo + 3) / 4 - lo / 4;
  const int hi_r = g.wr - lo;
  walk_items<S::NT>((hi_r - lo + 3) / 4, nblk, [&](int strip, int q) {
    const int lr0 = lo + 4 * strip;
    pin_block<TAPS, MODE == MODE_NAIVE>(in_u, in_v, out_u, out_v, g.pitch,
                                        lr0, c_lo + 4 * q,
                                        min(4, hi_r - lr0), k);
  });
}

// step_window walked without a division a strip (walk_items).
template <int TAPS, int MODE, bool INTERIOR, typename S, typename K>
__device__ __forceinline__ void step_window_walk(const S& g,
                                                 const float* in_u,
                                                 const float* in_v,
                                                 float* out_u, float* out_v,
                                                 int lo, int r0, int c0,
                                                 int rows, int cols,
                                                 const K& k) {
  const int hi_r = g.wr - lo, ncols = g.wc - 2 * lo;
  walk_items<S::NT>((hi_r - lo + S::R - 1) / S::R, ncols,
                    [&](int strip, int col) {
    const int lc = lo + col, lr0 = lo + strip * S::R;
    const StripAt at = {r0 + lr0, c0 + lc, rows, cols};
    auto sink = [&](int i, float un, float vn) {
      out_u[(lr0 + i) * g.pitch + lc] = un;
      out_v[(lr0 + i) * g.pitch + lc] = vn;
    };
    if constexpr (MODE == MODE_FOLD) {
      step_strip_fold<TAPS, S::R, !INTERIOR>(
          in_u, in_v, g.pitch, lr0, lc, min(S::R, hi_r - lr0), at, k, sink);
    } else {
      step_strip<TAPS, MODE == MODE_NAIVE, S::R, !INTERIOR>(
          in_u, in_v, g.pitch, lr0, lc, min(S::R, hi_r - lr0), at, k, sink);
    }
  });
}

// --- the pinned body on a chosen form ----------------------------------------

// The forms of the step loop.
constexpr int PIN_STRIPS = 0;  // strips of R cells of one column
constexpr int PIN_BLOCKS = 1;  // 4 x 4 blocks on interior tiles
// both walked without a division an item (walk_items): 4 x 4 blocks on
// interior tiles, strips on edge tiles
constexpr int PIN_BLOCKS_WALK = 2;
constexpr int PIN_STRIPS_WALK = 3;  // strips on every tile

// Write the tile of the window (fu, fv) of g, whose cell (0, 0) lies at
// global (r0, c0), to (u_out, v_out), with (lr0, lc0) the window cell of
// the tile's first cell: a shard's layout (SHARD) stores every cell it
// holds, those outside the domain as 0.0 (K1's shard entry); a flat one
// the cells in the domain.
template <bool SHARD, typename S, typename Layout, typename T>
__device__ __forceinline__ void pin_store(const S& g, const Layout& mem,
                                          T* u_out, T* v_out,
                                          const float* fu, const float* fv,
                                          int lr0, int lc0, int r0, int c0,
                                          int rows, int cols) {
  for (int idx = threadIdx.x; idx < g.tr * g.tc; idx += S::NT) {
    const int lr = lr0 + idx / g.tc, lc = lc0 + idx % g.tc;
    const int gr = r0 + lr, gc = c0 + lc;
    const bool in = gr < rows && gc < cols;
    if (SHARD ? mem.stores(gr, gc) : in) {
      const size_t at = mem.at(gr, gc);
      u_out[at] = narrow<T>(in ? fu[lr * g.pitch + lc] : 0.0f);
      v_out[at] = narrow<T>(in ? fv[lr * g.pitch + lc] : 0.0f);
    }
  }
}

// window_multistep_on (flat) or shard_window_multistep's tile (SHARD) on
// the step loop of FORM: the tile of g whose window starts at global (r0,
// c0) advanced by `steps` (0..g.halo) steps from (u, v) into (u_out,
// v_out), through two window buffers at `base`. SPECIALIZE = false takes
// every tile as an edge tile.
// COHERENT: the layout's loads go through L2 only (the shard entry's).
template <int TAPS, int MODE, int FORM, bool SPECIALIZE, bool SHARD,
          bool COHERENT, typename S, typename Layout, typename T,
          typename K>
__device__ __forceinline__ void pin_window_multistep_on(
    const S& g, const Layout& mem, const T* u, const T* v, T* u_out,
    T* v_out, int r0, int c0, int rows, int cols, int steps, const K& k,
    bool aligned, float* base) {
  load_window<S::NT, COHERENT>(mem, u, v, base, base + g.cells, g.wr,
                               g.pitch, r0, c0, rows, cols, aligned);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const bool interior = SPECIALIZE && window_inside(g, r0, c0, rows, cols);
  int cur = 0;
  for (int st = 0; st < steps; ++st) {
    const float* in_u = base + 2 * cur * g.cells;
    float* out_u = base + 2 * (cur ^ 1) * g.cells;
    constexpr bool WALK = FORM == PIN_BLOCKS_WALK || FORM == PIN_STRIPS_WALK;
    if (interior) {
      if constexpr (FORM == PIN_BLOCKS && MODE != MODE_FOLD) {
        pin_step_blocks<TAPS, MODE>(g, in_u, in_u + g.cells, out_u,
                                    out_u + g.cells, st + 1, k);
      } else if constexpr (FORM == PIN_BLOCKS_WALK && MODE != MODE_FOLD) {
        pin_step_blocks_walk<TAPS, MODE>(g, in_u, in_u + g.cells, out_u,
                                         out_u + g.cells, st + 1, k);
      } else if constexpr (WALK) {
        step_window_walk<TAPS, MODE, true>(g, in_u, in_u + g.cells, out_u,
                                           out_u + g.cells, st + 1, r0, c0,
                                           rows, cols, k);
      } else {
        step_window<TAPS, MODE, true>(g, in_u, in_u + g.cells, out_u,
                                      out_u + g.cells, st + 1, r0, c0, rows,
                                      cols, k);
      }
    } else if constexpr (WALK) {
      step_window_walk<TAPS, MODE, false>(g, in_u, in_u + g.cells, out_u,
                                          out_u + g.cells, st + 1, r0, c0,
                                          rows, cols, k);
    } else {
      step_window<TAPS, MODE, false>(g, in_u, in_u + g.cells, out_u,
                                     out_u + g.cells, st + 1, r0, c0, rows,
                                     cols, k);
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* fu = base + 2 * cur * g.cells;
  pin_store<SHARD>(g, mem, u_out, v_out, fu, fu + g.cells, g.halo, g.halo,
                   r0, c0, rows, cols);
}

// Where a block of K1's shard entry works: its shard's layout and pairs
// (shard_window_multistep's set-up, for tile (ti, tj) of shard blockIdx.z).
template <typename T>
struct ShardAt {
  ShardLayout mem;
  const T *u, *v;
  T *u_out, *v_out;
  bool aligned;
};

template <typename S, typename T>
__device__ __forceinline__ ShardAt<T> shard_at(const S& g,
                                               const Shards<T>& s) {
  const int sh = blockIdx.z;
  const size_t pitch = static_cast<size_t>(s.c_loc) + 2 * s.chalo;
  const size_t plane = (static_cast<size_t>(s.r_loc) + 2 * g.halo) * pitch;
  const ShardLayout mem = {(s.row0 + sh / s.n_cols) * s.r_loc,
                           (s.col0 + sh % s.n_cols) * s.c_loc,
                           s.r_loc,
                           s.c_loc,
                           g.halo,
                           s.chalo,
                           pitch};
  ShardAt<T> a = {mem,
                  s.u_pairs + (2 * sh + s.src) * plane,
                  s.v_pairs + (2 * sh + s.src) * plane,
                  s.u_pairs + (2 * sh + 1 - s.src) * plane,
                  s.v_pairs + (2 * sh + 1 - s.src) * plane,
                  false};
  a.aligned = pitch % vec_cells<T>() == 0 && aligned16(a.u) &&
              aligned16(a.v) && aligned16(a.u_out) && aligned16(a.v_out);
  return a;
}

// shard_window_multistep on the step loop of FORM (SPECIALIZE as above).
template <int TAPS, int MODE, int FORM, bool SPECIALIZE, typename S,
          typename T>
__device__ __forceinline__ void pin_shard_multistep(const S& g,
                                                    const Shards<T>& s,
                                                    int rows, int cols,
                                                    int steps,
                                                    const Constants& k,
                                                    float* base) {
  const int inner = s.part == 1;
  const int ti = blockIdx.y + (inner ? s.ti0 : 0);
  const int tj = blockIdx.x + (inner ? s.tj0 : 0);
  if (s.part == 2 && ti >= s.ti0 && ti < s.ti1 && tj >= s.tj0 &&
      tj < s.tj1) {
    return;  // an overlap-interior tile: part 1's
  }
  const ShardAt<T> a = shard_at(g, s);
  pin_window_multistep_on<TAPS, MODE, FORM, SPECIALIZE, true, true>(
      g, a.mem, a.u, a.v, a.u_out, a.v_out,
      a.mem.row0 + ti * g.tr - g.halo, a.mem.col0 + tj * g.tc - g.halo, rows,
      cols, steps, k, a.aligned, base);
}

// --- the cluster of 2 x 2 blocks ---------------------------------------------

// Columns before a right-hand block's ghost column, so that its window
// starts on a multiple of 8 columns where tc is one.
constexpr int CLUSTER_MARGIN = 8;

// How a cluster block's inner edges reach its neighbours, and when it
// waits for theirs: each cell as it is stepped, one cluster barrier a step
// (CLUSTER_PUSH_CELLS); in a pass of their own after the step's
// __syncthreads, one cluster barrier a step (CLUSTER_PUSH_PASS); the same
// pass, the barrier split so that a block steps the cells that read no
// ghost cell before it waits for its neighbours' edges, and its own edges
// after (CLUSTER_SPLIT).
constexpr int CLUSTER_PUSH_CELLS = 0;
constexpr int CLUSTER_PUSH_PASS = 1;
constexpr int CLUSTER_SPLIT = 2;

// The halves of a cluster barrier: the arrival (releasing this thread's
// writes to the cluster) and the wait (acquiring the others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A block's window in the cluster form (cluster_geometry), NT threads,
// strips of Main's R.
template <int NT_>
struct ClusterShape {
  static constexpr int NT = NT_, R = Main::R;
  int tr, tc, halo, wr, wc, pitch, cells;
};

template <int NT>
inline ClusterShape<NT> cluster_geometry(int tr, int tc, int halo) {
  const int wr = tr + halo + 1, wc = tc + halo + CLUSTER_MARGIN;
  const int pitch = (wc + 7) / 8 * 8;
  return {tr, tc, halo, wr, wc, pitch, wr * pitch};
}

// Dynamic shared memory of a block of the cluster form: two buffers of a
// window pair.
template <typename S>
inline size_t cluster_bytes(const S& g) {
  return 4 * sizeof(float) * static_cast<size_t>(g.cells);
}

// One step of the window cells [r_lo, r_hi) x [c_lo, c_hi) of g in strips
// of S::R cells, from (in_u, in_v) into (out_u, out_v), the window's cell
// (0, 0) at global (r0, c0) (step_window on a rectangle); each new cell
// also goes to push(lr, lc, un, vn).
template <int TAPS, int MODE, bool INTERIOR, typename S, typename K,
          typename Push>
__device__ __forceinline__ void step_rect(const S& g, const float* in_u,
                                          const float* in_v, float* out_u,
                                          float* out_v, int r_lo, int r_hi,
                                          int c_lo, int c_hi, int r0, int c0,
                                          int rows, int cols, const K& k,
                                          Push&& push) {
  const int ncols = c_hi - c_lo;
  if (ncols <= 0 || r_hi <= r_lo) return;
  const int items = ncols * ((r_hi - r_lo + S::R - 1) / S::R);
  for (int it = threadIdx.x; it < items; it += S::NT) {
    const int strip = it / ncols;
    const int lc = c_lo + (it - strip * ncols), lr0 = r_lo + strip * S::R;
    const StripAt at = {r0 + lr0, c0 + lc, rows, cols};
    auto sink = [&](int i, float un, float vn) {
      out_u[(lr0 + i) * g.pitch + lc] = un;
      out_v[(lr0 + i) * g.pitch + lc] = vn;
      push(lr0 + i, lc, un, vn);
    };
    if constexpr (MODE == MODE_FOLD) {
      step_strip_fold<TAPS, S::R, !INTERIOR>(
          in_u, in_v, g.pitch, lr0, lc, min(S::R, r_hi - lr0), at, k, sink);
    } else {
      step_strip<TAPS, MODE == MODE_NAIVE, S::R, !INTERIOR>(
          in_u, in_v, g.pitch, lr0, lc, min(S::R, r_hi - lr0), at, k, sink);
    }
  }
}

// The block of the cluster form at tile (ti, tj) of a grid of tiles_y x
// tiles_x real tiles (ti, tj may lie one past them: a padded block), the
// grid's tile (0, 0) at global (row0, col0): the group's `steps`
// (1..g.halo) steps from (u, v) into (u_out, v_out), both laid out as
// `mem` says (SHARD: a shard's layout, whose every held cell of the tile
// is stored, 0.0 outside the domain; COHERENT as in
// pin_window_multistep_on), through two window buffers at `base`. Launched
// in clusters of 2 x 2 blocks on a grid padded to whole clusters, (x, y)
// = (tj, ti) within the cluster's (2, 2).
template <int TAPS, int MODE, bool SHARD, bool COHERENT,
          int FORM = CLUSTER_PUSH_CELLS, typename S, typename Layout,
          typename T, typename K>
__device__ __forceinline__ void cluster_window_multistep_on(
    const S& g, const Layout& mem, const T* u, const T* v, T* u_out,
    T* v_out, int ti, int tj, int tiles_y, int tiles_x, int row0, int col0,
    int rows, int cols, int steps, const K& k, bool aligned, float* base) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int bi = ti & 1, bj = tj & 1;
  const int h = g.halo, tr = g.tr, tc = g.tc, M = CLUSTER_MARGIN;
  // the group's window and what the block owns of it, in group coordinates
  const int gr_hi = ((ti | 1) < tiles_y ? 2 * tr : tr) + h;
  const int gc_hi = ((tj | 1) < tiles_x ? 2 * tc : tc) + h;
  const int own_r_lo = bi ? tr : -h, own_r_hi = bi ? gr_hi : tr;
  const int own_c_lo = bj ? tc : -h, own_c_hi = bj ? gc_hi : tc;
  // the block's window origin, in group coordinates and globally
  const int wr0 = bi ? tr - 1 : -h, wc0 = bj ? tc - M : -h;
  const int gr0 = row0 + (ti & ~1) * tr, gc0 = col0 + (tj & ~1) * tc;
  const int r0 = gr0 + wr0, c0 = gc0 + wc0;
  const bool padded = ti >= tiles_y || tj >= tiles_x;
  // every cell the block owns lies past the domain: 0.0 at every step
  const bool dead = gr0 + own_r_lo >= rows || gc0 + own_c_lo >= cols;

  load_window<S::NT, COHERENT>(mem, u, v, base, base + g.cells, g.wr,
                               g.pitch, r0, c0, rows, cols, aligned);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // the ghost row and column into the second buffer too: where a
  // neighbour steps nothing (dead), they keep the 0.0 they loaded
  const int ghost_r = bi ? 0 : g.wr - 1, ghost_c = bj ? M - 1 : tc + h;
  for (int idx = threadIdx.x; idx < g.wr + g.wc; idx += S::NT) {
    const int at = idx < g.wc ? ghost_r * g.pitch + idx
                              : (idx - g.wc) * g.pitch + ghost_c;
    base[2 * g.cells + at] = base[at];
    base[3 * g.cells + at] = base[g.cells + at];
  }
  cluster.sync();

  // the neighbours' windows: where a cell of this block's inner edge row
  // (push_r) and column (push_c) lies in each
  const unsigned rank = cluster.block_rank();
  float* nb_h = cluster.map_shared_rank(base, rank ^ 1u);
  float* nb_v = cluster.map_shared_rank(base, rank ^ 2u);
  float* nb_d = cluster.map_shared_rank(base, rank ^ 3u);
  const int dr = bi ? tr - 1 + h : 1 - tr - h;  // this window's row 0 in
  const int dc = bj ? tc - M + h : M - tc - h;  // the other's, less its own
  const int push_r = bi ? 1 : tr - 1 + h, push_c = bj ? M : tc - 1 + h;
  const bool interior = window_inside(g, r0, c0, rows, cols);
  // the step's cells of the rectangle [r_lo, r_hi) x [c_lo, c_hi)
  auto step = [&](const float* in_u, float* out_u, int r_lo, int r_hi,
                  int c_lo, int c_hi) {
    auto none = [](int, int, float, float) {};
    if (interior) {
      step_rect<TAPS, MODE, true>(g, in_u, in_u + g.cells, out_u,
                                  out_u + g.cells, r_lo, r_hi, c_lo, c_hi,
                                  r0, c0, rows, cols, k, none);
    } else {
      step_rect<TAPS, MODE, false>(g, in_u, in_u + g.cells, out_u,
                                   out_u + g.cells, r_lo, r_hi, c_lo, c_hi,
                                   r0, c0, rows, cols, k, none);
    }
  };
  // the inner edge row, column and corner of the new buffer at `off`
  // into the neighbours' (after a __syncthreads)
  auto send = [&](int off, int r_lo, int r_hi, int c_lo, int c_hi) {
    const float* out_u = base + off;
    const int nc = c_hi - c_lo, nr = r_hi - r_lo;
    for (int idx = threadIdx.x; idx <= nc + nr; idx += S::NT) {
      const bool row = idx < nc, col = !row && idx < nc + nr;
      const int lr = row ? push_r : (col ? r_lo + idx - nc : push_r);
      const int lc = row ? c_lo + idx : push_c;
      float* nb = row ? nb_v : (col ? nb_h : nb_d);
      const int at = lr * g.pitch + lc;
      float* p = nb + off + at + (col ? 0 : dr * g.pitch) + (row ? 0 : dc);
      p[0] = out_u[at];
      p[g.cells] = out_u[g.cells + at];
    }
  };
  int cur = 0;
  if constexpr (FORM == CLUSTER_SPLIT) {
    // step st: the cells that read no ghost cell, then (once the
    // neighbours' edges of step st - 1 have arrived) the inner edge row
    // and column, then the edges out and this block's arrival
    for (int st = 1; st <= steps; ++st) {
      const int off = 2 * (cur ^ 1) * g.cells;
      const int r_lo = max(own_r_lo, st - h) - wr0;
      const int r_hi = min(own_r_hi, gr_hi - st) - wr0;
      const int c_lo = max(own_c_lo, st - h) - wc0;
      const int c_hi = min(own_c_hi, gc_hi - st) - wc0;
      const int br_lo = r_lo + bi, br_hi = r_hi - (1 - bi);
      const int bc_lo = c_lo + bj, bc_hi = c_hi - (1 - bj);
      const float* in_u = base + 2 * cur * g.cells;
      if (!dead) step(in_u, base + off, br_lo, br_hi, bc_lo, bc_hi);
      if (st > 1) cluster_wait();
      if (!dead) {
        step(in_u, base + off, push_r, push_r + 1, c_lo, c_hi);
        step(in_u, base + off, br_lo, br_hi, push_c, push_c + 1);
      }
      __syncthreads();
      if (!dead) send(off, r_lo, r_hi, c_lo, c_hi);
      cluster_arrive();
      cur ^= 1;
    }
    cluster_wait();
  }
  for (int st = 1; FORM != CLUSTER_SPLIT && st <= steps; ++st) {
    if (!dead) {
      const int off = 2 * (cur ^ 1) * g.cells;
      const float* in_u = base + 2 * cur * g.cells;
      float* out_u = base + off;
      const int r_lo = max(own_r_lo, st - h) - wr0;
      const int r_hi = min(own_r_hi, gr_hi - st) - wr0;
      const int c_lo = max(own_c_lo, st - h) - wc0;
      const int c_hi = min(own_c_hi, gc_hi - st) - wc0;
      auto push = [&](int lr, int lc, float un, float vn) {
        const bool er = lr == push_r, ec = lc == push_c;
        if (er) {
          float* p = nb_v + off + (lr + dr) * g.pitch + lc;
          p[0] = un;
          p[g.cells] = vn;
        }
        if (ec) {
          float* p = nb_h + off + lr * g.pitch + lc + dc;
          p[0] = un;
          p[g.cells] = vn;
        }
        if (er && ec) {
          float* p = nb_d + off + (lr + dr) * g.pitch + lc + dc;
          p[0] = un;
          p[g.cells] = vn;
        }
      };
      if constexpr (FORM == CLUSTER_PUSH_PASS) {
        step(in_u, out_u, r_lo, r_hi, c_lo, c_hi);
        __syncthreads();
        send(off, r_lo, r_hi, c_lo, c_hi);
      } else if (interior) {
        step_rect<TAPS, MODE, true>(g, in_u, in_u + g.cells, out_u,
                                    out_u + g.cells, r_lo, r_hi, c_lo, c_hi,
                                    r0, c0, rows, cols, k, push);
      } else {
        step_rect<TAPS, MODE, false>(g, in_u, in_u + g.cells, out_u,
                                     out_u + g.cells, r_lo, r_hi, c_lo, c_hi,
                                     r0, c0, rows, cols, k, push);
      }
    }
    cluster.sync();
    cur ^= 1;
  }

  if (!padded) {
    const float* fu = base + 2 * cur * g.cells;
    pin_store<SHARD>(g, mem, u_out, v_out, fu, fu + g.cells, bi ? 1 : h,
                     bj ? M : h, r0, c0, rows, cols);
  }
}

// The cluster form of K1's pinned entry: block (blockIdx.y, blockIdx.x) of
// a grid of tiles padded to whole clusters on the row-major rows x cols
// domain.
template <int TAPS, int MODE, int FORM = CLUSTER_PUSH_CELLS, typename S,
          typename T, typename K>
__device__ __forceinline__ void cluster_window_multistep(
    const S& g, const T* u, const T* v, T* u_out, T* v_out, int rows,
    int cols, int steps, const K& k, bool aligned, float* base) {
  cluster_window_multistep_on<TAPS, MODE, false, false, FORM>(
      g, FlatLayout{cols}, u, v, u_out, v_out, blockIdx.y, blockIdx.x,
      (rows + g.tr - 1) / g.tr, (cols + g.tc - 1) / g.tc, 0, 0, rows, cols,
      steps, k, aligned, base);
}

// The cluster form of K1's pinned shard entry (every tile of each shard,
// part 0 only): block (blockIdx.y, blockIdx.x) of shard blockIdx.z's grid
// of tiles, padded to whole clusters.
template <int TAPS, int MODE, int FORM = CLUSTER_PUSH_CELLS, typename S,
          typename T>
__device__ __forceinline__ void cluster_shard_multistep(
    const S& g, const Shards<T>& s, int rows, int cols, int steps,
    const Constants& k, float* base) {
  const ShardAt<T> a = shard_at(g, s);
  cluster_window_multistep_on<TAPS, MODE, true, true, FORM>(
      g, a.mem, a.u, a.v, a.u_out, a.v_out, blockIdx.y, blockIdx.x,
      (s.r_loc + g.tr - 1) / g.tr, (s.c_loc + g.tc - 1) / g.tc, a.mem.row0,
      a.mem.col0, rows, cols, steps, k, a.aligned, base);
}

// The grid of a cluster launch over tiles_y x tiles_x tiles: each
// dimension rounded up to whole clusters of 2.
inline dim3 cluster_grid(int tiles_x, int tiles_y, int depth) {
  return dim3((tiles_x + 1) / 2 * 2, (tiles_y + 1) / 2 * 2, depth);
}

// A launch of `kernel` in clusters of 2 x 2 blocks, NT threads a block and
// `bytes` of dynamic shared memory, on `stream`.
template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, dim3 grid, int threads,
                             size_t bytes, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 2;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The clusters of 2 x 2 blocks of `kernel` (NT threads, `bytes` of dynamic
// shared memory) that the device holds at once (*clusters), and the
// blocks of it an SM holds, by its registers and shared memory alone
// (*per_sm); after allowing it the most dynamic shared memory a block may
// use.
template <typename Kernel>
cudaError_t cluster_occupancy(Kernel kernel, int threads, size_t bytes,
                              int* clusters, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_OPTIN));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 2;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(2, 2, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace sm90
}  // namespace gs
