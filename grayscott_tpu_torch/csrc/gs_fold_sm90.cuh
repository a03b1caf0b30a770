// The fold entries' second form (K1: windowed.cu, gs_windowed_multistep_fold;
// K2: mega.cu, gs_mega_multistep_fold; and their bf16 twins): the folded
// naive reaction of gs_tile_sm90.cuh (MODE_FOLD, the expressions of
// grayscott_tpu_torch/ops/stencil.py:step_naive_fold) on 2-D register
// blocks, with a TMA window load for float32 states. The first form
// (step_strip_fold on Main, the cp.async load) stays as the entries'
// ablation part 0; the pinned, ring and ring-pinned fold entries keep it.
//
//   - 2-D register blocks. On an interior tile a thread steps R rows x C
//     columns (4 x 4, 512 threads). Each new row of its block is one vector
//     shared load a species (LDS.128; LDS.64 for C = 2) and its two
//     neighbour columns, from the adjacent lanes by shuffles (K1) or by two
//     scalar loads (K2), so the separable row pass of C cells costs one
//     load instruction and two neighbour fetches, not 3C loads, and the
//     block's row goes out as one vector store. Every cell keeps its
//     expression order (t = h1*x + h0*(xw + xe), s = h1*t + h0*(tn + ts),
//     then fold_update), so the entries stay bit for bit the plain fold.
//   - Alignment. The stepped columns are multiples of C; at step s the
//     blocks cover the valid region [s+1, W-s-1) with its columns rounded
//     outward to multiples of C. A cell stepped outside the valid region is
//     never read by a cell inside it at a later step (a valid cell reads
//     only cells valid at the step before), so its value does not matter
//     (ops/stencil.py:fold_block_walk is the CPU twin of this walk). The
//     rounding reads one cell before the first buffer, and a warp's last
//     strip up to R rows past the last: the buffers sit between two pads in
//     dynamic shared memory. The window's pitch is 84 floats, so that a
//     quarter-warp's 16-byte accesses are free of bank conflicts.
//   - Edge tiles keep the first form's per-cell code (step_strip_fold: the
//     anchored strips and the per-cell coefficients).
//   - The TMA window load (float32 states whose rows are a whole number of
//     16-byte units: tma_ok). One thread asks for each species' window with
//     cp.async.bulk.tensor, completion lands on an mbarrier in shared
//     memory, and the other threads spend no instruction on the copy. The
//     hardware writes 0.0 for the window's cells outside the domain, the
//     fold's zero-filled sum there, so windows that start at negative
//     coordinates need nothing more. The tensor maps are encoded on the host
//     (cuTensorMapEncodeTiled, reached through the runtime's driver entry
//     point, so the library links no libcuda) and passed as
//     __grid_constant__ kernel parameters. K2 reads in one time block what
//     other blocks wrote in the previous one: its stores are followed by a
//     generic-to-async proxy fence before the grid barrier, and the issuing
//     thread fences again before each load. bf16 states keep the register
//     load (TMA cannot widen), and shapes whose rows TMA cannot describe
//     keep the cp.async load; the host picks the load by shape, never on an
//     error. The tile goes out in 16-byte stores where the rows allow.
//
// What bounds them on the card is K1's: instruction issue and, more, the
// latency of each step between two barriers (PERF.md §6: the window load
// and store are 15-21 % of K1's time, the arithmetic about half).

#pragma once

#include <cuda.h>  // CUtensorMap and the encode's types; no libcuda symbol

#include <type_traits>

#include "gs_tile_sm90.cuh"

namespace gs {
namespace sm90 {

// A fold geometry of the second form: Main's 64^2 tiles in 80^2 windows,
// NT threads, R x C register blocks; SHFL: a block's neighbour columns come
// from the adjacent lanes (__shfl_up_sync, __shfl_down_sync), else from two
// scalar loads; PITCH: the window's row pitch in floats, 84 so that a
// quarter-warp's 16-byte accesses that straddle two strips of R = 4 rows
// fall in other bank groups (at 80, 4 rows are 80 16-byte units, a
// multiple of the 8 groups); the columns past 80 load and are never read.
template <int NT_, int R_, int C_, bool SHFL_ = true, int PITCH_ = 84>
struct FoldShape : FixedShape<Geometry<64, 64, NT_, R_>> {
  using G = Geometry<64, 64, NT_, R_>;
  static constexpr int TR = 64, TC = 64, C = C_, PITCH = PITCH_;
  static constexpr bool SHFL = SHFL_;
  static constexpr int CELLS = G::WR * PITCH;
  Fixed<PITCH> pitch;  // (hides FixedShape's, the window's width)
  Fixed<CELLS> cells;
  static_assert(C == 2 || C == 4, "vector loads of 2 or 4 floats");
  static_assert(G::WC % C == 0 && PITCH >= G::WC && PITCH % 4 == 0 &&
                    NT_ % 32 == 0,
                "columns of C, 16-byte rows, whole warps");
};

// K1's blocks: 512 threads, 4 rows x 4 columns (two blocks an SM), the
// neighbour columns by shuffles. K2's (mega.cu) take them by scalar loads:
// its tile walk leaves fewer of the 64 registers, and the shuffles spilled.
using FoldMain = FoldShape<512, 4, 4>;

// Floats before the first window buffer (one 128-byte unit: the TMA
// destination stays 128-byte aligned), and past the last one: R rows of
// the window (the rows a warp's last strip loads past the region) and a
// last unit, which holds the mbarrier FOLD_BAR floats in.
constexpr int FOLD_PAD = 32;
constexpr int FOLD_BAR = 16;

template <typename S>
__host__ __device__ constexpr int fold_tail() {
  return S::R * S::PITCH + FOLD_PAD;
}

// Dynamic shared memory of a block of the second form: two buffers of a
// window pair between the pads.
template <typename S>
__host__ __device__ constexpr size_t fold_bytes() {
  return (FOLD_PAD + 4 * static_cast<size_t>(S::CELLS) + fold_tail<S>()) *
         sizeof(float);
}

// The block's window buffers and its mbarrier in its dynamic shared memory.
__device__ __forceinline__ float* fold_base(float* smem) {
  return smem + FOLD_PAD;
}

template <typename S>
__device__ __forceinline__ unsigned long long* fold_barrier(float* smem) {
  return reinterpret_cast<unsigned long long*>(
      smem + FOLD_PAD + 4 * S::CELLS + S::R * S::PITCH + FOLD_BAR);
}

// --- the interior step on 2-D register blocks ---------------------------

// Row cells -1 .. C of the block at p (p 16-byte aligned for C = 4, 8-byte
// for C = 2): one vector load, and the neighbour columns from the adjacent
// lanes' blocks (SHFL; every lane of the warp takes part) except where the
// block is the first (own_left) or last (own_right) of its row in the warp,
// which load them, or two scalar loads.
template <int C, bool SHFL>
__device__ __forceinline__ void load_row(const float* p, float (&x)[C + 2],
                                         bool own_left, bool own_right) {
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[1] = q.x;
    x[2] = q.y;
    x[3] = q.z;
    x[4] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[1] = q.x;
    x[2] = q.y;
  }
  if constexpr (SHFL) {
    x[0] = __shfl_up_sync(0xffffffffu, x[C], 1);
    x[C + 1] = __shfl_down_sync(0xffffffffu, x[1], 1);
    if (own_left) x[0] = p[-1];
    if (own_right) x[C + 1] = p[C];
  } else {
    x[0] = p[-1];
    x[C + 1] = p[C];
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* p, const float (&y)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
  }
}

// The block of cells (lr0 + i, lc + j), i < n <= R, j < C, of an interior
// tile's window (row pitch `pitch`; every tap in the window or its pads),
// from (su, sv) into (out_u, out_v): every cell the bulk fold with au[0],
// bv[0]. The separable pass keeps the row sums t of the two rows above the
// new one in registers (one row pass a species a new row: one vector load
// and the two neighbour columns for C cells); a direct plan keeps the three
// rows' C + 2 cells. SHFL: every lane of the warp runs all R rows (loads
// and shuffles are warp-wide) and stores only its n.
template <int TAPS, int R, int C, bool SHFL, typename P>
__device__ __forceinline__ void step_block_fold(
    const float* su, const float* sv, float* out_u, float* out_v, P pitch,
    int lr0, int lc, int n, bool own_left, bool own_right,
    const FoldConstants& k) {
  const float* pu = su + (lr0 - 1) * pitch + lc;
  const float* pv = sv + (lr0 - 1) * pitch + lc;
  float* qu = out_u + lr0 * pitch + lc;
  float* qv = out_v + lr0 * pitch + lc;
  auto row = [&](const float* p, float (&x)[C + 2]) {
    load_row<C, SHFL>(p, x, own_left, own_right);
  };
  // the block's row i from its centres and raw sums
  auto emit = [&](int i, const float (&uc)[C], const float (&vc)[C],
                  const float (&s_u)[C], const float (&s_v)[C]) {
    float un[C], vn[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      fold_update(uc[j], vc[j], s_u[j], s_v[j], k.au[0], k.bv[0], k, &un[j],
                  &vn[j]);
    }
    if (i < n) {
      store_row<C>(qu + i * pitch, un);
      store_row<C>(qv + i * pitch, vn);
    }
  };
  if constexpr (TAPS == TAPS_SEPARABLE) {
    // the row pass of the row at p into t; its centres into `centre`
    auto pass = [&](const float* p, float (&t)[C], float (&centre)[C]) {
      float x[C + 2];
      row(p, x);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        centre[j] = x[j + 1];
        t[j] = k.h1 * x[j + 1] + k.h0 * (x[j] + x[j + 2]);
      }
    };
    float tu0[C], tu1[C], tv0[C], tv1[C], uc[C], vc[C];
    pass(pu, tu0, uc);
    pass(pv, tv0, vc);
    pass(pu + pitch, tu1, uc);
    pass(pv + pitch, tv1, vc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (SHFL || i < n) {
        float tu2[C], tv2[C], u_next[C], v_next[C], s_u[C], s_v[C];
        pass(pu + (i + 2) * pitch, tu2, u_next);
        pass(pv + (i + 2) * pitch, tv2, v_next);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s_u[j] = k.h1 * tu1[j] + k.h0 * (tu0[j] + tu2[j]);
          s_v[j] = k.h1 * tv1[j] + k.h0 * (tv0[j] + tv2[j]);
        }
        emit(i, uc, vc, s_u, s_v);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          tu0[j] = tu1[j];
          tu1[j] = tu2[j];
          tv0[j] = tv1[j];
          tv1[j] = tv2[j];
          uc[j] = u_next[j];
          vc[j] = v_next[j];
        }
      }
    }
  } else {
    float u0[C + 2], v0[C + 2], u1[C + 2], v1[C + 2];
    row(pu, u0);
    row(pv, v0);
    row(pu + pitch, u1);
    row(pv + pitch, v1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (SHFL || i < n) {
        float u2[C + 2], v2[C + 2], uc[C], vc[C], s_u[C], s_v[C];
        row(pu + (i + 2) * pitch, u2);
        row(pv + (i + 2) * pitch, v2);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float tu[3] = {u0[j], u0[j + 1], u0[j + 2]};
          const float mu[3] = {u1[j], u1[j + 1], u1[j + 2]};
          const float bu[3] = {u2[j], u2[j + 1], u2[j + 2]};
          const float tv[3] = {v0[j], v0[j + 1], v0[j + 2]};
          const float mv[3] = {v1[j], v1[j + 1], v1[j + 2]};
          const float bv[3] = {v2[j], v2[j + 1], v2[j + 2]};
          s_u[j] = fold_direct<TAPS>(tu, mu, bu, k);
          s_v[j] = fold_direct<TAPS>(tv, mv, bv, k);
          uc[j] = u1[j + 1];
          vc[j] = v1[j + 1];
        }
        emit(i, uc, vc, s_u, s_v);
#pragma unroll
        for (int j = 0; j < C + 2; ++j) {
          u0[j] = u1[j];
          u1[j] = u2[j];
          v0[j] = v1[j];
          v1[j] = v2[j];
        }
      }
    }
  }
}

// One step of a fold window of S (FoldShape) from (in_u, in_v) into
// (out_u, out_v), the valid region the cells [lo, g.wr - lo) x [lo, g.wc -
// lo), the window's cell (0, 0) at global (r0, c0). An interior tile steps
// R x C blocks over the region with its columns rounded outward to
// multiples of C, item `it` (row-major over strips of R rows and blocks of
// C columns) on lane it % 32 of a warp, each warp's lanes on consecutive
// items (a lane past the last item loads the first block and stores
// nothing); an edge tile runs the first form's per-cell strips on the
// region itself (on blocks, each block's copies of the anchored strips
// spilled and ran 1.1-2x slower).
template <int TAPS, bool INTERIOR, typename S>
__device__ __forceinline__ void fold_step_window(const S& g,
                                                 const float* in_u,
                                                 const float* in_v,
                                                 float* out_u, float* out_v,
                                                 int lo, int r0, int c0,
                                                 int rows, int cols,
                                                 const FoldConstants& k) {
  if constexpr (!INTERIOR) {
    step_window<TAPS, MODE_FOLD, false>(g, in_u, in_v, out_u, out_v, lo, r0,
                                        c0, rows, cols, k);
  } else {
    constexpr int R = S::R, C = S::C;
    const int c_lo = lo / C * C;
    const int nblk = (g.wc - lo + C - 1) / C - lo / C;
    const int hi_r = g.wr - lo;
    const int items = nblk * ((hi_r - lo + R - 1) / R);
    const int lane = threadIdx.x % 32;
    for (int it = threadIdx.x; it - lane < items; it += S::NT) {
      const bool on = it < items;
      const int strip = on ? it / nblk : 0;
      const int q = on ? it - strip * nblk : 0;
      const int lr0 = lo + strip * R;
      step_block_fold<TAPS, R, C, S::SHFL>(
          in_u, in_v, out_u, out_v, g.pitch, lr0, c_lo + q * C,
          on ? min(R, hi_r - lr0) : 0, q == 0 || lane == 0,
          q == nblk - 1 || lane == 31, k);
    }
  }
}

// The window's `steps` steps between buffer `done` (its window) and
// `other` of the pairs at `base`, each followed by a __syncthreads();
// returns the buffer that holds the result.
template <int TAPS, typename S>
__device__ __forceinline__ int fold_window_steps(const S& g, float* base,
                                                 int done, int other,
                                                 int steps, bool interior,
                                                 int r0, int c0, int rows,
                                                 int cols,
                                                 const FoldConstants& k) {
  for (int st = 0; st < steps; ++st) {
    const float* in_u = base + 2 * done * g.cells;
    float* out_u = base + 2 * other * g.cells;
    if (interior) {
      fold_step_window<TAPS, true>(g, in_u, in_u + g.cells, out_u,
                                   out_u + g.cells, st + 1, r0, c0, rows,
                                   cols, k);
    } else {
      fold_step_window<TAPS, false>(g, in_u, in_u + g.cells, out_u,
                                    out_u + g.cells, st + 1, r0, c0, rows,
                                    cols, k);
    }
    __syncthreads();
    const int t = done;
    done = other;
    other = t;
  }
  return done;
}

// Write the tile of the window (fu, fv) of S, whose cell (0, 0) lies at
// global (r0, c0), to (u_out, v_out) of the row-major rows x cols domain:
// store_window's cells, 16 bytes a store for a float32 state whose rows
// and pointers are 16-byte aligned (`aligned`: a chunk of 4 cells is then
// in the domain or out of it whole).
template <typename S, typename T>
__device__ __forceinline__ void fold_store(const S& g, T* u_out, T* v_out,
                                           const float* fu, const float* fv,
                                           int r0, int c0, int rows,
                                           int cols, bool aligned) {
  if constexpr (std::is_same<T, float>::value) {
    if (aligned) {
      constexpr int Q = S::TC / 4;  // chunks a tile row
      for (int idx = threadIdx.x; idx < S::TR * Q; idx += S::NT) {
        const int lr = g.halo + idx / Q, lc = g.halo + 4 * (idx % Q);
        const int gr = r0 + lr, gc = c0 + lc;
        if (gr < rows && gc < cols) {
          const size_t at = static_cast<size_t>(gr) * cols + gc;
          const int w = lr * g.pitch + lc;
          *reinterpret_cast<float4*>(u_out + at) =
              *reinterpret_cast<const float4*>(fu + w);
          *reinterpret_cast<float4*>(v_out + at) =
              *reinterpret_cast<const float4*>(fv + w);
        }
      }
      return;
    }
  }
  store_window(g, FlatLayout{cols}, u_out, v_out, fu, fv, r0, c0, rows,
               cols);
}

// --- the TMA window load --------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Order this thread's generic-proxy accesses of global memory before later
// async-proxy (TMA) accesses, and the reverse.
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The same for shared memory (a buffer the block read is refilled by TMA).
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One thread's request for the wr x pitch window of each species whose
// cell (0, 0) lies at global (r0, c0) of plane `slot` (K2's pair; -1 for a
// 2-D map) into (su, sv), completing on `bar` (expecting both boxes'
// bytes).
template <typename S>
__device__ __forceinline__ void tma_window(const S& g, const CUtensorMap* mu,
                                           const CUtensorMap* mv, float* su,
                                           float* sv, int r0, int c0,
                                           int slot,
                                           unsigned long long* bar) {
  const unsigned bytes = 2 * sizeof(float) * g.wr * g.pitch;
  fence_proxy_shared();
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  const CUtensorMap* maps[2] = {mu, mv};
  float* dst[2] = {su, sv};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (slot < 0) {
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
              smem_addr(dst[s])),
          "l"(reinterpret_cast<unsigned long long>(maps[s])), "r"(c0),
          "r"(r0), "r"(smem_addr(bar))
          : "memory");
    } else {
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
              smem_addr(dst[s])),
          "l"(reinterpret_cast<unsigned long long>(maps[s])), "r"(c0),
          "r"(r0), "r"(slot), "r"(smem_addr(bar))
          : "memory");
    }
  }
}

// --- K1: one tile -------------------------------------------------------

// One block of K1's fold entry in the second form: tile (blockIdx.y,
// blockIdx.x) of the rows x cols domain advanced by `steps` (0..HALO; 0
// loads and stores only, an ablation) steps from (u, v) into (u_out,
// v_out). TMA: the window loads through the maps (mu, mv) of (u, v); else
// with load_window (cp.async, or through registers for bf16). `smem`: the
// block's dynamic shared memory (fold_bytes<S>()).
template <int TAPS, bool TMA, typename S, typename T>
__device__ __forceinline__ void fold_window_multistep(
    const S& g, const T* u, const T* v, T* u_out, T* v_out, int rows,
    int cols, int steps, const FoldConstants& k, bool aligned,
    const CUtensorMap* mu, const CUtensorMap* mv, float* smem) {
  static_assert(!TMA || sizeof(T) == sizeof(float), "TMA loads float32");
  float* base = fold_base(smem);
  const int r0 = blockIdx.y * g.tr - g.halo;
  const int c0 = blockIdx.x * g.tc - g.halo;
  if constexpr (TMA) {
    unsigned long long* bar = fold_barrier<S>(smem);
    if (threadIdx.x == 0) {
      mbar_init(bar);
      tma_window(g, mu, mv, base, base + g.cells, r0, c0, -1, bar);
    }
    __syncthreads();  // the barrier is initialised
    mbar_wait(bar, 0);
  } else {
    load_window<S::NT, false>(FlatLayout{cols}, u, v, base, base + g.cells,
                              g.wr, g.pitch, r0, c0, rows, cols, aligned);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const int done =
      fold_window_steps<TAPS>(g, base, 0, 1, steps,
                              window_inside(g, r0, c0, rows, cols), r0, c0,
                              rows, cols, k);
  const float* fu = base + 2 * done * g.cells;
  fold_store(g, u_out, v_out, fu, fu + g.cells, r0, c0, rows, cols, aligned);
}

// --- K2: a time block ---------------------------------------------------

// One time block of K2's fold entry in the second form (time_block_on's
// walk with PREFETCH and interior tiles): the block advances tiles first,
// first + stride, ... (< n_tiles) of the rows x cols domain by `steps`
// (0..HALO) steps from plane `src` of the pairs into plane 1 - src. TMA:
// thread 0 asks for each window, the next one into the buffer that the
// tile's last step read, while the finished tile is written out; `phase`
// is the parity of the barrier's next phase, carried across time blocks.
template <int TAPS, bool TMA, typename S, typename T>
__device__ __forceinline__ void fold_time_block(
    const S& g, T* u_pair, T* v_pair, size_t plane, int src, int first,
    int stride, int n_tiles, int tiles_x, int rows, int cols, int steps,
    const FoldConstants& k, bool aligned, const CUtensorMap* mu,
    const CUtensorMap* mv, float* base, unsigned long long* bar,
    unsigned* phase) {
  static_assert(!TMA || sizeof(T) == sizeof(float), "TMA loads float32");
  const FlatLayout mem{cols};
  const T* u = u_pair + src * plane;
  const T* v = v_pair + src * plane;
  T* u_out = u_pair + (1 - src) * plane;
  T* v_out = v_pair + (1 - src) * plane;
  auto corner = [&](int i, int* r0, int* c0) {
    const int ti = i / tiles_x, tj = i - ti * tiles_x;
    *r0 = ti * g.tr - g.halo;
    *c0 = tj * g.tc - g.halo;
  };
  auto load = [&](int i, int b) {
    int r0, c0;
    corner(i, &r0, &c0);
    float* su = base + 2 * b * g.cells;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        tma_window(g, mu, mv, su, su + g.cells, r0, c0, src, bar);
      }
    } else {
      load_window<S::NT, true>(mem, u, v, su, su + g.cells, g.wr, g.pitch,
                               r0, c0, rows, cols, aligned);
      cp_async_commit();
    }
  };
  int i = first;
  int win = 0;  // the buffer that holds (or receives) the tile's window
  if (i < n_tiles) {
    if (TMA && threadIdx.x == 0) fence_proxy_global();
    load(i, win);
  }
  while (i < n_tiles) {
    const int next = i + stride;
    if constexpr (TMA) {
      mbar_wait(bar, *phase);
      *phase ^= 1;
    } else {
      cp_async_wait<0>();
    }
    // the window of tile i is in place, and every thread is done with the
    // previous tile's write-out
    __syncthreads();
    int r0, c0;
    corner(i, &r0, &c0);
    const int done = fold_window_steps<TAPS>(
        g, base, win, win ^ 1, steps, window_inside(g, r0, c0, rows, cols),
        r0, c0, rows, cols, k);
    if (next < n_tiles) load(next, done ^ 1);
    const float* fu = base + 2 * done * g.cells;
    fold_store(g, u_out, v_out, fu, fu + g.cells, r0, c0, rows, cols,
               aligned);
    win = done ^ 1;
    i = next;
  }
  if (TMA) fence_proxy_global();  // the stores, before other blocks' TMA
}

// --- host side ----------------------------------------------------------

// Whether a float32 state of `cols` columns loads through TMA: rows a whole
// number of 16-byte units (the map's row stride, and K2's second plane's
// offset, multiples of 16 bytes) and every pointer 16-byte aligned
// (grayscott_tpu_torch/ops/geometry.py:tma_ok is the shape's half).
inline bool fold_tma_ok(int cols, const void* a, const void* b,
                        const void* c, const void* d) {
  return rows_aligned<float>(cols, a, b, c, d);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (once).
inline cudaError_t encode_tiled(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// The tensor map of a float32 state at `base`: `planes` planes (1: a 2-D
// map; 2: K2's pair, a 3-D map) of rows x cols, read in boxes of the
// window of S (its rows, and its pitch of columns, as laid out in shared
// memory). An encode failure returns cudaErrorInvalidValue.
template <typename S>
cudaError_t window_map(CUtensorMap* map, const float* base, int rows,
                       int cols, int planes) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const S g{};
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * sizeof(float),
      static_cast<cuuint64_t>(rows) * cols * sizeof(float)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(g.pitch),
                             static_cast<cuuint32_t>(g.wr), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, planes > 1 ? 3 : 2,
      const_cast<float*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace gs
