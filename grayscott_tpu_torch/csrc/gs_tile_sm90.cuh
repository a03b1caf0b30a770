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
//     finished tile is written out (time_block), or, at mega_depth D > 2,
//     through a ring of D + 1 buffers with D - 1 loads in flight while a
//     tile steps (ring_walk, ring_time_block_on).
//   - Sizes as values. The strip steppers, window loads, step_window,
//     window_inside and store_window take a window's sizes and row pitch
//     as arguments of a deduced type: gs::Fixed<N> (gs_tile.cuh), a
//     constant once inlined, for the compiled geometries (FixedShape<G>),
//     and int for K1's and K4's pinned ones (PinGeometry: the tile and
//     depth pins, tiles, halo and pitch known at run time). Both run one
//     body; the compiled kernels keep their constants.
//   - K3's 32^2 tiles in 34^2 windows, one step a window (ring: load_tile,
//     step_tile), which the resident kernels K3 and K9 walk every step.
//   - The folded naive reaction (K1, K2; MODE_FOLD, step_strip_fold): JAX's
//     fast_fold, the naive update's u-linear terms and its clamped window's
//     centre correction folded into per-cell coefficients, the diffusion
//     sum the raw zero-filled one (the separable pass in registers, or a
//     direct plan's tap list). An interior tile takes one pair of
//     coefficients and no per-cell test; an edge tile picks them from two
//     integer tests and runs the anchored strips (row 0, column 0) per
//     cell. The mode is a template parameter (MODE_ZERO, MODE_NAIVE,
//     MODE_FOLD) of step_window and time_block, beside the constants'
//     type.
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
// Numerics: the expressions of gs_tile.cuh (the fold: those of
// stencil.step_naive_fold), built with -fmad=false and without -ftz, so
// every kernel equals the plain PyTorch step
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
// The folded naive reaction's separable pass (no tap list; MODE_FOLD)
constexpr int TAPS_SEPARABLE = -2;

// What a stepper computes: the oracle's tree on the zero or the naive
// boundary (K = Constants), or the folded naive reaction (K =
// FoldConstants).
constexpr int MODE_ZERO = 0;
constexpr int MODE_NAIVE = 1;
constexpr int MODE_FOLD = 2;

// The tap set of the weights, as the kernels' `w == 0.0f` skip reads them.
template <typename K>
inline int tap_mask(const K& k) {
  int mask = 0;
  for (int t = 0; t < 9; ++t) {
    if (k.w[t] != 0.0f) mask |= 1 << t;
  }
  return mask;
}

template <int TAPS, typename K>
__device__ __forceinline__ bool has_tap(const K& k, int t) {
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
// (lr, lc) lies at global (gr, gc); the window's rows lie `pitch` floats
// apart (Fixed, or an int: gs_tile.cuh).
template <typename P>
__device__ __forceinline__ void naive_edge_cell(const float* su,
                                                const float* sv, P pitch,
                                                int lr, int lc, int gr,
                                                int gc, int rows, int cols,
                                                const Constants& k, float* un,
                                                float* vn) {
  const float uc = su[lr * pitch + lc], vc = sv[lr * pitch + lc];
  react(uc, vc,
        naive_laplacian(su, pitch, lr, lc, uc, gr, gc, rows, cols, k),
        naive_laplacian(sv, pitch, lr, lc, vc, gr, gc, rows, cols, k), k,
        un, vn);
}

// Where a strip lies in the domain, for the per-cell tests of an edge tile:
// its first cell's global row, its column, and the domain.
struct StripAt {
  int gr0, gc, rows, cols;
};

// One strip: cells (lr0 + i, lc), i < n <= R, of a window with row pitch
// `pitch` in shared memory (su, sv), each of whose taps lies in the window.
// Hands each cell's new values to sink(i, un, vn).
//
// EDGE = false (an interior tile): every cell takes the fixed term list.
// EDGE = true: a cell outside the domain comes out as exactly 0.0; on the
// naive boundary a cell in the domain's first or last row or column takes
// gs_tile.cuh's clamped form (naive_edge_cell); every other cell takes the
// fixed list, which equals the per-cell code there (on the zero boundary the
// window's cells outside the domain hold 0.0, as zero_laplacian reads them).
template <int TAPS, bool NAIVE, int R, bool EDGE, typename P, typename Sink>
__device__ __forceinline__ void step_strip(const float* su, const float* sv,
                                           P pitch, int lr0, int lc, int n,
                                           const StripAt& at,
                                           const Constants& k, Sink&& sink) {
  const float* pu = su + (lr0 - 1) * pitch + lc;
  const float* pv = sv + (lr0 - 1) * pitch + lc;
  float u0[3] = {pu[-1], pu[0], pu[1]};
  float v0[3] = {pv[-1], pv[0], pv[1]};
  float u1[3] = {pu[pitch - 1], pu[pitch], pu[pitch + 1]};
  float v1[3] = {pv[pitch - 1], pv[pitch], pv[pitch + 1]};
  const bool col_inside = at.gc >= 0 && at.gc < at.cols;
  const bool edge_col = at.gc == 0 || at.gc == at.cols - 1;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < n) {
      const float* qu = pu + (i + 2) * pitch;
      const float* qv = pv + (i + 2) * pitch;
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
          naive_edge_cell(su, sv, pitch, lr0 + i, lc, gr, at.gc, at.rows,
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

// --- the folded naive reaction (MODE_FOLD) ----------------------------------
//
// grayscott_tpu/ops/pallas_stencil.py:make_window_stepper(fast_fold=True)
// (:363-382, :568-576, :646-653, :817-859), the plain version
// grayscott_tpu_torch/ops/stencil.py:step_naive_fold. A cell of row >= 1
// and column >= 1 takes
//
//   un = ((cu*s_u - q) + e) + AU*u,   vn = (cv*s_v + q) + BV*v,
//
// q = uv^2 (dt*uv^2 when dt != 1), s the raw zero-filled sum: the separable
// pass t = h1*x + h0*(xw + xe), s = h1*t + h0*(tn + ts) (TAPS_SEPARABLE),
// or a direct plan's 9-term sum over the weights. AU = au0 - cu*b and BV =
// bv0 - cv*b fold the clamped window's `- x*b` centre correction in: b is
// the sum of the in-bounds weights, which differs from its interior value
// only in the last row and the last column, so four values of each (host
// float32, fold_constants) serve every such cell. Row 0 and column 0, where
// the naive window's weights stay anchored, take the anchored gradient
// (fold_top, fold_left: JAX's strips, term for term) with the scalars
// au0/bv0.

// Run-time constants of the fold (grayscott_tpu_torch/params.py:
// FoldConstants), each exactly a float32; au[i], bv[i] at a cell of row >= 1
// and column >= 1, i = 2 * (the last row) + (the last column).
struct FoldConstants {
  float w[9];  // stencil weights, row-major: the strips, the direct sum
  float h0, h1;         // the separable pass (TAPS_SEPARABLE)
  float cu, cv, e, dt;  // the linear fold; dt the quadratic term's factor
  float au0, bv0;       // the anchored strips' coefficients
  float au[4], bv[4];
  int dt_is_one;  // q = uv^2 (else dt * uv^2)
};

// Floats of the C interface's fold array (w, h0, h1, cu, cv, e, dt, au0,
// bv0, au, bv), in FoldConstants' order.
constexpr int FOLD_FLOATS = 25;

inline FoldConstants fold_constants(const float* f, int dt_is_one) {
  FoldConstants k;
  float* out[] = {k.w, &k.h0, &k.h1, &k.cu, &k.cv, &k.e, &k.dt, &k.au0,
                  &k.bv0, k.au, k.bv};
  const int len[] = {9, 1, 1, 1, 1, 1, 1, 1, 1, 4, 4};
  int i = 0;
  for (int p = 0; p < 11; ++p) {
    for (int j = 0; j < len[p]; ++j) out[p][j] = f[i++];
  }
  k.dt_is_one = dt_is_one;
  return k;
}

// The update of one cell from its raw sums and u-linear coefficients.
__device__ __forceinline__ void fold_update(float uc, float vc, float s_u,
                                            float s_v, float a, float b,
                                            const FoldConstants& k,
                                            float* un, float* vn) {
  const float uv_square = (uc * vc) * vc;
  const float q = k.dt_is_one ? uv_square : k.dt * uv_square;
  *un = ((k.cu * s_u - q) + k.e) + a * uc;
  *vn = (k.cv * s_v + q) + b * vc;
}

// The anchored gradient of a cell of row 0 (JAX's _edge_strip_1xc,
// pallas_stencil.py:139): at column 0 the 2x2 block of rows {0, 1} and
// columns {0, 1}; elsewhere rows {0, 1} of the centred window, the east
// tap's centre masked past the last column (ok_e). Window cell (lr, lc) of
// row pitch `pitch` lies at global (0, gc); cells outside the domain hold
// 0.0.
template <typename P>
__device__ __forceinline__ float fold_top(const float* win, P pitch, int lr,
                                          int lc, int gc, int cols,
                                          const FoldConstants& k) {
  const float x = win[lr * pitch + lc];
  float full = 0.0f;
  if (gc == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float w = k.w[3 * i + j];
        if (w == 0.0f) continue;
        full = full + w * (win[(lr + i) * pitch + lc + j] - x);
      }
    }
    return full;
  }
  const float ok_e = gc + 1 <= cols - 1 ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w = k.w[3 * i + j];
      if (w == 0.0f) continue;
      const float tap = win[(lr + i) * pitch + lc - 1 + j];
      full = full + w * (j == 2 ? tap - x * ok_e : tap - x);
    }
  }
  return full;
}

// The anchored gradient of a cell of column 0, row gr >= 1 (JAX's
// _left_col_strip, pallas_stencil.py:194): rows {gr-1, gr, gr+1} and
// columns {0, 1}, row by row, the bottom row's terms times ok_s (0.0 on the
// domain's last row).
template <typename P>
__device__ __forceinline__ float fold_left(const float* win, P pitch, int lr,
                                           int lc, int gr, int rows,
                                           const FoldConstants& k) {
  const float x = win[lr * pitch + lc];
  const float ok_s = gr <= rows - 2 ? 1.0f : 0.0f;
  float full = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float w = k.w[3 * i + j];
      if (w == 0.0f) continue;
      float term = w * (win[(lr - 1 + i) * pitch + lc + j] - x);
      if (i == 2) term = term * ok_s;
      full = full + term;
    }
  }
  return full;
}

// One cell of row 0 or column 0 (in the domain): the anchored gradient and
// the update with au0/bv0 (row 0 wins at (0, 0), as JAX selects it last).
template <typename P>
__device__ __forceinline__ void fold_strip_cell(const float* su,
                                                const float* sv, P pitch,
                                                int lr, int lc, int gr,
                                                int gc, int rows, int cols,
                                                const FoldConstants& k,
                                                float* un, float* vn) {
  const float uc = su[lr * pitch + lc], vc = sv[lr * pitch + lc];
  float s_u, s_v;
  if (gr == 0) {
    s_u = fold_top(su, pitch, lr, lc, gc, cols, k);
    s_v = fold_top(sv, pitch, lr, lc, gc, cols, k);
  } else {
    s_u = fold_left(su, pitch, lr, lc, gr, rows, k);
    s_v = fold_left(sv, pitch, lr, lc, gr, rows, k);
  }
  fold_update(uc, vc, s_u, s_v, k.au0, k.bv0, k, un, vn);
}

// The direct plan's raw sum of a cell from its 3x3 neighbourhood: every tap
// of nonzero weight, row-major, from 0.0.
template <int TAPS>
__device__ __forceinline__ float fold_direct(const float (&top)[3],
                                             const float (&mid)[3],
                                             const float (&bot)[3],
                                             const FoldConstants& k) {
  float full = 0.0f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float n = t < 3 ? top[t] : (t < 6 ? mid[t - 3] : bot[t - 6]);
    if (has_tap<TAPS>(k, t)) full = full + k.w[t] * n;
  }
  return full;
}

// The separable row pass of the cell at p: h1*x + h0*(xw + xe); *centre
// gets x.
__device__ __forceinline__ float row_pass(const float* p,
                                          const FoldConstants& k,
                                          float* centre) {
  *centre = p[0];
  return k.h1 * p[0] + k.h0 * (p[-1] + p[1]);
}

// step_strip for MODE_FOLD: cells (lr0 + i, lc), i < n <= R, each of whose
// taps lies in the window, to sink(i, un, vn). The separable pass keeps the
// row sums t of the rows above and at the cell in registers (one row pass
// a species a new row: 3 shared loads); a direct plan keeps the 3x3 window,
// as step_strip does. EDGE = false (an interior tile): every cell is of the
// bulk, in the middle rows and columns (au[0], bv[0]). EDGE = true: a cell
// outside the domain comes out as exactly 0.0, row 0 and column 0 take
// fold_strip_cell, the others the bulk with the coefficients of their row
// and column.
template <int TAPS, int R, bool EDGE, typename P, typename Sink>
__device__ __forceinline__ void step_strip_fold(const float* su,
                                                const float* sv, P pitch,
                                                int lr0, int lc, int n,
                                                const StripAt& at,
                                                const FoldConstants& k,
                                                Sink&& sink) {
  const bool col_inside = at.gc >= 0 && at.gc < at.cols;
  const bool last_col = at.gc == at.cols - 1;
  auto cell = [&](int i, float uc, float vc, float s_u, float s_v) {
    float un, vn;
    if (!EDGE) {
      fold_update(uc, vc, s_u, s_v, k.au[0], k.bv[0], k, &un, &vn);
    } else {
      const int gr = at.gr0 + i;
      if (!col_inside || gr < 0 || gr >= at.rows) {
        un = 0.0f;
        vn = 0.0f;
      } else if (gr == 0 || at.gc == 0) {
        fold_strip_cell(su, sv, pitch, lr0 + i, lc, gr, at.gc, at.rows,
                        at.cols, k, &un, &vn);
      } else {
        // (selects, not k.au[index]: an indexed kernel parameter would be
        // copied to the stack)
        const bool last_row = gr == at.rows - 1;
        const float a = last_row ? (last_col ? k.au[3] : k.au[2])
                                 : (last_col ? k.au[1] : k.au[0]);
        const float b = last_row ? (last_col ? k.bv[3] : k.bv[2])
                                 : (last_col ? k.bv[1] : k.bv[0]);
        fold_update(uc, vc, s_u, s_v, a, b, k, &un, &vn);
      }
    }
    sink(i, un, vn);
  };
  const float* pu = su + (lr0 - 1) * pitch + lc;
  const float* pv = sv + (lr0 - 1) * pitch + lc;
  if constexpr (TAPS == TAPS_SEPARABLE) {
    float uc, vc, u_next, v_next;  // the cell's centre, the next cell's
    float tu0 = row_pass(pu, k, &uc), tv0 = row_pass(pv, k, &vc);
    float tu1 = row_pass(pu + pitch, k, &uc);
    float tv1 = row_pass(pv + pitch, k, &vc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < n) {
        const float tu2 = row_pass(pu + (i + 2) * pitch, k, &u_next);
        const float tv2 = row_pass(pv + (i + 2) * pitch, k, &v_next);
        cell(i, uc, vc, k.h1 * tu1 + k.h0 * (tu0 + tu2),
             k.h1 * tv1 + k.h0 * (tv0 + tv2));
        tu0 = tu1;
        tu1 = tu2;
        tv0 = tv1;
        tv1 = tv2;
        uc = u_next;
        vc = v_next;
      }
    }
  } else {
    float u0[3] = {pu[-1], pu[0], pu[1]};
    float v0[3] = {pv[-1], pv[0], pv[1]};
    float u1[3] = {pu[pitch - 1], pu[pitch], pu[pitch + 1]};
    float v1[3] = {pv[pitch - 1], pv[pitch], pv[pitch + 1]};
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < n) {
        const float* qu = pu + (i + 2) * pitch;
        const float* qv = pv + (i + 2) * pitch;
        const float u2[3] = {qu[-1], qu[0], qu[1]};
        const float v2[3] = {qv[-1], qv[0], qv[1]};
        cell(i, u1[1], v1[1], fold_direct<TAPS>(u0, u1, u2, k),
             fold_direct<TAPS>(v0, v1, v2, k));
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

// Start loading the wr x pitch block of U and V whose cell (0, 0) lies at
// global (gr0, gc0), gc0 a multiple of 4, into su and sv (row pitch `pitch`,
// a multiple of 4, 16-byte aligned; each size Fixed or an int, gs_tile.cuh),
// in chunks of 4 cells, from buffers laid out as `mem` says (gs_tile.cuh:
// FlatLayout, ShardLayout); cells outside the domain, and cells the buffer
// does not hold, as 0.0. `aligned`: the layout's rows and the u, v pointers
// are 16-byte aligned, and the layout's held columns start and end on
// multiples of 4. COHERENT: the block may read what other blocks wrote
// earlier in the same launch, so no copy may go through L1 (4-byte cp.async
// is .ca only): the ragged cells load with __ldcg instead. The copies land
// after cp_async_commit() and cp_async_wait(), and are visible to the block
// after a __syncthreads().
template <int NT, bool COHERENT, typename Layout, typename WR, typename P>
__device__ __forceinline__ void load_window(const Layout& mem, const float* u,
                                            const float* v, float* su,
                                            float* sv, WR wr, P pitch,
                                            int gr0, int gc0, int rows,
                                            int cols, bool aligned) {
  const int nch = pitch / 4;
  for (int idx = threadIdx.x; idx < wr * nch; idx += NT) {
    const int lr = idx / nch, q = idx - lr * nch;
    const int gr = gr0 + lr, gc = gc0 + 4 * q;
    float* du = su + lr * pitch + 4 * q;
    float* dv = sv + lr * pitch + 4 * q;
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

// load_window for bfloat16 storage, in chunks of 8 cells (pitch a multiple
// of 8; gc0 a multiple of 8): each cell widened exactly to float32 on its
// way into the window. `aligned`: the layout's rows and the u, v pointers
// are 16-byte aligned, and the layout's held columns start and end on
// multiples of 8. The loads go through registers (there is no 2-byte
// cp.async): the window is in place, for the block, after the caller's
// __syncthreads(); the caller's cp.async commit and wait find no copy in
// flight. COHERENT: loads through L2 only (__ldcg), else through the
// read-only path (__ldg).
template <int NT, bool COHERENT, typename Layout, typename WR, typename P>
__device__ __forceinline__ void load_window(const Layout& mem, const bf16* u,
                                            const bf16* v, float* su,
                                            float* sv, WR wr, P pitch,
                                            int gr0, int gc0, int rows,
                                            int cols, bool aligned) {
  const int n8 = pitch / 8;
  for (int idx = threadIdx.x; idx < wr * n8; idx += NT) {
    const int lr = idx / n8, q = idx - lr * n8;
    const int gr = gr0 + lr, gc = gc0 + 8 * q;
    float* du = su + lr * pitch + 8 * q;
    float* dv = sv + lr * pitch + 8 * q;
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
  // one window buffer of both species, and time_block's two
  static constexpr size_t PAIR_BYTES = 2 * sizeof(float) * CELLS;
  static constexpr size_t BYTES = 2 * PAIR_BYTES;
  // blocks an SM: as many as the 227 KB of shared memory hold
  static constexpr int MIN_BLOCKS = BYTES <= 113 * 1024 ? 2 : 1;
  // blocks an SM at 64 registers a thread (the megakernels' bound: the
  // 64^2 tiles' two blocks, and four of the 32^2 tiles where, left at two,
  // ptxas takes up to 109 registers)
  static constexpr int BLOCKS_AT_64_REGS = 65536 / (64 * NT);
  // blocks an SM at 128 registers a thread: the bound of the ring's first
  // form (its ablation parts), whose buffers leave room for at most that
  // many blocks an SM on Main (mega_depth 3: 204,800 B) and, at depths 4
  // and 5, on Small
  static constexpr int BLOCKS_AT_128_REGS = 65536 / (128 * NT);
  // a thread's strips of the widest step in place (ring_items; the ring's
  // ablation parts 5-7)
  static constexpr int RING_ITEMS =
      ((WC - 2) * ((WR - 2 + R - 1) / R) + NT - 1) / NT;
  static_assert(WC % 4 == 0 && HALO % 4 == 0, "16-byte window rows");
};

// K1's tile: 64^2 in an 80^2 window, 512 threads, strips of 4 (PERF.md §6).
using Main = Geometry<64, 64, 512, 4>;
// The former tile: 32^2 in a 48^2 window, 256 threads.
using Small = Geometry<32, 32, 256, 4>;
// Main's and Small's tiles on twice the threads: the window ring's (a ring
// leaves one block an SM on Main, at most two on Small, so that the SM
// keeps the double buffer's 32 warps at 64 registers a thread)
using MainWide = Geometry<64, 64, 1024, 4>;
using SmallWide = Geometry<32, 32, 512, 4>;

// A geometry's sizes as values, the form step_window, window_inside and
// store_window take: Fixed sizes for a compiled geometry G (the window's
// row pitch its width), ints for a pinned one (PinGeometry). NT and R are
// compile-time in both.
template <typename G>
struct FixedShape {
  static constexpr int NT = G::NT, R = G::R;
  Fixed<G::TR> tr;
  Fixed<G::TC> tc;
  Fixed<HALO> halo;
  Fixed<G::WR> wr;
  Fixed<G::WC> wc;
  Fixed<G::WC> pitch;
  Fixed<G::CELLS> cells;
};

// One step of the window cells [lo, g.wr - lo) x [lo, g.wc - lo), in strips
// of S::R cells, from (in_u, in_v) into (out_u, out_v); the window's cell
// (0, 0) lies at global (r0, c0) of the rows x cols domain. INTERIOR: the
// window lies inside the domain. MODE: MODE_ZERO or MODE_NAIVE (the
// oracle's tree, K = Constants), or MODE_FOLD (the folded naive reaction,
// K = FoldConstants, TAPS its sum's: TAPS_SEPARABLE or a direct plan's
// set).
template <int TAPS, int MODE, bool INTERIOR, typename S, typename K>
__device__ __forceinline__ void step_window(const S& g, const float* in_u,
                                            const float* in_v, float* out_u,
                                            float* out_v, int lo, int r0,
                                            int c0, int rows, int cols,
                                            const K& k) {
  const int hi_r = g.wr - lo, ncols = g.wc - 2 * lo;
  const int items = ncols * ((hi_r - lo + S::R - 1) / S::R);
  for (int it = threadIdx.x; it < items; it += S::NT) {
    const int strip = it / ncols;
    const int lc = lo + (it - strip * ncols), lr0 = lo + strip * S::R;
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
  }
}

// Whether the window of g whose cell (0, 0) lies at global (r0, c0) lies
// inside the rows x cols domain.
template <typename S>
__device__ __forceinline__ bool window_inside(const S& g, int r0, int c0,
                                              int rows, int cols) {
  return r0 >= 0 && c0 >= 0 && r0 + g.wr <= rows && c0 + g.wc <= cols;
}

// Write the tile of the window (fu, fv) of g, whose cell (0, 0) lies at
// global (r0, c0), to (u_out, v_out): the cells in the domain that `mem`
// stores, each rounded to T.
template <typename S, typename Layout, typename T>
__device__ __forceinline__ void store_window(const S& g, const Layout& mem,
                                             T* u_out, T* v_out,
                                             const float* fu, const float* fv,
                                             int r0, int c0, int rows,
                                             int cols) {
  for (int idx = threadIdx.x; idx < g.tr * g.tc; idx += S::NT) {
    const int lr = g.halo + idx / g.tc, lc = g.halo + idx % g.tc;
    const int gr = r0 + lr, gc = c0 + lc;
    if (gr < rows && gc < cols && mem.stores(gr, gc)) {
      const size_t at = mem.at(gr, gc);
      u_out[at] = narrow<T>(fu[lr * g.pitch + lc]);
      v_out[at] = narrow<T>(fv[lr * g.pitch + lc]);
    }
  }
}

// A megakernel's per-tile work, which both walks of a time block
// (time_block's double buffer, ring_walk's ring) run on window buffers at
// `base` (each 2 * g.cells floats: U then V) of the geometry g (FixedShape
// of a compiled one, or PinGeometry), for the tile whose window starts at
// global (r0, c0), the halo included.

// Start loading the tile's window into buffer b, committed as one cp.async
// group (through registers where the storage is narrower than float).
template <typename S, typename Layout, typename T>
__device__ __forceinline__ void window_load(const S& g, const Layout& mem,
                                            const T* u, const T* v,
                                            float* base, int b, int r0,
                                            int c0, int rows, int cols,
                                            bool aligned) {
  float* su = base + 2 * b * g.cells;
  load_window<S::NT, true>(mem, u, v, su, su + g.cells, g.wr, g.pitch, r0,
                           c0, rows, cols, aligned);
  cp_async_commit();
}

// How window_steps steps an interior window: step_window's strips (K7's
// read-site split passes gs_pin_sm90.cuh's 4x4 register blocks:
// splits/sharded_mega_ablation.cu).
template <int TAPS, int MODE>
struct StripSteps {
  template <typename S, typename K>
  __device__ __forceinline__ static void interior(const S& g,
                                                  const float* in_u,
                                                  const float* in_v,
                                                  float* out_u, float* out_v,
                                                  int lo, int r0, int c0,
                                                  int rows, int cols,
                                                  const K& k) {
    step_window<TAPS, MODE, true>(g, in_u, in_v, out_u, out_v, lo, r0, c0,
                                  rows, cols, k);
  }
};

// The tile's `steps` steps between buffer `done` (its window) and `other`,
// each followed by a __syncthreads(); `interior`: its window lies in the
// domain (no boundary selects), stepped by STEPS<TAPS, MODE>::interior.
// Returns the buffer that holds the result.
template <int TAPS, int MODE, template <int, int> class STEPS = StripSteps,
          typename S, typename K>
__device__ __forceinline__ int window_steps(const S& g, float* base,
                                            int done, int other, int steps,
                                            bool interior, int r0, int c0,
                                            int rows, int cols, const K& k) {
  for (int st = 0; st < steps; ++st) {
    const float* in_u = base + 2 * done * g.cells;
    float* out_u = base + 2 * other * g.cells;
    if (interior) {
      STEPS<TAPS, MODE>::interior(g, in_u, in_u + g.cells, out_u,
                                  out_u + g.cells, st + 1, r0, c0, rows,
                                  cols, k);
    } else {
      step_window<TAPS, MODE, false>(g, in_u, in_u + g.cells, out_u,
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

// Write the tile out from buffer b: the cells in the domain that `mem`
// stores.
template <typename S, typename Layout, typename T>
__device__ __forceinline__ void window_store(const S& g, const Layout& mem,
                                             T* u_out, T* v_out,
                                             const float* base, int b,
                                             int r0, int c0, int rows,
                                             int cols) {
  const float* fu = base + 2 * b * g.cells;
  store_window(g, mem, u_out, v_out, fu, fu + g.cells, r0, c0, rows, cols);
}

// One tile of K1 (windowed.cu, and its pinned and folded entries in
// windowed_pins.cu): the tile of g whose window starts at global (r0, c0)
// advanced by `steps` (1..g.halo) steps from (u, v) into (u_out, v_out),
// both laid out as `mem` says, through two window buffers at `base`
// (dynamic shared memory, 4 * g.cells floats). Nothing writes (u, v) in
// the launch, so the ragged cells' copies may go through L1. SPECIALIZE =
// false takes every tile as an edge tile (an ablation).
template <int TAPS, int MODE, bool SPECIALIZE, typename S, typename Layout,
          typename T, typename K>
__device__ __forceinline__ void window_multistep_on(
    const S& g, const Layout& mem, const T* u, const T* v, T* u_out,
    T* v_out, int r0, int c0, int rows, int cols, int steps, const K& k,
    bool aligned, float* base) {
  load_window<S::NT, false>(mem, u, v, base, base + g.cells, g.wr, g.pitch,
                            r0, c0, rows, cols, aligned);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const bool interior = SPECIALIZE && window_inside(g, r0, c0, rows, cols);
  int cur = 0;
  for (int st = 0; st < steps; ++st) {
    const float* in_u = base + 2 * cur * g.cells;
    float* out_u = base + 2 * (cur ^ 1) * g.cells;
    if (interior) {
      step_window<TAPS, MODE, true>(g, in_u, in_u + g.cells, out_u,
                                    out_u + g.cells, st + 1, r0, c0, rows,
                                    cols, k);
    } else {
      step_window<TAPS, MODE, false>(g, in_u, in_u + g.cells, out_u,
                                     out_u + g.cells, st + 1, r0, c0, rows,
                                     cols, k);
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* fu = base + 2 * cur * g.cells;
  store_window(g, mem, u_out, v_out, fu, fu + g.cells, r0, c0, rows, cols);
}

// One block of K1 (windowed.cu, and its pinned entries in windowed_pins.cu):
// tile (blockIdx.y, blockIdx.x) of g of the row-major rows x cols domain
// (window_multistep_on).
template <int TAPS, int MODE, bool SPECIALIZE, typename S, typename T,
          typename K>
__device__ __forceinline__ void window_multistep(const S& g, const T* u,
                                                 const T* v, T* u_out,
                                                 T* v_out, int rows, int cols,
                                                 int steps, const K& k,
                                                 bool aligned, float* base) {
  window_multistep_on<TAPS, MODE, SPECIALIZE>(
      g, FlatLayout{cols}, u, v, u_out, v_out, blockIdx.y * g.tr - g.halo,
      blockIdx.x * g.tc - g.halo, rows, cols, steps, k, aligned, base);
}

// One block of K1's folded entry (windowed_pins.cu; the lane fold): tile
// (blockIdx.y, blockIdx.x) of g of panel blockIdx.z of a folded state,
// (g.halo + rp + g.halo) rows of `panels` * cols floats, panel p's cells
// at columns [p * cols, (p + 1) * cols) and its interior rows global rows
// [p * rp, (p + 1) * rp), its halo rows its neighbours' cells
// (grayscott_tpu_torch/ops/lane_fold.py). The panel is a shard of the
// rows x cols domain at global origin (p * rp, 0) (gs::ShardLayout, held
// columns [0, cols)), so each tile steps at its global place: a cell right
// of a panel's last column is outside the domain, and loads as 0.0, for
// that panel's cells, per cell; global row 0 exists in panel 0 only; rows
// at or past `rows` load as 0.0 and are not stored. A tile of dead rows
// only returns at once. rp is a multiple of g.tr.
template <int TAPS, int MODE, typename S, typename T, typename K>
__device__ __forceinline__ void panel_window_multistep(
    const S& g, const T* u, const T* v, T* u_out, T* v_out, int rows,
    int cols, int panels, int rp, int steps, const K& k, bool aligned,
    float* base) {
  const int row0 = blockIdx.z * rp;
  if (row0 + static_cast<int>(blockIdx.y) * g.tr >= rows) return;
  const ShardLayout mem = {row0,   0, rp, cols, g.halo, 0,
                           static_cast<size_t>(panels) * cols};
  const size_t at = static_cast<size_t>(blockIdx.z) * cols;
  window_multistep_on<TAPS, MODE, true>(
      g, mem, u + at, v + at, u_out + at, v_out + at,
      row0 + blockIdx.y * g.tr - g.halo, blockIdx.x * g.tc - g.halo, rows,
      cols, steps, k, aligned, base);
}

// The shards of a launch of K1's shard entry (windowed.cu, and its pinned
// twin in windowed_pins.cu): the pairs' geometry, the source slot, the
// tiles of the part (windowed.cu's note), and where the launch's block of
// n_rows x n_cols shards sits in the mesh (row0, col0: the mesh row and
// column of its first shard; 0 when one process holds the whole mesh).
template <typename T>
struct Shards {
  T *u_pairs, *v_pairs;
  int n_cols, r_loc, c_loc, chalo, src, part, ti0, ti1, tj0, tj1;
  int row0, col0;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// One block of K1's shard entry: tile (blockIdx.y, blockIdx.x) of g (of
// the part's rectangle when part is 1) of shard blockIdx.z of the launch's
// block (row-major; its global origin from the block's place in the mesh,
// s.row0 and s.col0, so the interior test and the naive clamp see the
// domain as one process holding every shard would), advanced by
// `steps` (1..g.halo) steps from slot s.src into the interior of slot
// 1 - s.src. The pairs hold g.halo rows (and s.chalo columns) of the
// neighbours' cells around each interior: the layout's halo is the
// window's.
template <int TAPS, int MODE, typename S, typename T>
__device__ __forceinline__ void shard_window_multistep(
    const S& g, const Shards<T>& s, int rows, int cols, int steps,
    const Constants& k, float* base) {
  const int inner = s.part == 1;
  const int ti = blockIdx.y + (inner ? s.ti0 : 0);
  const int tj = blockIdx.x + (inner ? s.tj0 : 0);
  if (s.part == 2 && ti >= s.ti0 && ti < s.ti1 && tj >= s.tj0 &&
      tj < s.tj1) {
    return;  // an overlap-interior tile: part 1's
  }
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
  const T* u = s.u_pairs + (2 * sh + s.src) * plane;
  const T* v = s.v_pairs + (2 * sh + s.src) * plane;
  T* u_out = s.u_pairs + (2 * sh + 1 - s.src) * plane;
  T* v_out = s.v_pairs + (2 * sh + 1 - s.src) * plane;
  const bool aligned = pitch % vec_cells<T>() == 0 && aligned16(u) &&
                       aligned16(v) && aligned16(u_out) && aligned16(v_out);
  const int r0 = mem.row0 + ti * g.tr - g.halo;
  const int c0 = mem.col0 + tj * g.tc - g.halo;

  load_window<S::NT, true>(mem, u, v, base, base + g.cells, g.wr, g.pitch,
                           r0, c0, rows, cols, aligned);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const bool interior = window_inside(g, r0, c0, rows, cols);
  int cur = 0;
  for (int st = 0; st < steps; ++st) {
    const float* in_u = base + 2 * cur * g.cells;
    float* out_u = base + 2 * (cur ^ 1) * g.cells;
    if (interior) {
      step_window<TAPS, MODE, true>(g, in_u, in_u + g.cells, out_u,
                                    out_u + g.cells, st + 1, r0, c0, rows,
                                    cols, k);
    } else {
      step_window<TAPS, MODE, false>(g, in_u, in_u + g.cells, out_u,
                                     out_u + g.cells, st + 1, r0, c0, rows,
                                     cols, k);
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* fu = base + 2 * cur * g.cells;
  const float* fv = fu + g.cells;
  for (int idx = threadIdx.x; idx < g.tr * g.tc; idx += S::NT) {
    const int lr = g.halo + idx / g.tc, lc = g.halo + idx % g.tc;
    const int gr = r0 + lr, gc = c0 + lc;
    if (mem.stores(gr, gc)) {
      const size_t at = mem.at(gr, gc);
      const bool in = gr < rows && gc < cols;
      u_out[at] = narrow<T>(in ? fu[lr * g.pitch + lc] : 0.0f);
      v_out[at] = narrow<T>(in ? fv[lr * g.pitch + lc] : 0.0f);
    }
  }
}

// time_block's default gate: loads wait for nothing.
struct NoGate {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// One time block of a megakernel (K2, K7) on the tiles of g (FixedShape of
// a compiled geometry, or the PinGeometry of the megakernels' tile pins):
// the block advances tiles first, first + stride, ... (< n_tiles) of a grid
// tiles_x tiles wide, whose tile (0, 0) starts at global (row0, col0), by
// `steps` (1..g.halo) steps from (u, v) into (u_out, v_out), both laid out
// as `mem` says, through two window buffers at `base` (dynamic shared
// memory). Reads are coherent (the state was written by other blocks
// before the caller's barrier); only the cells in the domain that `mem`
// stores are written.
//
// PREFETCH: once a tile's last step is done the buffer that held that step's
// input is free, and the next tile's window starts loading into it before
// the finished tile is written out. The first tile loads when the call
// begins, so no load crosses the caller's barrier. Returns after a
// __syncthreads() unless PREFETCH, whose buffers are free once every thread
// is past the caller's next barrier. gate(i, stride) runs before each
// window load, block-wide (K7's read-site wait; NoGate elsewhere). STEPS:
// how an interior tile steps (window_steps).
template <int TAPS, int MODE, bool SPECIALIZE, bool PREFETCH,
          template <int, int> class STEPS = StripSteps, typename S,
          typename Layout, typename T, typename K, typename Gate = NoGate>
__device__ __forceinline__ void time_block_on(
    const S& g, const Layout& mem, const T* u, const T* v, T* u_out,
    T* v_out, int first, int stride, int n_tiles, int tiles_x, int row0,
    int col0, int rows, int cols, int steps, const K& k, bool aligned,
    float* base, const Gate& gate = Gate()) {
  auto load = [&](int i, int b) {
    gate(i, stride);
    const int ti = i / tiles_x, tj = i - ti * tiles_x;
    window_load(g, mem, u, v, base, b, row0 + ti * g.tr - g.halo,
                col0 + tj * g.tc - g.halo, rows, cols, aligned);
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
    const int r0 = row0 + ti * g.tr - g.halo;
    const int c0 = col0 + tj * g.tc - g.halo;
    const bool interior =
        SPECIALIZE && window_inside(g, r0, c0, rows, cols);
    const int done = window_steps<TAPS, MODE, STEPS>(
        g, base, win, (win + 1) % 2, steps, interior, r0, c0, rows, cols, k);
    if (PREFETCH && next < n_tiles) load(next, done ^ 1);
    window_store(g, mem, u_out, v_out, base, done, r0, c0, rows, cols);
    if (PREFETCH) {
      win = done ^ 1;
    } else {
      __syncthreads();  // the buffers are free for the next window
    }
    i = next;
  }
}

// time_block_on on the compiled geometry G.
template <typename G, int TAPS, int MODE, bool SPECIALIZE, bool PREFETCH,
          typename Layout, typename T, typename K, typename Gate = NoGate>
__device__ __forceinline__ void time_block(
    const Layout& mem, const T* u, const T* v, T* u_out,
    T* v_out, int first, int stride, int n_tiles, int tiles_x, int row0,
    int col0, int rows, int cols, int steps, const K& k,
    bool aligned, float* base, const Gate& gate = Gate()) {
  time_block_on<TAPS, MODE, SPECIALIZE, PREFETCH>(
      FixedShape<G>{}, mem, u, v, u_out, v_out, first, stride, n_tiles,
      tiles_x, row0, col0, rows, cols, steps, k, aligned, base, gate);
}

// --- the window ring (mega_depth; K2) --------------------------------------
//
// grayscott_tpu/ops/megakernel.py:_mega_kernel(depth=D) keeps D window slots
// and D - 1 window loads in flight ahead of the window it steps
// (:562-630). Here a ring of D slots needs one more buffer, the step's
// scratch (a step writes the other buffer, not in place): nbuf = D + 1
// buffers of a window pair, D - 1 windows in flight while a tile steps and D
// while it is written out (ring_walk, RING_SCRATCH). Its bytes leave one
// block an SM on Main's tiles and at most two on Small's, so the ring's
// kernels run twice the double buffer's threads a block (MainWide,
// SmallWide, 64 registers a thread), or the pinned tiles' two blocks where
// the bytes leave room for them. The ring with each tile stepped in place
// in its own buffer (RING_IN_PLACE, D buffers: step_window_in_place) took
// 1.14-1.33x the scratch walk's time on the same tile and grid (PERF.md
// §6) and is an ablation part (splits/mega_ring_ablation.cu), as are the first
// form's walks. D = 2 is time_block's double buffer (two buffers; the next
// window loads during the write-out), which K2 and K7 keep as their own
// walk. K6 runs only the double buffer: JAX's packed megakernel takes no
// depth (packed_megastep_impl, megakernel.py:1112).

// The most dynamic shared memory one block may opt into on the card
// (Hopper: 227 KB).
constexpr size_t SMEM_OPTIN = 232448;
// The most buffers of a ring: mega_depth 8's slots and the scratch.
constexpr int RING_MAX_BUFFERS = 9;

// The most ring buffers of geometry G that one block's shared memory holds.
template <typename G>
__host__ __device__ constexpr int ring_max_buffers() {
  return SMEM_OPTIN / G::PAIR_BYTES < RING_MAX_BUFFERS
             ? static_cast<int>(SMEM_OPTIN / G::PAIR_BYTES)
             : RING_MAX_BUFFERS;
}

// The ring's walks (ring_walk's FORM): the entries' and the ablation
// parts'.
constexpr int RING_SCRATCH = 0;     // D + 1 buffers, a step writes the other
constexpr int RING_IN_PLACE = 1;    // D buffers, each tile stepped in place
constexpr int RING_LOAD_STORE = 2;  // RING_SCRATCH's loads and stores alone
constexpr int RING_WAIT_ALL = 3;    // RING_SCRATCH, every load waited for
                                    // before each tile's steps

// The strip items of a window's widest step (its first: cells [1, wr - 1) x
// [1, wc - 1) in strips of S::R rows), which step_window_in_place holds in
// registers, ring_items(g) / S::NT rounded up a thread.
template <typename S>
__host__ __device__ inline int ring_items(const S& g) {
  return (static_cast<int>(g.wc) - 2) *
         ((static_cast<int>(g.wr) - 2 + S::R - 1) / S::R);
}

// One step of the window cells [lo, g.wr - lo) x [lo, g.wc - lo) of (u, v)
// in place: step_window's strips, each thread's up to ITEMS strips (items
// threadIdx.x + q * S::NT) computed into registers, a __syncthreads() so
// that every read of the step is done, then written back over their inputs.
// ITEMS * S::NT must cover the step's strips (ring_items). An interior
// tile's strips are unrolled, each into its own registers; an edge tile's
// run in a loop (their per-cell code once, which keeps the build in
// bounds), each strip's outputs pushed onto held[0] and the older ones
// moved down, then popped in the reverse order for the write-back.
template <int TAPS, int MODE, bool INTERIOR, int ITEMS, typename S,
          typename K>
__device__ __forceinline__ void step_window_in_place(const S& g, float* u,
                                                     float* v, int lo,
                                                     int r0, int c0,
                                                     int rows, int cols,
                                                     const K& k) {
  const int hi_r = g.wr - lo, ncols = g.wc - 2 * lo;
  const int items = ncols * ((hi_r - lo + S::R - 1) / S::R);
  const int tid = threadIdx.x;
  // strip `it`: its first row, its column and its cells
  auto strip_at = [&](int it, int* lr0, int* lc, int* n) {
    const int strip = it / ncols;
    *lc = lo + (it - strip * ncols);
    *lr0 = lo + strip * S::R;
    *n = min(S::R, hi_r - *lr0);
  };
  auto compute = [&](int it, float (&out)[S::R][2]) {
    int lr0, lc, n;
    strip_at(it, &lr0, &lc, &n);
    const StripAt at = {r0 + lr0, c0 + lc, rows, cols};
    auto sink = [&](int i, float un, float vn) {
      out[i][0] = un;
      out[i][1] = vn;
    };
    if constexpr (MODE == MODE_FOLD) {
      step_strip_fold<TAPS, S::R, !INTERIOR>(u, v, g.pitch, lr0, lc, n, at,
                                             k, sink);
    } else {
      step_strip<TAPS, MODE == MODE_NAIVE, S::R, !INTERIOR>(
          u, v, g.pitch, lr0, lc, n, at, k, sink);
    }
  };
  auto put = [&](int it, const float (&out)[S::R][2]) {
    int lr0, lc, n;
    strip_at(it, &lr0, &lc, &n);
#pragma unroll
    for (int i = 0; i < S::R; ++i) {
      if (i < n) {
        u[(lr0 + i) * g.pitch + lc] = out[i][0];
        v[(lr0 + i) * g.pitch + lc] = out[i][1];
      }
    }
  };
  float held[ITEMS][S::R][2];
  if constexpr (INTERIOR) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (tid + q * S::NT < items) compute(tid + q * S::NT, held[q]);
    }
    __syncthreads();  // every read of the step is done
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (tid + q * S::NT < items) put(tid + q * S::NT, held[q]);
    }
  } else {
    auto shift = [&](int from, int to) {
#pragma unroll
      for (int i = 0; i < S::R; ++i) {
        held[to][i][0] = held[from][i][0];
        held[to][i][1] = held[from][i][1];
      }
    };
    int count = 0;
#pragma unroll 1
    for (int q = 0; q < ITEMS && tid + q * S::NT < items; ++q) {
#pragma unroll
      for (int c = ITEMS - 1; c > 0; --c) shift(c - 1, c);
      compute(tid + q * S::NT, held[0]);
      ++count;
    }
    __syncthreads();  // every read of the step is done
#pragma unroll 1
    for (int q = count - 1; q >= 0; --q) {
      put(tid + q * S::NT, held[0]);
#pragma unroll
      for (int c = 0; c + 1 < ITEMS; ++c) shift(c + 1, c);
    }
  }
}

// window_steps in place: the tile's `steps` steps in buffer b, each followed
// by a __syncthreads().
template <int TAPS, int MODE, int ITEMS, typename S, typename K>
__device__ __forceinline__ void window_steps_in_place(
    const S& g, float* base, int b, int steps, bool interior, int r0, int c0,
    int rows, int cols, const K& k) {
  float* u = base + 2 * b * g.cells;
  for (int st = 0; st < steps; ++st) {
    if (interior) {
      step_window_in_place<TAPS, MODE, true, ITEMS>(g, u, u + g.cells, st + 1,
                                                    r0, c0, rows, cols, k);
    } else {
      step_window_in_place<TAPS, MODE, false, ITEMS>(
          g, u, u + g.cells, st + 1, r0, c0, rows, cols, k);
    }
    __syncthreads();
  }
}

// cp_async_wait<N> for a run-time N (0..RING_MAX_BUFFERS - 2; more waits as
// for the largest).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// One time block's walk of the block's tiles first, first + stride, ...
// (< n_tiles), numbered j = 0, 1, ..., through a ring of `nbuf` (2 ..
// RING_MAX_BUFFERS) buffers. The first nbuf - 1 windows load when the call
// begins, so no load crosses the caller's barrier, and none is issued for a
// tile of the next time block.
//
//   load(i, b):    start loading tile i's window into buffer b, and commit
//                  it as one cp.async group (or load it through registers);
//   run(i, b, s):  tile i's `steps` steps from buffer b (its window), each
//                  followed by a __syncthreads(): in place (s == b, FORM
//                  RING_IN_PLACE), or between b and the scratch s;
//   store(i, b):   write tile i out from buffer b.
//
// ops/megakernel.py:ring_walk_plan is the CPU twin of both walks.
//
// RING_SCRATCH and its ablations: with m = nbuf - steps % 2, tile j's window
// lies in buffer j % m, and its scratch is buffer m (odd steps: the result
// ends in the scratch, and the window's buffer is free) or (j - 1) % m (even
// steps: the result ends in the window's buffer, and the scratch is free).
// The buffer that a tile's last step read is free once that step's barrier
// is passed, and takes the window nbuf - 1 tiles ahead, which the rule
// gives it in both cases; the tile's result is the next tile's scratch,
// written only after the barrier that follows the write-out. nbuf - 2 loads
// are in flight while a tile steps (none for RING_WAIT_ALL), nbuf - 1 while
// it is written out. RING_LOAD_STORE calls run with no step (steps 0).
//
// RING_IN_PLACE: tile j's window lies in buffer j % nbuf and its result
// stays there. Once every thread is past the barrier that opens tile j,
// tile j - 1's write-out is done and its buffer, (j - 1) % nbuf, takes the
// window nbuf - 1 tiles ahead: nbuf - 1 loads are in flight while a tile
// steps, nbuf - 2 at the wait.
//
// Returns without a trailing __syncthreads(): the buffers are free once
// every thread is past the caller's next barrier.
template <int FORM, typename Load, typename Run, typename Store>
__device__ __forceinline__ void ring_walk(int first, int stride, int n_tiles,
                                          int steps, int nbuf, Load&& load,
                                          Run&& run, Store&& store) {
  const int n = first < n_tiles ? (n_tiles - 1 - first) / stride + 1 : 0;
  for (int j = 0; j < nbuf - 1 && j < n; ++j) load(first + j * stride, j);
  if constexpr (FORM != RING_IN_PLACE) {
    const int odd = FORM == RING_LOAD_STORE ? 0 : steps & 1;
    const int m = nbuf - odd;
    int b = 0;  // j % m
    for (int j = 0; j < n; ++j) {
      const int i = first + j * stride;
      if (FORM == RING_WAIT_ALL) {
        cp_async_wait<0>();
      } else {
        // the windows of tiles j + 1 .. j + nbuf - 2 may stay in flight
        cp_async_wait_upto(min(nbuf - 2, n - 1 - j));
      }
      __syncthreads();  // tile j's window is in place
      const int s = odd ? m : (b == 0 ? m - 1 : b - 1);
      if (FORM != RING_LOAD_STORE) run(i, b, s);
      const int done = odd ? s : b;
      if (j + nbuf - 1 < n) load(i + (nbuf - 1) * stride, odd ? b : s);
      store(i, done);
      b = b + 1 == m ? 0 : b + 1;
    }
  } else {
    int b = 0;  // j % nbuf
    for (int j = 0; j < n; ++j) {
      const int i = first + j * stride;
      // the windows of tiles j + 1 .. j + nbuf - 2 may stay in flight
      cp_async_wait_upto(min(nbuf - 2, n - 1 - j));
      __syncthreads();  // tile j's window is in place, tile j - 1 written
      if (j + nbuf - 1 < n) {
        load(i + (nbuf - 1) * stride, b == 0 ? nbuf - 1 : b - 1);
      }
      run(i, b, b);
      store(i, b);
      b = b + 1 == nbuf ? 0 : b + 1;
    }
  }
}

// time_block's time block (K2) on a ring of `nbuf` buffers of g at `base`
// (FixedShape of a compiled geometry, or the PinGeometry of the tile pins):
// ring_walk of FORM with time_block's window load, steps (interior tiles
// specialised; in place on ITEMS strips a thread for RING_IN_PLACE) and
// write-out.
template <int TAPS, int MODE, int FORM, int ITEMS, typename S,
          typename Layout, typename T, typename K>
__device__ __forceinline__ void ring_time_block_on(
    const S& g, const Layout& mem, const T* u, const T* v, T* u_out,
    T* v_out, int first, int stride, int n_tiles, int tiles_x, int row0,
    int col0, int rows, int cols, int steps, const K& k, bool aligned,
    int nbuf, float* base) {
  auto corner = [&](int i, int* r0, int* c0) {
    const int ti = i / tiles_x, tj = i - ti * tiles_x;
    *r0 = row0 + ti * g.tr - g.halo;
    *c0 = col0 + tj * g.tc - g.halo;
  };
  auto load = [&](int i, int b) {
    int r0, c0;
    corner(i, &r0, &c0);
    window_load(g, mem, u, v, base, b, r0, c0, rows, cols, aligned);
  };
  auto run = [&](int i, int b, int s) {
    int r0, c0;
    corner(i, &r0, &c0);
    const bool interior = window_inside(g, r0, c0, rows, cols);
    if constexpr (FORM == RING_IN_PLACE) {
      window_steps_in_place<TAPS, MODE, ITEMS>(g, base, b, steps, interior,
                                               r0, c0, rows, cols, k);
    } else {
      window_steps<TAPS, MODE>(g, base, b, s, steps, interior, r0, c0, rows,
                               cols, k);
    }
  };
  auto store = [&](int i, int b) {
    int r0, c0;
    corner(i, &r0, &c0);
    window_store(g, mem, u_out, v_out, base, b, r0, c0, rows, cols);
  };
  ring_walk<FORM>(first, stride, n_tiles, steps, nbuf, load, run, store);
}

// --- pinned geometries (K1's and K4's tile and depth pins) ------------------
//
// --pallas-block-rows, --pallas-block-cols and --pallas-steps-per-call
// (grayscott_tpu_torch/ops/geometry.py; grayscott_tpu/backends/pallas.py:
// 84-99, :270-313): tr x tc tiles in windows of `halo` cells more on every
// side, halo = halo_for_steps(K) (8, 16, 24 or 32), all known at run time,
// with Main's threads and strip length. A window's rows lie `pitch` floats
// apart, its width rounded up to 8, so that each row starts 32-byte aligned
// for the chunked loads; the columns past the window's width load and are
// never read. The steppers, window loads and stores are the compiled
// geometries' own, called with int sizes (FixedShape's members).

// The most steps a pinned launch takes (JAX's MAX_STEPS_PER_CALL).
constexpr int PIN_MAX_STEPS = 32;

// A pinned launch's tiles, halo and windows (pin_geometry).
struct PinGeometry {
  static constexpr int NT = Main::NT, R = Main::R;
  int tr, tc, halo, wr, wc, pitch, cells;
};

// A pinned geometry stepped by twice Main's threads (the window ring where
// its bytes leave one block an SM: mega_pins_ring.cu).
struct PinGeometryWide {
  static constexpr int NT = 2 * Main::NT, R = Main::R;
  int tr, tc, halo, wr, wc, pitch, cells;
};

// A thread's strips of the widest in-place step of a pinned ring of Main's
// threads (the ring's ablation parts 5-7): 5 covers every ring of at least
// 3 buffers that a block's shared memory holds (at most 2,388 strips: 8x384
// tiles), 3 every ring that leaves room for two blocks an SM (at most
// 1,188); the ablation's C interface checks ring_items.
constexpr int PIN_RING_ITEMS = 5;
constexpr int PIN_RING_ITEMS_2 = 3;

inline PinGeometry pin_geometry(int tr, int tc, int halo) {
  const int wc = tc + 2 * halo, pitch = (wc + 7) / 8 * 8;
  const int wr = tr + 2 * halo;
  return {tr, tc, halo, wr, wc, pitch, wr * pitch};
}

// Dynamic shared memory of a pinned launch: two buffers of a window pair.
inline size_t pin_bytes(const PinGeometry& g) {
  return 4 * sizeof(float) * static_cast<size_t>(g.cells);
}

// Whether a launch of `steps` steps on tr x tc tiles with a halo of `halo`
// is one the pinned entries take: the halo a multiple of 8 up to 32, the
// steps within it, and the windows within the shared memory a block may
// use (the check of the C interface's input; ops/geometry.py decides the
// geometry).
inline bool pin_ok(int tr, int tc, int halo, int steps) {
  if (tr < 1 || tc < 1 || halo < HALO || halo > PIN_MAX_STEPS ||
      halo % HALO != 0 || steps < 1 || steps > halo) {
    return false;
  }
  return pin_bytes(pin_geometry(tr, tc, halo)) <= SMEM_OPTIN;
}

// The co-resident blocks of a persistent `kernel` (the pinned megakernels:
// mega_pins.cu, mega_pins_ring.cu, sharded_mega_pins.cu) of `threads`
// threads a block on `device` at `bytes` of dynamic shared memory, after
// allowing the kernel the most a block may use (once per device:
// `allowed`, one flag a device for each kernel).
template <typename Kernel>
cudaError_t pinned_coresident(Kernel kernel, bool* allowed, int device,
                              size_t bytes, int* out,
                              int threads = PinGeometry::NT) {
  cudaError_t err;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_OPTIN));
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  return cudaSuccess;
}

// pinned_coresident at g's two window buffers (the double buffer).
template <typename Kernel>
cudaError_t pinned_coresident(Kernel kernel, bool* allowed, int device,
                              const PinGeometry& g, int* out) {
  return pinned_coresident(kernel, allowed, device, pin_bytes(g), out);
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
  load_window<NT, true>(FlatLayout{cols}, u, v, su, sv, Fixed<WR>{},
                        Fixed<PITCH>{}, ti * TILE - 1, tj * TILE - 4, rows,
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
    step_strip<TAPS, NAIVE, R, false>(
        su + LEFT, sv + LEFT, Fixed<PITCH>{}, lr0, lc, R, at, k,
        [&](int i, float un, float vn) {
          pu[static_cast<size_t>(i) * cols] = un;
          pv[static_cast<size_t>(i) * cols] = vn;
        });
  } else {
    step_strip<TAPS, NAIVE, R, true>(
        su + LEFT, sv + LEFT, Fixed<PITCH>{}, lr0, lc, R, at, k,
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

// Whether `tile` and `nbuf` name a ring that the ring kernels run: 64x64
// tiles (Main) or 32x32 (Small), and 2 .. the geometry's most buffers.
inline bool ring_ok(int tile, int nbuf) {
  if (tile == Main::TR) return nbuf >= 2 && nbuf <= ring_max_buffers<Main>();
  return tile == Small::TR && nbuf >= 2 && nbuf <= ring_max_buffers<Small>();
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

// dispatch_taps for the pinned entries of the megakernels and of K1's shard
// entry (mega_pins.cu, mega_pins_ring.cu, sharded_mega_pins.cu,
// windowed_pins.cu): the default stencils' tap set (TAPS_RING) has its own
// instantiation, every other set runs TAPS_ANY, which tests each weight at
// run time and adds the same terms in the same order, bit for bit. Two
// instantiations where dispatch_taps has four keep the library's build
// time in bounds.
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_taps_lean(const Constants& k, Args&&... args) {
  if (tap_mask(k) == TAPS_RING) return Launch<TAPS_RING>::run(args...);
  return Launch<TAPS_ANY>::run(args...);
}

// dispatch_fold for the same pinned entries: the separable pass, else the
// direct sum with its weights tested at run time (TAPS_ANY).
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_fold_lean(const FoldConstants& k, int separable,
                               Args&&... args) {
  if (separable) return Launch<TAPS_SEPARABLE>::run(args...);
  return Launch<TAPS_ANY>::run(args...);
}

// Launch::run<TAPS>(args...) for the fold's sum: TAPS_SEPARABLE on a
// separable plan, else the direct plan's tap set (5points' own, or any
// other).
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_fold(const FoldConstants& k, int separable,
                          Args&&... args) {
  if (separable) return Launch<TAPS_SEPARABLE>::run(args...);
  if (tap_mask(k) == TAPS_CROSS) return Launch<TAPS_CROSS>::run(args...);
  return Launch<TAPS_ANY>::run(args...);
}

}  // namespace sm90
}  // namespace gs
