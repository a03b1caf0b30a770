// The first species-packed tile stepper: the first forms of K4, K5 and K6
// that their ablation part 0 keeps (packed.cu, packed_resident.cu,
// packed_mega.cu) step on it; the kernels themselves step on the packed
// Hopper stepper (gs_packed_sm90.cuh), which takes PackedConstants from
// here.
//
// The state is one (rows, 2*cols) row-major array, U in columns [0, cols)
// and V in [cols, 2*cols) of every row: the JAX package's [U | V] layout
// (grayscott_tpu/ops/pallas_stencil.py, "species-packed layout"), without
// its halo rows and padding. Zero boundary and a separable stencil only.
//
// On the TPU the layout lets one vector pass diffuse both species, and the
// reaction couples the halves through a lane roll y = roll(x, cols). Here
// one thread computes both species of its cell, from two row streams at
// column offsets 0 and cols of the packed row, so nothing is rolled and
// uv^2 is computed once for both updates.
//
// step_packed_tile<HALO> advances one TILE x TILE output tile by `steps`
// <= HALO steps:
//
//   - the block loads the (TILE + 2*HALO)^2 window of U and V around its
//     tile into shared memory (x), cells outside the domain as 0.0;
//   - step s has two passes over the cells it can still compute exactly
//     (window cells [s+1, WIN-s-1), shrinking by one a step as in K1):
//       1. the row pass t = h1*x + h0*(x[c-1] + x[c+1]) into the shared t
//          buffer, on the rows [s, WIN-s) that pass 2 reads;
//       2. the column pass s = h1*t + h0*(t[r-1] + t[r+1]) and the linear
//          fold (ops/packed.py:packed_step has the tree), written over x in
//          place: pass 2 reads x only at its own cell, and t at its
//          neighbours, so no thread reads what another writes in the pass;
//     each pass ends in a __syncthreads(), two a step;
//   - cells outside the domain are written as exactly 0.0 every step, so
//     both passes read the zero boundary from the window; a row outside the
//     domain gives t = h1*0 + h0*(0 + 0) = +0.0, as the plain version's
//     zero padding of t does;
//   - the tile interior, masked to the domain, is written to x_out.
//
// Shared memory: x and t for two species, 4 * WIN^2 floats (36,864 B at
// HALO = 8, as K1's ping-pong window), under the 48 KB static limit.
//
// Numerics: the plain version's tree, each operation rounded once (built
// with -fmad=false and without -ftz), so every packed kernel equals
// ops/packed.py:packed_step bit for bit. Loads of the state go through
// __ldcg, for the reason gs_tile.cuh gives.

#pragma once

#include "gs_tile.cuh"

namespace gs {

struct PackedConstants {
  float h0, h1;              // separable taps: side, centre
  float cu, cv, e, au, bv;   // the zero boundary's linear fold
  float qu, qv;              // the coefficient of uv^2 in U's and V's update
};

template <int HALO>
struct PackedWindow {
  static constexpr int WIN = TILE + 2 * HALO;
  float x[2][WIN * WIN];  // U and V, updated in place a step
  float t[2][WIN * WIN];  // the row pass of each species
};

// Advance tile (tile_row, tile_col) of the packed state `x` (rows x
// 2*cols) by `steps` (1..HALO) steps into `x_out`, through the block's
// shared window `s`. Ends in a __syncthreads(), so the block may call it
// again for its next tile.
template <int HALO>
__device__ __forceinline__ void step_packed_tile(
    const float* x, float* x_out, int tile_row, int tile_col, int rows,
    int cols, int steps, const PackedConstants& k, PackedWindow<HALO>& s) {
  constexpr int WIN = PackedWindow<HALO>::WIN;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t pitch = 2 * static_cast<size_t>(cols);
  // global (row, col) of window cell (0, 0)
  const int r0 = tile_row * TILE - HALO;
  const int c0 = tile_col * TILE - HALO;

  for (int lr = ty; lr < WIN; lr += BLOCK_Y) {
    const int gr = r0 + lr;
    for (int lc = tx; lc < WIN; lc += BLOCK_X) {
      const int gc = c0 + lc;
      float uc = 0.0f, vc = 0.0f;
      if (gr >= 0 && gr < rows && gc >= 0 && gc < cols) {
        const size_t g = static_cast<size_t>(gr) * pitch + gc;
        uc = __ldcg(x + g);
        vc = __ldcg(x + g + cols);
      }
      s.x[0][lr * WIN + lc] = uc;
      s.x[1][lr * WIN + lc] = vc;
    }
  }
  __syncthreads();

  for (int st = 0; st < steps; ++st) {
    const int lo = st + 1, hi = WIN - st - 1;
    // 1. the row pass, on rows [lo - 1, hi + 1) and columns [lo, hi)
    for (int lr = lo - 1 + ty; lr < hi + 1; lr += BLOCK_Y) {
      for (int lc = lo + tx; lc < hi; lc += BLOCK_X) {
        const int at = lr * WIN + lc;
#pragma unroll
        for (int sp = 0; sp < 2; ++sp) {
          const float* xs = s.x[sp];
          s.t[sp][at] = k.h1 * xs[at] + k.h0 * (xs[at - 1] + xs[at + 1]);
        }
      }
    }
    __syncthreads();
    // 2. the column pass and the reaction, in place, on [lo, hi)^2
    for (int lr = lo + ty; lr < hi; lr += BLOCK_Y) {
      const int gr = r0 + lr;
      for (int lc = lo + tx; lc < hi; lc += BLOCK_X) {
        const int gc = c0 + lc;
        const int at = lr * WIN + lc;
        float un = 0.0f, vn = 0.0f;  // outside the domain: exactly 0.0
        if (gr >= 0 && gr < rows && gc >= 0 && gc < cols) {
          const float u = s.x[0][at], v = s.x[1][at];
          const float* tu = s.t[0];
          const float* tv = s.t[1];
          const float su =
              k.h1 * tu[at] + k.h0 * (tu[at - WIN] + tu[at + WIN]);
          const float sv =
              k.h1 * tv[at] + k.h0 * (tv[at - WIN] + tv[at + WIN]);
          const float q = (u * v) * v;
          un = ((k.cu * su + k.qu * q) + k.e) + k.au * u;
          vn = ((k.cv * sv + k.qv * q) + 0.0f) + k.bv * v;
        }
        s.x[0][at] = un;
        s.x[1][at] = vn;
      }
    }
    __syncthreads();
  }

  for (int lr = HALO + ty; lr < HALO + TILE; lr += BLOCK_Y) {
    const int gr = r0 + lr;
    for (int lc = HALO + tx; lc < HALO + TILE; lc += BLOCK_X) {
      const int gc = c0 + lc;
      if (gr < rows && gc < cols) {
        const size_t g = static_cast<size_t>(gr) * pitch + gc;
        x_out[g] = s.x[0][lr * WIN + lc];
        x_out[g + cols] = s.x[1][lr * WIN + lc];
      }
    }
  }
  __syncthreads();  // the window is free for the block's next tile
}

}  // namespace gs
