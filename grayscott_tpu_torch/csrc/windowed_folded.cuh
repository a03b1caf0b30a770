// K1's folded entry (windowed_pins.cu: gs_windowed_folded_multistep; the
// lane fold), what its units share: the call and the panel step on a
// chosen form (windowed_pins.cu the run-time sizes, windowed_pins_fixed.cu
// the compiled ones, splits/windowed_folded_ablation.cu the split's parts
// and the first form's refresh kernel).
//
// The one-launch window. Panel p of a folded state holds global rows
// [p*rp, (p+1)*rp) in its interior rows, and its halo rows hold copies of
// its neighbours' interior rows (0.0 past the first and last panel) that
// the first form refreshes in a launch of its own before the step
// (fold_refresh_kernel). A window row that lies in a halo row reads the
// neighbour panel's interior row instead (FoldLayout: a global row is read
// from the panel that holds it), which is the value the refresh would have
// copied there, so the step needs no refresh. The blocks of each panel's
// first and last tile row also write the refreshed halo rows of their
// columns into (u, v), as the first form leaves them. The launch reads
// only interior rows of (u, v) and writes only their halo rows and
// (u_out, v_out)'s interior rows: no block reads a row that the launch
// writes.

#pragma once

#include "windowed_pins.cuh"

namespace gs {
namespace folded {

namespace sm90 = gs::sm90;

using sm90::PinGeometry;

struct FoldedCall {
  float *u, *v;
  float *u_out, *v_out;
  int rows, cols, panels, rp, steps, naive, device;
  gs::Constants k;
  PinGeometry g;
  cudaStream_t stream;
};

// The geometries whose sizes windowed_pins_fixed.cu compiles in for the
// folded entry: 64x64 tiles at a halo of 8 (Main: K <= 8) and of 16.
inline bool fixed_geometry(const PinGeometry& g) {
  return g.tr == 64 && g.tc == 64 && (g.halo == 8 || g.halo == 16);
}

// The entry's form (the split, splits/windowed_folded_ablation.cu, chose
// it): 4x4 register blocks on interior tiles in one launch, the sizes
// compiled in where fixed_geometry and the tap set is the default
// stencils'.
constexpr int FORM = sm90::PIN_BLOCKS;
constexpr bool ONE_LAUNCH = true;

// The entry's launch on the compiled sizes (windowed_pins_fixed.cu).
cudaError_t launch_fixed(const FoldedCall& c);
// The first form's refresh launch over the call's halo rows (the split's
// unit, splits/windowed_folded_ablation.cu: fold_refresh_kernel).
cudaError_t launch_refresh(const FoldedCall& c);

namespace {

// A panel's view of a folded state (halo + rp + halo rows of panels * cols
// floats) for its one-launch window: every global row in [p*rp - halo,
// (p+1)*rp + halo) at the interior row of the panel that holds it, columns
// [0, cols); past the first and last panel nothing is held.
struct FoldLayout {
  int row0, rp, halo, cols, panels, p;
  size_t pitch;
  // the panel that holds global row gr, relative to p (-1, 0 or 1)
  __device__ __forceinline__ int side(int gr) const {
    const int lr = gr - row0;
    return lr < 0 ? -1 : lr >= rp ? 1 : 0;
  }
  __device__ __forceinline__ bool holds(int gr, int gc) const {
    const int lr = gr - row0, q = p + side(gr);
    return lr >= -halo && lr < rp + halo && q >= 0 && q < panels &&
           gc >= 0 && gc < cols;
  }
  __device__ __forceinline__ bool stores(int gr, int gc) const {
    return gr - row0 < rp && gc < cols;
  }
  __device__ __forceinline__ size_t at(int gr, int gc) const {
    const int s = side(gr);
    return static_cast<size_t>(gr - row0 - s * rp + halo) * pitch +
           static_cast<size_t>(p + s) * cols + gc;
  }
};

// The one-launch form's refresh, by the blocks of panel blockIdx.z's first
// and last tile row: the halo rows of their tile's columns, as
// fold_refresh_kernel writes them.
template <typename S>
__device__ __forceinline__ void refresh_tile_columns(const S& g, float* u,
                                                     float* v, int cols,
                                                     int panels, int rp) {
  const int p = blockIdx.z;
  const bool top = blockIdx.y == 0;
  const bool bottom = static_cast<int>(blockIdx.y) == rp / g.tr - 1;
  if (!top && !bottom) return;
  const size_t pitch = static_cast<size_t>(panels) * cols;
  const int c0 = blockIdx.x * g.tc;
  const int n_c = min(static_cast<int>(g.tc), cols - c0);
  const int band = g.halo * n_c;
  for (int i = threadIdx.x; i < 4 * band; i += S::NT) {
    float* x = i < 2 * band ? u : v;
    const int j = i % (2 * band);
    const bool low = j >= band;
    if (low ? !bottom : !top) continue;
    const int e = low ? j - band : j, r = e / n_c;
    const size_t at = static_cast<size_t>(p) * cols + c0 + (e - r * n_c);
    if (low) {
      x[(g.halo + rp + r) * pitch + at] =
          p + 1 < panels ? x[(g.halo + r) * pitch + at + cols] : 0.0f;
    } else {
      x[r * pitch + at] = p > 0 ? x[(rp + r) * pitch + at - cols] : 0.0f;
    }
  }
}

// One block: tile (blockIdx.y, blockIdx.x) of g of panel blockIdx.z, at
// its global place (gs_tile_sm90.cuh: panel_window_multistep), on the step
// loop of FORM (gs_pin_sm90.cuh: PIN_STRIPS or PIN_BLOCKS). ONE: the
// one-launch window (FoldLayout, and this block's share of the refresh),
// else the window of the refreshed halo rows (a panel's ShardLayout).
template <int TAPS, int MODE, int FORM, bool ONE, typename S>
__device__ __forceinline__ void panel_form_multistep(
    const S& g, float* u, float* v, float* u_out, float* v_out, int rows,
    int cols, int panels, int rp, int steps, const gs::Constants& k,
    bool aligned, float* base) {
  const int p = blockIdx.z, row0 = p * rp;
  if constexpr (ONE) refresh_tile_columns(g, u, v, cols, panels, rp);
  if (row0 + static_cast<int>(blockIdx.y) * g.tr >= rows) return;
  const int r0 = row0 + blockIdx.y * g.tr - g.halo;
  const int c0 = blockIdx.x * g.tc - g.halo;
  const size_t pitch = static_cast<size_t>(panels) * cols;
  if constexpr (ONE) {
    const FoldLayout mem = {row0, rp, g.halo, cols, panels, p, pitch};
    sm90::pin_window_multistep_on<TAPS, MODE, FORM, true, false, false>(
        g, mem, u, v, u_out, v_out, r0, c0, rows, cols, steps, k, aligned,
        base);
  } else {
    const gs::ShardLayout mem = {row0, 0, rp, cols, g.halo, 0, pitch};
    const size_t at = static_cast<size_t>(p) * cols;
    sm90::pin_window_multistep_on<TAPS, MODE, FORM, true, false, false>(
        g, mem, u + at, v + at, u_out + at, v_out + at, r0, c0, rows, cols,
        steps, k, aligned, base);
  }
}

template <int TAPS, int MODE, int FORM, bool ONE, typename S>
__global__ void __launch_bounds__(S::NT, pins::MIN_BLOCKS)
folded_form_kernel(float* u, float* v, float* u_out, float* v_out, int rows,
                   int cols, int panels, int rp, int steps, gs::Constants k,
                   S g, int aligned) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  panel_form_multistep<TAPS, MODE, FORM, ONE>(
      g, u, v, u_out, v_out, rows, cols, panels, rp, steps, k, aligned,
      reinterpret_cast<float*>(window));
}

// The grid of a folded launch: (tile columns, tile rows of a panel,
// panels); false where it is too large.
inline bool folded_grid(const FoldedCall& c, dim3* grid) {
  *grid = dim3((c.cols + c.g.tc - 1) / c.g.tc, (c.rp + c.g.tr - 1) / c.g.tr,
               c.panels);
  return grid->y <= 65535 && grid->z <= 65535;
}

// Whether the call's rows allow 16-byte window copies (a panel's rows
// start at p * cols floats).
inline int folded_aligned(const FoldedCall& c) {
  return sm90::rows_aligned<float>(c.cols, c.u, c.v, c.u_out, c.v_out) &&
         c.g.tc % 4 == 0;
}

// The panel step on FORM over the sizes of g (PinGeometry, or compiled
// sizes equal to c.g), after the refresh launch unless ONE.
template <int TAPS, int MODE, int FORM, bool ONE, typename S>
cudaError_t launch_form(const FoldedCall& c, S g) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = folded_form_kernel<TAPS, MODE, FORM, ONE, S>;
  cudaError_t err = pins::allow_smem(kernel, allowed, c.device);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!folded_grid(c, &grid)) return cudaErrorInvalidValue;
  if constexpr (!ONE) {
    err = launch_refresh(c);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, S::NT, sm90::pin_bytes(c.g), c.stream>>>(
      c.u, c.v, c.u_out, c.v_out, c.rows, c.cols, c.panels, c.rp, c.steps,
      c.k, g, folded_aligned(c));
  return cudaGetLastError();
}

}  // namespace
}  // namespace folded
}  // namespace gs
