// The split of K1's folded entry (windowed_pins.cu:
// gs_windowed_folded_multistep; the lane fold): the entry with one part of
// its design taken out or changed, for timing what each part costs. The
// default stencils' tap set, the naive boundary, float32. Every part leaves
// (u_out, v_out)'s interior rows and (u, v)'s halo rows as the entry does
// but part 1, which refreshes the halo rows and steps nothing, and part 2,
// which steps without refreshing (its result is the entry's where the halo
// rows are already fresh).
//
//   0  the first form: the refresh launch (fold_refresh_kernel), then the
//      panel step on PinGeometry's run-time sizes in register strips
//      (panel_window_multistep)
//   1  the refresh launch alone
//   2  the step launch alone
//   3  0 with the sizes compiled in: Main's at a halo of 8, 64x64 at 16
//      (FixedPin), those two only
//   4  0 with interior tiles in 4x4 register blocks, one 16-byte shared
//      load a species a row (gs_pin_sm90.cuh: PIN_BLOCKS)
//   5  one launch: the windows read the neighbour panels' interior rows
//      and the first and last tile rows write the halo rows
//      (windowed_folded.cuh: FoldLayout, refresh_tile_columns), strips
//   6  3 with 4 and 5
//
// The launches are not the main path's and are not counted.

#include "../windowed_folded.cuh"

namespace {

namespace sm90 = gs::sm90;
namespace folded = gs::folded;

using folded::FoldedCall;
using sm90::PinGeometry;

constexpr int PARTS = 7;
constexpr int TAPS = sm90::TAPS_RING;
constexpr int MODE = sm90::MODE_NAIVE;

// The first form's refresh: the panels' halo rows of u and v from their
// neighbours' interior rows, element i of 2 species x 2 bands (top,
// bottom) x halo rows x panels*cols, a thread an element
// (pallas_stencil.py:1547's fold_refresh).
__global__ void fold_refresh_kernel(float* u, float* v, int cols, int panels,
                                    int rp, int halo) {
  const long long pitch = static_cast<long long>(panels) * cols;
  const long long band = halo * pitch, n = 4 * band;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float* x = i < 2 * band ? u : v;
    const long long j = i % (2 * band);
    const bool bottom = j >= band;
    const long long k = bottom ? j - band : j;
    const long long r = k / pitch, at = k - r * pitch;
    const int p = static_cast<int>(at / cols);
    if (bottom) {
      x[(halo + rp + r) * pitch + at] =
          p + 1 < panels ? x[(halo + r) * pitch + at + cols] : 0.0f;
    } else {
      x[r * pitch + at] = p > 0 ? x[(rp + r) * pitch + at - cols] : 0.0f;
    }
  }
}

// The first form's step (parts 0 and 2).
__global__ void __launch_bounds__(PinGeometry::NT, gs::pins::MIN_BLOCKS)
folded_first_form_kernel(const float* u, const float* v, float* u_out,
                  float* v_out, int rows, int cols, int panels, int rp,
                  int steps, gs::Constants k, PinGeometry g, int aligned) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::panel_window_multistep<TAPS, MODE>(
      g, u, v, u_out, v_out, rows, cols,
                                           panels, rp, steps, k, aligned,
                                           reinterpret_cast<float*>(window));
}

cudaError_t launch_first_form(const FoldedCall& c, bool refresh) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = folded_first_form_kernel;
  cudaError_t err = gs::pins::allow_smem(kernel, allowed, c.device);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!folded::folded_grid(c, &grid)) return cudaErrorInvalidValue;
  if (refresh) {
    err = folded::launch_refresh(c);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, PinGeometry::NT, sm90::pin_bytes(c.g), c.stream>>>(
      c.u, c.v, c.u_out, c.v_out, c.rows, c.cols, c.panels, c.rp, c.steps,
      c.k, c.g, folded::folded_aligned(c));
  return cudaGetLastError();
}

// Parts 3 and 6 on the compiled sizes equal to c.g.
template <int FORM, bool ONE>
cudaError_t launch_fixed(const FoldedCall& c) {
  if (c.g.halo == sm90::HALO) {
    return folded::launch_form<TAPS, MODE, FORM, ONE>(
        c, sm90::FixedShape<sm90::Main>{});
  }
  return folded::launch_form<TAPS, MODE, FORM, ONE>(
      c, sm90::FixedPin<64, 64, 16>{});
}

cudaError_t launch(int part, const FoldedCall& c) {
  switch (part) {
    case 0:
      return launch_first_form(c, true);
    case 1:
      return folded::launch_refresh(c);
    case 2:
      return launch_first_form(c, false);
    case 3:
      return launch_fixed<sm90::PIN_STRIPS, false>(c);
    case 4:
      return folded::launch_form<TAPS, MODE, sm90::PIN_BLOCKS, false>(c, c.g);
    case 5:
      return folded::launch_form<TAPS, MODE, sm90::PIN_STRIPS, true>(c, c.g);
    default:
      return launch_fixed<sm90::PIN_BLOCKS, true>(c);
  }
}

}  // namespace

namespace gs {
namespace folded {

cudaError_t launch_refresh(const FoldedCall& c) {
  constexpr int THREADS = 256;
  const long long blocks = 4LL * c.g.halo * c.panels * c.cols / THREADS + 1;
  fold_refresh_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024),
                        THREADS, 0, c.stream>>>(c.u, c.v, c.cols, c.panels,
                                                c.rp, c.g.halo);
  return cudaGetLastError();
}

}  // namespace folded
}  // namespace gs

extern "C" {

int gs_windowed_folded_ablation_parts() { return PARTS; }

// Part `part` (0..PARTS-1, above) of gs_windowed_folded_multistep, with its
// arguments; the default stencils' tap set and the naive boundary only, and
// parts 3 and 6 on 64x64 tiles at a halo of 8 or 16 only (else
// cudaErrorInvalidValue).
int gs_windowed_folded_ablation(int part, float* u, float* v, float* u_out,
                                float* v_out, int rows, int cols, int panels,
                                int rp, int steps, int tr, int tc, int halo,
                                int naive, int device, float w0, float w1,
                                float w2, float w3, float w4, float w5,
                                float w6, float w7, float w8, float du,
                                float dv, float feed, float min_feed_kill,
                                float dt, void* stream) {
  const FoldedCall c = {
      u, v, u_out, v_out, rows, cols, panels, rp, steps, naive, device,
      {{w0, w1, w2, w3, w4, w5, w6, w7, w8}, du, dv, feed, min_feed_kill, dt},
      sm90::pin_geometry(tr, tc, halo), static_cast<cudaStream_t>(stream)};
  if (part < 0 || part >= PARTS || sm90::tap_mask(c.k) != TAPS || !naive ||
      rows < 1 || cols < 1 || !sm90::pin_ok(tr, tc, halo, steps) ||
      device < 0 || device >= gs::MAX_DEVICES || panels < 1 || rp < 1 ||
      rp % tr != 0 || static_cast<long long>(panels) * rp < rows ||
      (panels > 1 && rp < halo) ||
      ((part == 3 || part == 6) && !folded::fixed_geometry(c.g))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(part, c));
}

}  // extern "C"
