// K2's pinned entry (mega_pins.cu: the double buffer on the megakernels'
// tile pins) with one part of its design taken out or changed, for timing
// what each part costs. float32 and bf16 pairs, the default stencils' tap
// set, naive and zero, the megakernels' halo of 8. The launches are not the
// main path's and are not counted.
//
//   0  the first form: the tiles' sizes at run time (PinGeometry), 512
//      threads a block bound to 64 registers
//   1  the window loads and tile stores alone: no step (the grid barrier
//      of each time block kept); its result is its input
//   2  the sizes compiled in (sm90::FixedPin) at 512 threads
//   3  threads fitted to the window's bytes on run-time sizes
//      (sm90::fitted_threads: 1024 where the bytes leave one block an SM,
//      512 at two or three, 256 at four or more), 64 registers a thread
//   4  2 with 3
//
// Parts 2 and 4 compile the geometries the split times (launch_fixed): on
// float32 32x64, 32x128 and 64x128, on bf16 16x64. Where the bytes fit 512
// threads, part 3 is part 0's kernel and part 4 part 2's.

#include <type_traits>

#include "../mega_pins.cuh"

namespace {

constexpr int PARTS = 5;
constexpr int TAPS = sm90::TAPS_RING;

template <int TR, int TC, int NT>
using Pin = sm90::FixedPin<TR, TC, HALO, NT>;

// Part 3 on the run-time geometry g.
template <typename T>
cudaError_t launch_fitted(const Call<T>& c, const sm90::PinGeometry& g,
                          int* grid) {
  switch (sm90::fitted_threads(sm90::pin_bytes(g))) {
    case 256:
      return launch_pin_form<TAPS>(c, sm90::pin_shape<256>(g), grid);
    case 1024:
      return launch_pin_form<TAPS>(c, sm90::pin_shape<1024>(g), grid);
    default:
      return launch_pin_form<TAPS>(c, g, grid);
  }
}

// Parts 2 (FIT false) and 4 (FIT true) on tr x tc tiles compiled in:
// cudaErrorInvalidValue where the split compiles no such geometry for T.
template <bool FIT, typename T>
cudaError_t launch_fixed(const Call<T>& c, int tr, int tc, int* grid) {
  if constexpr (std::is_same_v<T, float>) {
    if (tr == 32 && tc == 64) {
      return launch_pin_form<TAPS>(c, Pin<32, 64, 512>{}, grid);
    }
    if (tr == 32 && tc == 128) {
      return launch_pin_form<TAPS>(c, Pin<32, 128, 512>{}, grid);
    }
    if (tr == 64 && tc == 128) {
      return FIT ? launch_pin_form<TAPS>(c, Pin<64, 128, 1024>{}, grid)
                 : launch_pin_form<TAPS>(c, Pin<64, 128, 512>{}, grid);
    }
  } else {
    if (tr == 16 && tc == 64) {
      return FIT ? launch_pin_form<TAPS>(c, Pin<16, 64, 256>{}, grid)
                 : launch_pin_form<TAPS>(c, Pin<16, 64, 512>{}, grid);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(int part, const Call<T>& c, int tr, int tc, int* grid) {
  const sm90::PinGeometry g = sm90::pin_geometry(tr, tc, HALO);
  switch (part) {
    case 0:
      return launch_pin_form<TAPS>(c, g, grid);
    case 1:
      return MegaPinForm<TAPS, sm90::MODE_NAIVE, T, sm90::PinGeometry,
                         false>::launch(c, g, grid);
    case 2:
      return launch_fixed<false>(c, tr, tc, grid);
    case 3:
      return launch_fitted(c, g, grid);
    default:
      return launch_fixed<true>(c, tr, tc, grid);
  }
}

}  // namespace

extern "C" {

int gs_mega_pins_ablation_parts() { return PARTS; }

// One launch of part `part` (0..PARTS-1, above) of K2's pinned entry on tr
// x tc tiles: gs_mega_pinned_multistep's arguments on pairs of float32 or
// (`bf16`) bfloat16, then the part, the storage, tr and tc; the launch's
// grid (grid_blocks <= 0: the co-resident blocks of the part's kernel)
// goes to *grid_out (host memory) when it is not null. Returns the CUDA
// error (cudaErrorInvalidValue for a part, geometry, storage or tap set the
// part does not take).
int gs_mega_pins_ablation(void* u_pair, void* v_pair, int rows, int cols,
                          int n_blocks, int steps, int naive, int device,
                          float w0, float w1, float w2, float w3, float w4,
                          float w5, float w6, float w7, float w8, float du,
                          float dv, float feed, float min_feed_kill,
                          float dt, int grid_blocks, void* barrier,
                          void* stream, int part, int bf16, int tr, int tc,
                          int* grid_out) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  if (part < 0 || part >= PARTS || !sm90::pin_ok(tr, tc, HALO, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (bf16) {
    const Call<sm90::bf16> c = make_call(
        static_cast<sm90::bf16*>(u_pair), static_cast<sm90::bf16*>(v_pair),
        rows, cols, n_blocks, steps, naive, device, w, du, dv, feed,
        min_feed_kill, dt, grid_blocks, barrier, stream, &err);
    if (err == cudaSuccess && sm90::tap_mask(c.k) != TAPS) {
      err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err != cudaSuccess
                                ? err
                                : launch(part, c, tr, tc, grid_out));
  }
  const Call<float> c = make_call(
      static_cast<float*>(u_pair), static_cast<float*>(v_pair), rows, cols,
      n_blocks, steps, naive, device, w, du, dv, feed, min_feed_kill, dt,
      grid_blocks, barrier, stream, &err);
  if (err == cudaSuccess && sm90::tap_mask(c.k) != TAPS) {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err != cudaSuccess
                              ? err
                              : launch(part, c, tr, tc, grid_out));
}

}  // extern "C"
