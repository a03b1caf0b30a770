// K2's pinned double buffer on any geometry type, what mega_pins_fixed.cu
// (the kept form: the pins' sizes compiled in) and splits/mega_pins_ablation.cu
// (the split that chose it) share: the kernel on S (sm90::FixedPin,
// sm90::PinShape or sm90::PinGeometry), S::NT threads a block bound to 64
// registers a thread, and its launch on the co-resident blocks of that
// instantiation at S's window bytes. The block body is mega_run
// (mega.cuh), which mega_pins.cu runs on PinGeometry and mega.cu on
// FixedShape<Main>: every form gives the compiled kernel's result bit for
// bit.

#pragma once

#include "gs_pin_sm90.cuh"
#include "mega.cuh"

namespace {

// 64 registers a thread: 65,536 of an SM over S::NT threads a block
// (sm90::blocks_at_64_regs). STEP = false: the window loads and tile
// stores alone (the split's part 1; its result is its input).
template <int TAPS, int MODE, typename T, typename S, bool STEP = true>
__global__ void __launch_bounds__(S::NT, 65536 / (64 * S::NT))
mega_pin_form_kernel(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
                     int steps, gs::Constants k, int aligned, S g,
                     unsigned long long* barrier) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  mega_run<TAPS, MODE, true, true>(g, u_pair, v_pair, rows, cols, n_blocks,
                                   STEP ? steps : 0, k, aligned, barrier,
                                   reinterpret_cast<float*>(window));
}

// One instantiation of mega_pin_form_kernel: its co-resident blocks at g
// and its launch (grid_blocks <= 0: that count, capped at the tiles; the
// grid to *grid_out where that is not null).
template <int TAPS, int MODE, typename T, typename S, bool STEP = true>
struct MegaPinForm {
  static bool* allowed() {
    static bool done[gs::MAX_DEVICES];
    return done;
  }

  static cudaError_t blocks(int device, const S& g, int* out) {
    return sm90::pinned_coresident(mega_pin_form_kernel<TAPS, MODE, T, S, STEP>,
                                   allowed(), device, sm90::pair_bytes(g),
                                   out, S::NT);
  }

  static cudaError_t launch(const Call<T>& c, const S& g, int* grid_out) {
    Call<T> a = c;
    S geo = g;
    const size_t plane = static_cast<size_t>(c.rows) * c.cols;
    int aligned = sm90::rows_aligned<T>(c.cols, c.u_pair, c.v_pair,
                                        c.u_pair + plane, c.v_pair + plane) &&
                  g.tc % sm90::vec_cells<T>() == 0;
    void* args[] = {&a.u_pair, &a.v_pair, &a.rows, &a.cols, &a.n_blocks,
                    &a.steps,  &a.k,      &aligned, &geo,   &a.barrier};
    return launch_pinned(mega_pin_form_kernel<TAPS, MODE, T, S, STEP>,
                         allowed(), args, c.rows, c.cols, g,
                         sm90::pair_bytes(g), c.grid_blocks, c.device,
                         c.stream, grid_out);
  }
};

// The instantiation of the call's boundary.
template <int TAPS, typename T, typename S, bool STEP = true>
cudaError_t launch_pin_form(const Call<T>& c, const S& g, int* grid_out) {
  return c.naive
             ? MegaPinForm<TAPS, sm90::MODE_NAIVE, T, S, STEP>::launch(
                   c, g, grid_out)
             : MegaPinForm<TAPS, sm90::MODE_ZERO, T, S, STEP>::launch(
                   c, g, grid_out);
}

}  // namespace
