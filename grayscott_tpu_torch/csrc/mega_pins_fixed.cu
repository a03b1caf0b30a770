// K2's pinned entry on the tile pins users and the tuner name most, their
// sizes compiled in: the second form of gs_mega_pinned_multistep (and its
// bf16 twin) on 16x64 tiles (--pallas-block-rows 16), 32x64 (the tuner's
// half row tile, bench/autotune.py:MEGA_EXTRA), 32x128 and 64x128 (the
// tuner's double column tile), at the megakernels' halo of 8, the default
// stencils' tap set, zero and naive. The block body is the first form's
// (mega_run, on sm90::FixedPin instead of PinGeometry: mega_pins.cuh), so
// every geometry gives the compiled kernel's result bit for bit. With the
// tile's sizes constants the window's pitch folds into the shared loads'
// offsets and the tile walk's divisions into multiplications (0.87-0.91x
// the first form's time). The threads a block follow the window's bytes
// where the split measured that they pay (splits/mega_pins_ablation.cu,
// PERF.md §6, PR 26), every kernel at 64 registers a thread: 16x64's
// 40,960 B windows run four blocks of 256 an SM (0.79-0.83x), 64x128's
// 184,320 B one block of 1024 on the naive boundary (0.97x the 512) and of
// 512 on the zero one, where 1024 lost. ops/geometry.py:mega_pin_launch
// chooses this form and its threads on the host (on_kept below holds the
// same table); every other pin, and any other tap set, runs mega_pins.cu's
// first form. A unit of its own, so that the library's units build side
// by side.

#include "mega_pins.cuh"

namespace {

constexpr int TAPS = sm90::TAPS_RING;

template <int TR, int TC, int NT>
using Pin = sm90::FixedPin<TR, TC, HALO, NT>;

constexpr int NAIVE = sm90::MODE_NAIVE, ZERO = sm90::MODE_ZERO;

// The kept forms: F(MegaPinForm<...>{}, Pin<...>{}) on the form of (tr, tc,
// threads, mode) on T, or cudaErrorInvalidValue where none is compiled.
template <typename T, int TR, int TC, int NT, int MODE, typename F>
bool kept(int tr, int tc, int threads, int mode, F& f, cudaError_t* err) {
  if (tr != TR || tc != TC || threads != NT || mode != MODE) return false;
  *err = f(MegaPinForm<TAPS, MODE, T, Pin<TR, TC, NT>>{}, Pin<TR, TC, NT>{});
  return true;
}

template <typename T, typename F>
cudaError_t on_kept(int tr, int tc, int threads, int naive, F&& f) {
  const int mode = naive ? NAIVE : ZERO;
  cudaError_t err = cudaErrorInvalidValue;
  (void)(kept<T, 16, 64, 256, NAIVE>(tr, tc, threads, mode, f, &err) ||
         kept<T, 16, 64, 256, ZERO>(tr, tc, threads, mode, f, &err) ||
         kept<T, 32, 64, 512, NAIVE>(tr, tc, threads, mode, f, &err) ||
         kept<T, 32, 64, 512, ZERO>(tr, tc, threads, mode, f, &err) ||
         kept<T, 32, 128, 512, NAIVE>(tr, tc, threads, mode, f, &err) ||
         kept<T, 32, 128, 512, ZERO>(tr, tc, threads, mode, f, &err) ||
         kept<T, 64, 128, 1024, NAIVE>(tr, tc, threads, mode, f, &err) ||
         kept<T, 64, 128, 512, ZERO>(tr, tc, threads, mode, f, &err));
  return err;
}

template <typename T>
int multistep(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
              int steps, int naive, int device, const float* w, float du,
              float dv, float feed, float min_feed_kill, float dt,
              int grid_blocks, void* barrier, void* stream, int tr, int tc,
              int threads, int* grid_out) {
  cudaError_t err;
  const Call<T> c = make_call(u_pair, v_pair, rows, cols, n_blocks, steps,
                              naive, device, w, du, dv, feed, min_feed_kill,
                              dt, grid_blocks, barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sm90::tap_mask(c.k) != TAPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      on_kept<T>(tr, tc, threads, naive, [&](auto form, auto g) {
        return decltype(form)::launch(c, g, grid_out);
      }));
}

template <typename T>
cudaError_t blocks(int device, int tr, int tc, int threads, int naive,
                   int* out) {
  return on_kept<T>(tr, tc, threads, naive, [&](auto form, auto g) {
    return decltype(form)::blocks(device, g, out);
  });
}

}  // namespace

extern "C" {

// The co-resident blocks on `device` of the compiled instantiation that a
// launch of tr x tc tiles on `threads` threads a block, `naive` or zero,
// float32 or bf16 (`bf16`), would take (negative: minus the CUDA error;
// cudaErrorInvalidValue: no such geometry is compiled).
int gs_mega_pinned_fixed_blocks(int device, int tr, int tc, int threads,
                                int naive, int bf16) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 0;
  if (err == cudaSuccess) {
    err = bf16 ? blocks<sm90::bf16>(device, tr, tc, threads, naive, &n)
               : blocks<float>(device, tr, tc, threads, naive, &n);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// gs_mega_pinned_multistep on the compiled tr x tc tiles of `threads`
// threads a block (the default stencils' tap set; a kept form of its
// boundary), the launch's grid to
// *grid_out (host memory) where that is not null. Returns the CUDA error
// (0 when the launch was accepted), or cudaErrorInvalidValue for a
// geometry, thread count or tap set that is not compiled: nothing falls
// back to the run-time form.
int gs_mega_pinned_fixed_multistep(float* u_pair, float* v_pair, int rows,
                                   int cols, int n_blocks, int steps,
                                   int naive, int device, float w0, float w1,
                                   float w2, float w3, float w4, float w5,
                                   float w6, float w7, float w8, float du,
                                   float dv, float feed, float min_feed_kill,
                                   float dt, int grid_blocks, void* barrier,
                                   void* stream, int tr, int tc, int threads,
                                   int* grid_out) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(u_pair, v_pair, rows, cols, n_blocks, steps, naive,
                   device, w, du, dv, feed, min_feed_kill, dt, grid_blocks,
                   barrier, stream, tr, tc, threads, grid_out);
}

// gs_mega_pinned_fixed_multistep on bfloat16 pairs.
int gs_mega_pinned_fixed_multistep_bf16(
    void* u_pair, void* v_pair, int rows, int cols, int n_blocks, int steps,
    int naive, int device, float w0, float w1, float w2, float w3, float w4,
    float w5, float w6, float w7, float w8, float du, float dv, float feed,
    float min_feed_kill, float dt, int grid_blocks, void* barrier,
    void* stream, int tr, int tc, int threads, int* grid_out) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(static_cast<sm90::bf16*>(u_pair),
                   static_cast<sm90::bf16*>(v_pair), rows, cols, n_blocks,
                   steps, naive, device, w, du, dv, feed, min_feed_kill, dt,
                   grid_blocks, barrier, stream, tr, tc, threads, grid_out);
}

}  // extern "C"
