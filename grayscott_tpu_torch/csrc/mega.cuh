// What K2's two translation units share (mega.cu: the double buffer, its
// ablation parts; mega_ring.cu: the window ring of mega_depth > 2): the
// odd-count slot copy, the launch's arguments and the C interface's checks.

#pragma once

#include "gs_tile_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

constexpr int HALO = sm90::HALO;  // most steps per time block (MEGA_STEPS)

// The slot copy after an odd number of time blocks: slot 1 to slot 0, by
// the whole grid of blocks of `threads` threads; `tid` is the thread's flat
// index in its block.
template <typename T>
__device__ __forceinline__ void copy_slot(T* u_pair, T* v_pair,
                                          size_t plane, int threads,
                                          int tid) {
  const size_t stride = static_cast<size_t>(gridDim.x) * threads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * threads + tid;
       i < plane; i += stride) {
    u_pair[i] = sm90::load_cg(u_pair + plane + i);
    v_pair[i] = sm90::load_cg(v_pair + plane + i);
  }
}

template <typename T, typename K = gs::Constants>
struct Call {
  T *u_pair, *v_pair;
  int rows, cols, n_blocks, steps, naive, device;
  K k;
  int grid_blocks;
  unsigned long long* barrier;
  cudaStream_t stream;
};

// Whether the C interface's sizes are ones the kernels take; then the
// device is made current (its error in *err, else cudaErrorInvalidValue).
inline bool call_ok(int rows, int cols, int n_blocks, int steps, int device,
                    cudaError_t* err) {
  if (rows < 1 || cols < 1 || n_blocks < 1 || steps < 1 || steps > HALO ||
      device < 0 || device >= gs::MAX_DEVICES) {
    *err = cudaErrorInvalidValue;
    return false;
  }
  *err = cudaSetDevice(device);
  return *err == cudaSuccess;
}

// The C interface's checks; the call, or an error in `err`.
template <typename T>
Call<T> make_call(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
                  int steps, int naive, int device, const float* w, float du,
                  float dv, float feed, float min_feed_kill, float dt,
                  int grid_blocks, void* barrier, void* stream,
                  cudaError_t* err) {
  call_ok(rows, cols, n_blocks, steps, device, err);
  return {u_pair, v_pair, rows, cols, n_blocks, steps, naive, device,
          {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
           du, dv, feed, min_feed_kill, dt},
          grid_blocks, static_cast<unsigned long long*>(barrier),
          static_cast<cudaStream_t>(stream)};
}

// make_call for the fold entries: `fold` holds gs_fold_floats() floats.
template <typename T>
Call<T, sm90::FoldConstants> make_fold_call(
    T* u_pair, T* v_pair, int rows, int cols, int n_blocks, int steps,
    int device, const float* fold, int dt_is_one, int grid_blocks,
    void* barrier, void* stream, cudaError_t* err) {
  call_ok(rows, cols, n_blocks, steps, device, err);
  return {u_pair, v_pair, rows, cols, n_blocks, steps, 1, device,
          sm90::fold_constants(fold, dt_is_one), grid_blocks,
          static_cast<unsigned long long*>(barrier),
          static_cast<cudaStream_t>(stream)};
}

}  // namespace
