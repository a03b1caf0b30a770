// What K2's translation units share (mega.cu: the double buffer, its
// ablation parts; mega_ring.cu: the window ring of mega_depth > 2;
// mega_pins.cu and mega_pins_ring.cu: the double buffer and the ring on the
// tile pins' geometry; splits/mega_ring_ablation.cu: the ring's ablation
// parts):
// the odd-count slot copy, a launch's time blocks on the double buffer and
// on the ring, the launch's arguments, the C interface's checks and the
// pinned geometries' cooperative launch.

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

// One launch of K2 on the double buffer: `n_blocks` time blocks of `steps`
// steps on the tiles of g (FixedShape<Main> in mega.cu, the PinGeometry of
// the tile pins in mega_pins.cu), time block t from slot t % 2 into slot
// 1 - t % 2 (time_block_on), a grid barrier after each, and the slot copy
// after an odd count; `base` is the block's two window buffers.
template <int TAPS, int MODE, bool SPECIALIZE, bool PREFETCH, typename S,
          typename T, typename K>
__device__ __forceinline__ void mega_run(const S& g, T* u_pair, T* v_pair,
                                         int rows, int cols, int n_blocks,
                                         int steps, const K& k, int aligned,
                                         unsigned long long* barrier,
                                         float* base) {
  const size_t plane = static_cast<size_t>(rows) * cols;
  const int tiles_x = (cols + g.tc - 1) / g.tc;
  const int n_tiles = tiles_x * ((rows + g.tr - 1) / g.tr);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    sm90::time_block_on<TAPS, MODE, SPECIALIZE, PREFETCH>(
        g, gs::FlatLayout{cols}, u_pair + src, v_pair + src, u_pair + dst,
        v_pair + dst, blockIdx.x, gridDim.x, n_tiles, tiles_x, 0, 0, rows,
        cols, steps, k, aligned, base);
    if (t + 1 < n_blocks || (n_blocks & 1)) gs::grid_barrier(barrier, t + 1);
  }
  if (n_blocks & 1) copy_slot(u_pair, v_pair, plane, S::NT, threadIdx.x);
}

// One launch of K2 on a window ring (mega_depth): mega_run's time blocks
// walked through `nbuf` buffers of g at `base` (ring_time_block_on of FORM,
// ITEMS strips a thread in place; FixedShape<Main> or <Small> in
// mega_ring.cu, the PinGeometry of the tile pins in mega_pins_ring.cu).
template <int TAPS, int MODE, int FORM, int ITEMS, typename S, typename T,
          typename K>
__device__ __forceinline__ void ring_run(const S& g, T* u_pair, T* v_pair,
                                         int rows, int cols, int n_blocks,
                                         int steps, const K& k, int aligned,
                                         int nbuf,
                                         unsigned long long* barrier,
                                         float* base) {
  const size_t plane = static_cast<size_t>(rows) * cols;
  const int tiles_x = (cols + g.tc - 1) / g.tc;
  const int n_tiles = tiles_x * ((rows + g.tr - 1) / g.tr);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    sm90::ring_time_block_on<TAPS, MODE, FORM, ITEMS>(
        g, gs::FlatLayout{cols}, u_pair + src, v_pair + src, u_pair + dst,
        v_pair + dst, blockIdx.x, gridDim.x, n_tiles, tiles_x, 0, 0, rows,
        cols, steps, k, aligned, nbuf, base);
    if (t + 1 < n_blocks || (n_blocks & 1)) gs::grid_barrier(barrier, t + 1);
  }
  if (n_blocks & 1) copy_slot(u_pair, v_pair, plane, S::NT, threadIdx.x);
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

// One cooperative launch of `kernel` (G::NT threads a block) with `args`
// over the tiles of g on a rows x cols domain, `bytes` of dynamic shared
// memory a block. `grid_blocks` <= 0 takes the co-resident maximum at those
// bytes (capped at the tile count); a larger grid than the card can hold is refused with
// cudaErrorCooperativeLaunchTooLarge, and nothing falls back.
template <typename Kernel, typename G = sm90::PinGeometry>
cudaError_t launch_pinned(Kernel kernel, bool* allowed, void** args,
                          int rows, int cols, const G& g, size_t bytes,
                          int grid_blocks, int device, cudaStream_t stream) {
  int most = 0;
  cudaError_t err =
      sm90::pinned_coresident(kernel, allowed, device, bytes, &most, G::NT);
  if (err != cudaSuccess) return err;
  int grid = grid_blocks;
  if (grid <= 0) {
    grid = most;
    const long long tiles = static_cast<long long>((cols + g.tc - 1) / g.tc) *
                            ((rows + g.tr - 1) / g.tr);
    if (tiles < grid) grid = static_cast<int>(tiles);
  }
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(G::NT), args, bytes,
                                    stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return err;
  }
  return cudaGetLastError();
}

}  // namespace
