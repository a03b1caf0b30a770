// What K1's pinned entries (windowed_pins.cu) share with the unit of their
// compiled geometries (windowed_pins_fixed.cu): the launches' arguments and
// the second form's kernels and launches.
//
// The second form (gs_pin_sm90.cuh: pin_window_multistep_on on PIN_BLOCKS)
// steps an interior tile in 4 x 4 register blocks with 16-byte shared
// loads, an edge tile in the first form's strips, with Main's 512 threads
// bound to two blocks an SM, on the run-time sizes of PinGeometry or, for
// the geometries users pin most (64x64 and 32x64 tiles at a halo of 16:
// K = 9..16 on the default tiles, and the sharded engine's row tile of
// 32), on sizes compiled in (FixedPin; the default stencils' tap set). The
// folded naive reaction keeps the first form (window_multistep on
// step_strip_fold).

#pragma once

#include "gs_pin_sm90.cuh"

namespace gs {
namespace pins {

namespace sm90 = gs::sm90;

using sm90::PinGeometry;

// blocks an SM the register budget allows (__launch_bounds__): Main's
constexpr int MIN_BLOCKS = 2;

template <typename T, typename K>
struct Call {
  const T *u, *v;
  T *u_out, *v_out;
  int rows, cols, steps, naive, device;
  K k;
  PinGeometry g;
  cudaStream_t stream;
};

template <typename T>
struct ShardCall {
  sm90::Shards<T> s;
  int n_shards, rows, cols, steps, naive, device;
  gs::Constants k;
  PinGeometry g;
  cudaStream_t stream;
};

// The geometries whose sizes windowed_pins_fixed.cu compiles in.
inline bool fixed_geometry(const PinGeometry& g) {
  return g.halo == 16 && g.tc == 64 && (g.tr == 64 || g.tr == 32);
}

// The second form's launches on the compiled geometries (the default
// stencils' tap set, zero or naive; fixed_geometry(c.g)):
// windowed_pins_fixed.cu.
template <typename T>
cudaError_t launch_fixed(const Call<T, gs::Constants>& c);
template <typename T>
cudaError_t launch_shard_fixed(const ShardCall<T>& c);
// The blocks an SM of the compiled geometry g's kernel (float32, naive;
// the shard entry's where `shard`) at its window's bytes.
cudaError_t fixed_blocks(const PinGeometry& g, int shard, int* per_sm);

namespace {

template <int TAPS, int MODE, typename T, typename S>
__global__ void __launch_bounds__(S::NT, MIN_BLOCKS)
pinned_form_kernel(const T* u, const T* v, T* u_out, T* v_out, int rows,
                   int cols, int steps, gs::Constants k, S g, int aligned) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::pin_window_multistep_on<TAPS, MODE, sm90::PIN_BLOCKS, true, false,
                                false>(
      g, gs::FlatLayout{cols}, u, v, u_out, v_out,
      blockIdx.y * g.tr - g.halo, blockIdx.x * g.tc - g.halo, rows, cols,
      steps, k, aligned, reinterpret_cast<float*>(window));
}

template <int TAPS, int MODE, typename T, typename S>
__global__ void __launch_bounds__(S::NT, MIN_BLOCKS)
shard_form_kernel(sm90::Shards<T> s, int rows, int cols, int steps,
                  gs::Constants k, S g) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sm90::pin_shard_multistep<TAPS, MODE, sm90::PIN_BLOCKS, true>(
      g, s, rows, cols, steps, k, reinterpret_cast<float*>(window));
}

// Allow `kernel` the most dynamic shared memory a block may use, once per
// device (`allowed`: one flag a device for each kernel).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* allowed, int device) {
  if (allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm90::SMEM_OPTIN));
  if (err == cudaSuccess) allowed[device] = true;
  return err;
}

// The blocks of `kernel` (Main's threads) an SM holds at `bytes` of
// dynamic shared memory, by its registers and shared memory.
template <typename Kernel>
cudaError_t form_blocks(Kernel kernel, size_t bytes, int* per_sm) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm90::SMEM_OPTIN));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, PinGeometry::NT, bytes);
}

// One launch of the second form on the sizes of g (PinGeometry, or a
// FixedPin equal to c.g).
template <int TAPS, int MODE, typename T, typename S>
cudaError_t launch_form(const Call<T, gs::Constants>& c, S g) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = pinned_form_kernel<TAPS, MODE, T, S>;
  const cudaError_t err = allow_smem(kernel, allowed, c.device);
  if (err != cudaSuccess) return err;
  const dim3 grid((c.cols + c.g.tc - 1) / c.g.tc,
                  (c.rows + c.g.tr - 1) / c.g.tr);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int aligned =
      sm90::rows_aligned<T>(c.cols, c.u, c.v, c.u_out, c.v_out) &&
      c.g.tc % sm90::vec_cells<T>() == 0;
  kernel<<<grid, S::NT, sm90::pin_bytes(c.g), c.stream>>>(
      c.u, c.v, c.u_out, c.v_out, c.rows, c.cols, c.steps, c.k, g, aligned);
  return cudaGetLastError();
}

// One launch of the second form of the shard entry on the sizes of g.
template <int TAPS, int MODE, typename T, typename S>
cudaError_t launch_shard_form(const ShardCall<T>& c, S g) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = shard_form_kernel<TAPS, MODE, T, S>;
  const cudaError_t err = allow_smem(kernel, allowed, c.device);
  if (err != cudaSuccess) return err;
  const sm90::Shards<T>& s = c.s;
  const dim3 grid =
      s.part == 1 ? dim3(s.tj1 - s.tj0, s.ti1 - s.ti0, c.n_shards)
                  : dim3((s.c_loc + c.g.tc - 1) / c.g.tc,
                         (s.r_loc + c.g.tr - 1) / c.g.tr, c.n_shards);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;  // an empty part
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, S::NT, sm90::pin_bytes(c.g), c.stream>>>(
      s, c.rows, c.cols, c.steps, c.k, g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pins
}  // namespace gs
