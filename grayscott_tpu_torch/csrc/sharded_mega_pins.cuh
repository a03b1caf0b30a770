// K7's pinned entry on any geometry type, what sharded_mega_pins_fixed.cu
// (the kept form: the pins' sizes compiled in) and
// splits/sharded_mega_pins_ablation.cu (the split that chose it) share: the
// kernel on S (sm90::FixedPin, sm90::PinShape or sm90::PinGeometry), S::NT
// threads a block bound to MIN_BLOCKS blocks an SM, and its launch on the
// co-resident blocks of that instantiation at S's window bytes, split into
// one group a shard. The block body is sharded_mega_run (sharded_mega.cuh),
// which sharded_mega_pins.cu runs on PinGeometry and sharded_mega.cu on
// FixedShape<Main> and <Small>: every form gives the compiled kernel's
// result bit for bit.

#pragma once

#include "gs_pin_sm90.cuh"
#include "sharded_mega.cuh"

namespace {

// A pinned launch's arguments but its geometry (gs_sharded_mega_pinned_*).
struct PinCall {
  const void* shards;
  int n_shards, rows, cols, r_loc, c_loc, chalo, n_blocks, steps, naive,
      device;
  gs::Constants k;
  int grid_blocks, read_site;
  cudaStream_t stream;
};

template <int TAPS, bool NAIVE, typename T, bool READ_SITE, typename S,
          int MIN_BLOCKS>
__global__ void __launch_bounds__(S::NT, MIN_BLOCKS)
sharded_pin_form_kernel(const ShardDesc<T>* shards, int n_shards, int rows,
                        int cols, int r_loc, int c_loc, int chalo,
                        int n_blocks, int steps, gs::Constants k, S g) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sharded_mega_run<TAPS, NAIVE, T, READ_SITE>(
      g, shards, n_shards, rows, cols, r_loc, c_loc, chalo, n_blocks, steps,
      k, reinterpret_cast<float*>(window));
}

// One cooperative launch of `kernel` (S::NT threads a block, `bytes` of
// dynamic shared memory) with the arguments of sharded_pin_form_kernel over
// the shards of c on the tiles of g. grid_blocks <= 0 takes the co-resident
// maximum, capped at the tiles of every shard; the grid goes to *grid_out
// where that is not null. A grid smaller than n_shards is refused with
// cudaErrorInvalidValue, a larger grid than the card can hold with
// cudaErrorCooperativeLaunchTooLarge.
template <typename T, typename S, typename Kernel>
cudaError_t launch_sharded_pin(Kernel kernel, bool* allowed,
                               const PinCall& c, const S& g, size_t bytes,
                               int* grid_out) {
  int most = 0;
  cudaError_t err = sm90::pinned_coresident(kernel, allowed, c.device, bytes,
                                            &most, S::NT);
  if (err != cudaSuccess) return err;
  int grid = c.grid_blocks;
  if (grid <= 0) {
    grid = most;
    const long long tiles = static_cast<long long>(c.n_shards) *
                            ((c.c_loc + g.tc - 1) / g.tc) *
                            ((c.r_loc + g.tr - 1) / g.tr);
    if (tiles < grid) grid = static_cast<int>(tiles);
  }
  if (grid < c.n_shards) return cudaErrorInvalidValue;
  if (grid_out != nullptr) *grid_out = grid;
  PinCall a = c;
  S geo = g;
  const ShardDesc<T>* desc = static_cast<const ShardDesc<T>*>(c.shards);
  void* args[] = {&desc,    &a.n_shards, &a.rows,     &a.cols,
                  &a.r_loc, &a.c_loc,    &a.chalo,    &a.n_blocks,
                  &a.steps, &a.k,        &geo};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(S::NT), args, bytes,
                                    c.stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return err;
  }
  return cudaGetLastError();
}

// One instantiation of sharded_pin_form_kernel: its co-resident blocks at
// g and its launch.
template <int TAPS, bool NAIVE, typename T, bool READ_SITE, typename S,
          int MIN_BLOCKS>
struct ShardedPinForm {
  static auto kernel() {
    return sharded_pin_form_kernel<TAPS, NAIVE, T, READ_SITE, S, MIN_BLOCKS>;
  }

  static bool* allowed() {
    static bool done[gs::MAX_DEVICES];
    return done;
  }

  static cudaError_t blocks(int device, const S& g, int* out) {
    return sm90::pinned_coresident(kernel(), allowed(), device,
                                   sm90::pair_bytes(g), out, S::NT);
  }

  static cudaError_t launch(const PinCall& c, const S& g, int* grid_out) {
    return launch_sharded_pin<T>(kernel(), allowed(), c, g,
                                 sm90::pair_bytes(g), grid_out);
  }
};

}  // namespace
