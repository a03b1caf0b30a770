// K7 on a pinned geometry: the sharded megakernel's tile pins
// (--backend sharded --sharded-engine mega with --pallas-block-rows and/or
// --pallas-block-cols), written by hand for Hopper (sm_90a).
//
// Replaces grayscott_tpu/ops/megakernel.py:_mega_kernel with n_shards > 1
// or n_shard_cols > 1 at the `tr` and `tc` that ShardedSimulation passes it
// under those pins (grayscott_tpu/backends/sharded.py:281-321, :354-364).
// One persistent cooperative launch runs `n_blocks` time blocks over every
// shard of a mesh, exactly as sharded_mega.cu does (the same descriptors,
// counters, pushes, entry gate and read-site wait), on tr x tc tiles in
// windows of HALO (8) cells more on every side. The block body is the
// compiled kernel's own: sharded_mega_run (sharded_mega.cuh), which
// sharded_mega.cu runs on FixedShape<Main> and <Small>. On a row mesh the
// read-site gate waits for the push from below before the first tile row
// whose window reaches the bottom halo rows, which it finds from the pinned
// tile height.
//
// K7's pinned entry has two forms, and the host picks one a launch
// (ops/geometry.py:mega_pin_launch). 32x128 and 64x128 tiles on the
// default stencils' tap set run their sizes compiled in, every kernel at
// 64 registers a thread and the threads a block fitted to the window's
// bytes where the split measured that it pays:
// sharded_mega_pins_fixed.cu's gs_sharded_mega_pinned_fixed_multistep (its
// split: splits/sharded_mega_pins_ablation.cu, PERF.md §6, PR 26). Every
// other pin and any other tap set run this unit's first form, the sizes
// known at run time (gs_tile_sm90.cuh: PinGeometry) on 512 threads a block,
// bound to 64 registers a thread on the zero boundary and to one block an
// SM (111-113 registers) on the naive one: min_blocks.
//
// The grid is the co-resident block count of the launched instantiation at
// the pinned geometry's dynamic shared memory and its registers, capped at
// the tiles of every shard, and split into one group a shard;
// gs_sharded_mega_pinned_max_blocks reports a floor of it for a geometry
// (gs_sharded_mega_pinned_fixed_blocks: the compiled form's). The pins
// change how each shard is cut into tiles, not what a step computes: every
// geometry gives the compiled kernel's result bit for bit. The default
// stencils' tap set has an instantiation of its own, any other runs with
// its weights tested at run time (gs_tile_sm90.cuh: dispatch_taps_lean).

#include "sharded_mega_pins.cuh"

namespace {

using sm90::PinGeometry;

// blocks an SM the register budget allows (__launch_bounds__): Main's, 64
// registers a thread, on the zero boundary; one on the naive boundary,
// whose instantiations spilled 16-56 B at 64 registers with the tile's
// sizes held at run time (the compiled ones fit: their sizes are
// constants)
template <bool NAIVE>
constexpr int min_blocks() {
  return NAIVE ? 1 : 2;
}

template <int TAPS, bool NAIVE, typename T, bool READ_SITE>
__global__ void __launch_bounds__(PinGeometry::NT, min_blocks<NAIVE>())
sharded_mega_pinned_kernel(const ShardDesc<T>* shards, int n_shards,
                           int rows, int cols, int r_loc, int c_loc,
                           int chalo, int n_blocks, int steps,
                           gs::Constants k, PinGeometry g) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sharded_mega_run<TAPS, NAIVE, T, READ_SITE>(
      g, shards, n_shards, rows, cols, r_loc, c_loc, chalo, n_blocks, steps,
      k, reinterpret_cast<float*>(window));
}

// One instantiation: its co-resident blocks at a geometry (the first query
// on a device also allows it the most dynamic shared memory a block may
// use) and its launch (sharded_mega_pins.cuh: launch_sharded_pin).
template <int TAPS, bool NAIVE, typename T, bool READ_SITE>
struct ShardedPinned {
  static bool* allowed() {
    static bool done[gs::MAX_DEVICES];
    return done;
  }

  static cudaError_t max_blocks(int device, const PinGeometry& g, int* out) {
    return sm90::pinned_coresident(
        sharded_mega_pinned_kernel<TAPS, NAIVE, T, READ_SITE>, allowed(),
        device, g, out);
  }

  static cudaError_t launch(const PinCall& c, const PinGeometry& g) {
    return launch_sharded_pin<T>(
        sharded_mega_pinned_kernel<TAPS, NAIVE, T, READ_SITE>, allowed(), c,
        g, sm90::pin_bytes(g), nullptr);
  }
};

// Launch<TAPS>::run<T>: the instantiation of the call's boundary and wait.
template <int TAPS>
struct Launch {
  template <typename T>
  static cudaError_t run(const PinCall& c, const PinGeometry& g, T*) {
    if (c.read_site) {
      return c.naive ? ShardedPinned<TAPS, true, T, true>::launch(c, g)
                     : ShardedPinned<TAPS, false, T, true>::launch(c, g);
    }
    return c.naive ? ShardedPinned<TAPS, true, T, false>::launch(c, g)
                   : ShardedPinned<TAPS, false, T, false>::launch(c, g);
  }
};

template <typename S>
void take_fewer(int device, const PinGeometry& g, int* least,
                cudaError_t* err) {
  if (*err != cudaSuccess) return;
  int n = 0;
  *err = S::max_blocks(device, g, &n);
  if (*err == cudaSuccess && n < *least) *least = n;
}

// The fewer of *least and the co-resident blocks at g of TAPS's
// instantiations on T, both boundaries and both waits.
template <int TAPS, typename T>
void fewest_of(int device, const PinGeometry& g, int* least,
               cudaError_t* err) {
  take_fewer<ShardedPinned<TAPS, true, T, false>>(device, g, least, err);
  take_fewer<ShardedPinned<TAPS, false, T, false>>(device, g, least, err);
  take_fewer<ShardedPinned<TAPS, true, T, true>>(device, g, least, err);
  take_fewer<ShardedPinned<TAPS, false, T, true>>(device, g, least, err);
}

template <typename T>
void fewest_all(int device, const PinGeometry& g, int* least,
                cudaError_t* err) {
  fewest_of<sm90::TAPS_RING, T>(device, g, least, err);
  fewest_of<sm90::TAPS_ANY, T>(device, g, least, err);
}

template <typename T>
int multistep(const void* shards, int n_shards, int rows, int cols,
              int r_loc, int c_loc, int chalo, int n_blocks, int steps,
              int naive, int device, const float* w, float du, float dv,
              float feed, float min_feed_kill, float dt, int grid_blocks,
              int tr, int tc, int read_site, void* stream) {
  if (n_shards < 1 || rows < 1 || cols < 1 || r_loc < HALO || c_loc < 1 ||
      chalo < 0 || chalo > HALO || n_blocks < 1 || steps < 1 ||
      steps > HALO || device < 0 || device >= gs::MAX_DEVICES ||
      !sm90::pin_ok(tr, tc, HALO, steps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PinCall c = {shards, n_shards, rows, cols, r_loc, c_loc, chalo,
                     n_blocks, steps, naive, device,
                     {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
                      du, dv, feed, min_feed_kill, dt},
                     grid_blocks, read_site,
                     static_cast<cudaStream_t>(stream)};
  return static_cast<int>(sm90::dispatch_taps_lean<Launch>(
      c.k, c, sm90::pin_geometry(tr, tc, HALO), static_cast<T*>(nullptr)));
}

}  // namespace

extern "C" {

// The most blocks one cooperative launch of this unit's pinned entries (the
// first form) may have on `device` on tr x tc tiles, whatever their
// weights, boundary, wait and storage type: the fewest over their
// instantiations, a floor of what a launch takes, since the naive kernels
// run one block an SM (negative: minus the CUDA error; 0: the window does
// not fit a block). The compiled form's count is
// gs_sharded_mega_pinned_fixed_blocks's.
int gs_sharded_mega_pinned_max_blocks(int device, int tr, int tc) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!sm90::pin_ok(tr, tc, HALO, 1)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const PinGeometry g = sm90::pin_geometry(tr, tc, HALO);
  cudaError_t err = cudaSetDevice(device);
  int n = 1 << 30;
  fewest_all<float>(device, g, &n, &err);
  fewest_all<sm90::bf16>(device, g, &n, &err);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// gs_sharded_mega_multistep on tr x tc tiles of each shard (any tile whose
// window fits the shared memory a block may use), over the same
// descriptors (gs_sharded_mega_describe): its arguments, with tr and tc in
// place of the tile edge. Returns the CUDA error (0 when the launch was
// accepted), or cudaErrorInvalidValue for a geometry the entry does not
// take.
int gs_sharded_mega_pinned_multistep(
    const void* shards, int n_shards, int rows, int cols, int r_loc,
    int c_loc, int chalo, int n_blocks, int steps, int naive, int device,
    float w0, float w1, float w2, float w3, float w4, float w5, float w6,
    float w7, float w8, float du, float dv, float feed, float min_feed_kill,
    float dt, int grid_blocks, int tr, int tc, int read_site, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep<float>(shards, n_shards, rows, cols, r_loc, c_loc, chalo,
                          n_blocks, steps, naive, device, w, du, dv, feed,
                          min_feed_kill, dt, grid_blocks, tr, tc, read_site,
                          stream);
}

// gs_sharded_mega_pinned_multistep over shards with bfloat16 pairs
// (gs_sharded_mega_describe_bf16).
int gs_sharded_mega_pinned_multistep_bf16(
    const void* shards, int n_shards, int rows, int cols, int r_loc,
    int c_loc, int chalo, int n_blocks, int steps, int naive, int device,
    float w0, float w1, float w2, float w3, float w4, float w5, float w6,
    float w7, float w8, float du, float dv, float feed, float min_feed_kill,
    float dt, int grid_blocks, int tr, int tc, int read_site, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep<sm90::bf16>(shards, n_shards, rows, cols, r_loc, c_loc,
                               chalo, n_blocks, steps, naive, device, w, du,
                               dv, feed, min_feed_kill, dt, grid_blocks, tr,
                               tc, read_site, stream);
}

}  // extern "C"
