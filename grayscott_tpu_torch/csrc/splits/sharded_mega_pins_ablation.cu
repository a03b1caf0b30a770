// K7's pinned entry (sharded_mega_pins.cu: the sharded megakernel on the
// megakernels' tile pins) with one part of its design taken out or changed,
// for timing what each part costs. float32 and bf16 pairs, the default
// stencils' tap set, naive and zero, each time block's entry gated on every
// direction (the 2-D meshes' wait; the entry gate on a row mesh too). The
// launches are not the main path's and are not counted.
//
//   0  the first form: the tiles' sizes at run time (PinGeometry), 512
//      threads a block, bound to 64 registers a thread on the zero
//      boundary and to one block an SM on the naive one (its kernels
//      spilled at 64 registers)
//   1  the exchange alone: each time block's entry wait, the group
//      barrier, the pushes and the arrivals on part 0's grid, no tile
//      loaded, stepped or stored; its result is its input with its halos
//      exchanged
//   2  the sizes compiled in (sm90::FixedPin) at 512 threads, the naive
//      kernels too bound to 64 registers (two blocks an SM)
//   3  threads fitted to the window's bytes on run-time sizes
//      (sm90::fitted_threads) at 64 registers, the zero boundary only: the
//      naive kernels spill at 64 registers on run-time sizes, and at their
//      113 registers 1024 threads cannot launch
//   4  2 with 3
//
// Parts 2 and 4 compile the geometries the split times: 32x128 on float32
// pairs, 64x128 on bf16. Part 3 takes the windows that leave one block an
// SM (1024 threads) or two (512: part 0's kernel). Part 1 takes an even
// number of time blocks: an odd one ends in the copy of slot 1, which it
// does not fill.

#include <type_traits>

#include "../sharded_mega_pins.cuh"

namespace {

constexpr int PARTS = 5;
constexpr int TAPS = sm90::TAPS_RING;

template <int TR, int TC, int NT>
using Pin = sm90::FixedPin<TR, TC, HALO, NT>;

// Part 0's register bound (sharded_mega_pins.cu: min_blocks).
template <bool NAIVE>
constexpr int first_form_blocks() {
  return NAIVE ? 1 : 2;
}

// Part 1: sharded_mega_run's exchange with the tiles taken out.
template <typename T>
__global__ void __launch_bounds__(sm90::Main::NT, 2)
exchange_kernel(const ShardDesc<T>* shards, int n_shards, int rows, int cols,
                int r_loc, int c_loc, int chalo, int n_blocks, int steps,
                gs::Constants k, sm90::PinGeometry geo) {
  const int per = gridDim.x / n_shards, extra = gridDim.x % n_shards;
  const int b = blockIdx.x, big = extra * (per + 1);
  const int g = b < big ? b / (per + 1) : extra + (b - big) / per;
  const int rank = b - (b < big ? g * (per + 1) : big + (g - extra) * per);
  const unsigned int size = per + (g < extra ? 1 : 0);
  const ShardDesc<T>& me = shards[g];
  const size_t pitch = static_cast<size_t>(c_loc) + 2 * chalo;
  const size_t plane = (static_cast<size_t>(r_loc) + 2 * HALO) * pitch;
  for (int t = 0; t < n_blocks; ++t) {
    if (t > 0) wait_arrivals(me, t & 1, (t + 1) / 2);
    gs::group_barrier(me.counters + BARRIER, t + 1, size);
    push(me, 1 - (t & 1), r_loc, c_loc, chalo, pitch, plane, rank, size);
    arrive(me, 1 - (t & 1), t + 1, size, rank == 0);
  }
  wait_arrivals(me, n_blocks & 1, (n_blocks + 1) / 2);
}

// The launch of the call's boundary on the tiles of g, MIN_BLOCKS(NAIVE)
// blocks an SM by registers.
template <typename T, typename S, int NAIVE_BLOCKS, int ZERO_BLOCKS>
cudaError_t launch_on(const PinCall& c, const S& g, int* grid) {
  return c.naive
             ? ShardedPinForm<TAPS, true, T, false, S, NAIVE_BLOCKS>::launch(
                   c, g, grid)
             : ShardedPinForm<TAPS, false, T, false, S, ZERO_BLOCKS>::launch(
                   c, g, grid);
}

// Part 0's launch.
template <typename T>
cudaError_t launch_first(const PinCall& c, const sm90::PinGeometry& g,
                         int* grid) {
  return launch_on<T, sm90::PinGeometry, first_form_blocks<true>(),
                   first_form_blocks<false>()>(c, g, grid);
}

// Part 1: the exchange on part 0's grid.
template <typename T>
cudaError_t launch_exchange(const PinCall& c, const sm90::PinGeometry& g,
                            int* grid_out) {
  int most = 0;
  const cudaError_t err =
      c.naive ? ShardedPinForm<TAPS, true, T, false, sm90::PinGeometry,
                               first_form_blocks<true>()>::blocks(c.device,
                                                                  g, &most)
              : ShardedPinForm<TAPS, false, T, false, sm90::PinGeometry,
                               first_form_blocks<false>()>::blocks(c.device,
                                                                   g, &most);
  if (err != cudaSuccess) return err;
  static bool allowed[gs::MAX_DEVICES];
  PinCall a = c;
  const long long tiles = static_cast<long long>(c.n_shards) *
                          ((c.c_loc + g.tc - 1) / g.tc) *
                          ((c.r_loc + g.tr - 1) / g.tr);
  a.grid_blocks = tiles < most ? static_cast<int>(tiles) : most;
  return launch_sharded_pin<T>(exchange_kernel<T>, allowed, a, g,
                               sm90::pin_bytes(g), grid_out);
}

// Parts 2 (FIT false) and 4 (FIT true) on tr x tc tiles compiled in:
// cudaErrorInvalidValue where the split compiles no such geometry for T.
template <bool FIT, typename T>
cudaError_t launch_fixed(const PinCall& c, int tr, int tc, int* grid) {
  if constexpr (std::is_same_v<T, float>) {
    if (tr == 32 && tc == 128) {
      return launch_on<T, Pin<32, 128, 512>, 2, 2>(c, {}, grid);
    }
  } else {
    if (tr == 64 && tc == 128) {
      return FIT ? launch_on<T, Pin<64, 128, 1024>, 1, 1>(c, {}, grid)
                 : launch_on<T, Pin<64, 128, 512>, 2, 2>(c, {}, grid);
    }
  }
  return cudaErrorInvalidValue;
}

// Part 3 (the zero boundary) on the run-time geometry g.
template <typename T>
cudaError_t launch_fitted(const PinCall& c, const sm90::PinGeometry& g,
                          int* grid) {
  switch (sm90::fitted_threads(sm90::pin_bytes(g))) {
    case 512:
      return launch_first<T>(c, g, grid);
    case 1024:
      return ShardedPinForm<TAPS, false, T, false, sm90::PinShape<1024>,
                            1>::launch(c, sm90::pin_shape<1024>(g), grid);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(int part, const PinCall& c, int tr, int tc, int* grid) {
  const sm90::PinGeometry g = sm90::pin_geometry(tr, tc, HALO);
  switch (part) {
    case 0:
      return launch_first<T>(c, g, grid);
    case 1:
      return launch_exchange<T>(c, g, grid);
    case 2:
      return launch_fixed<false, T>(c, tr, tc, grid);
    case 3:
      return c.naive ? cudaErrorInvalidValue : launch_fitted<T>(c, g, grid);
    default:
      return launch_fixed<true, T>(c, tr, tc, grid);
  }
}

}  // namespace

extern "C" {

int gs_sharded_mega_pins_ablation_parts() { return PARTS; }

// One launch of part `part` (0..PARTS-1, above) of K7's pinned entry on tr
// x tc tiles of each shard, over the shards described at `shards`
// (gs_sharded_mega_describe or its bf16 twin, `bf16` saying which; zeroed
// counters), gs_sharded_mega_pinned_multistep's other arguments, on the
// co-resident grid of the part's kernel, which goes to *grid_out (host
// memory) when it is not null. Returns the CUDA error
// (cudaErrorInvalidValue for a part, geometry, storage, boundary, tap set
// or block count the part does not take).
int gs_sharded_mega_pins_ablation(
    int part, const void* shards, int bf16, int n_shards, int rows,
    int cols, int r_loc, int c_loc, int chalo, int n_blocks, int steps,
    int naive, int device, float w0, float w1, float w2, float w3, float w4,
    float w5, float w6, float w7, float w8, float du, float dv, float feed,
    float min_feed_kill, float dt, int tr, int tc, int* grid_out,
    void* stream) {
  const PinCall c = {shards, n_shards, rows, cols, r_loc, c_loc, chalo,
                     n_blocks, steps, naive, device,
                     {{w0, w1, w2, w3, w4, w5, w6, w7, w8},
                      du, dv, feed, min_feed_kill, dt},
                     0, 0, static_cast<cudaStream_t>(stream)};
  if (part < 0 || part >= PARTS || sm90::tap_mask(c.k) != TAPS ||
      n_shards < 1 || rows < 1 || cols < 1 || r_loc < HALO || c_loc < 1 ||
      chalo < 0 || chalo > HALO || n_blocks < 1 || steps < 1 ||
      steps > HALO || device < 0 || device >= gs::MAX_DEVICES ||
      !sm90::pin_ok(tr, tc, HALO, steps) || (part == 1 && n_blocks % 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(bf16 ? launch<sm90::bf16>(part, c, tr, tc, grid_out)
                               : launch<float>(part, c, tr, tc, grid_out));
}

}  // extern "C"
