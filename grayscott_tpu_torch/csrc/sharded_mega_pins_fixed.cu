// K7's pinned entry on the tile pins users name most, their sizes compiled
// in: the second form of gs_sharded_mega_pinned_multistep (and its bf16
// twin) on 32x128 and 64x128 tiles of each shard, at the megakernels' halo
// of 8, the default stencils' tap set, zero and naive, with the entry gate
// and with the read-site wait. The block body is the first form's
// (sharded_mega_run, on sm90::FixedPin instead of PinGeometry:
// sharded_mega_pins.cuh), so every geometry gives the compiled kernel's
// result bit for bit. With the tile's sizes constants the naive kernels fit
// 64 registers a thread (61-64, no spill), where on run-time sizes they
// spilled and were let take 111-113 registers, one block an SM: so
// 32x128's windows run two blocks an SM, and a shard's group walks its
// tiles in 3 rounds where it took 5 (0.87-0.88x the first form's time).
// The threads a block follow the window's bytes where the split measured
// that they pay (splits/sharded_mega_pins_ablation.cu, PERF.md §6, PR 26):
// 64x128's 184,320 B windows run one block of 1024 an SM on the naive
// boundary (0.92x the 512) and of 512 on the zero one, where 1024 lost.
// ops/geometry.py:mega_pin_launch chooses this form and its threads on the
// host (on_kept below holds the same table); every other pin, and any
// other tap set, runs sharded_mega_pins.cu's first form. A unit of its
// own, so that the library's units build side by side.

#include "sharded_mega_pins.cuh"

namespace {

constexpr int TAPS = sm90::TAPS_RING;

template <int TR, int TC, int NT>
using Pin = sm90::FixedPin<TR, TC, HALO, NT>;

// The kept forms: F(the entry gate's ShardedPinForm, the read-site wait's,
// Pin<...>{}) on the form of (tr, tc, threads, boundary) on T, at 64
// registers a thread, or cudaErrorInvalidValue where none is compiled.
template <typename T, int TR, int TC, int NT, bool NAIVE, typename F>
bool kept(int tr, int tc, int threads, int naive, F& f, cudaError_t* err) {
  if (tr != TR || tc != TC || threads != NT || (naive != 0) != NAIVE) {
    return false;
  }
  using S = Pin<TR, TC, NT>;
  constexpr int BLOCKS = sm90::blocks_at_64_regs(NT);
  *err = f(ShardedPinForm<TAPS, NAIVE, T, false, S, BLOCKS>{},
           ShardedPinForm<TAPS, NAIVE, T, true, S, BLOCKS>{}, S{});
  return true;
}

template <typename T, typename F>
cudaError_t on_kept(int tr, int tc, int threads, int naive, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)(kept<T, 32, 128, 512, true>(tr, tc, threads, naive, f, &err) ||
         kept<T, 32, 128, 512, false>(tr, tc, threads, naive, f, &err) ||
         kept<T, 64, 128, 1024, true>(tr, tc, threads, naive, f, &err) ||
         kept<T, 64, 128, 512, false>(tr, tc, threads, naive, f, &err));
  return err;
}

template <typename T>
int multistep(const void* shards, int n_shards, int rows, int cols,
              int r_loc, int c_loc, int chalo, int n_blocks, int steps,
              int naive, int device, const float* w, float du, float dv,
              float feed, float min_feed_kill, float dt, int grid_blocks,
              int tr, int tc, int threads, int read_site, int* grid_out,
              void* stream) {
  const PinCall c = {shards, n_shards, rows, cols, r_loc, c_loc, chalo,
                     n_blocks, steps, naive, device,
                     {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
                      du, dv, feed, min_feed_kill, dt},
                     grid_blocks, read_site,
                     static_cast<cudaStream_t>(stream)};
  if (n_shards < 1 || rows < 1 || cols < 1 || r_loc < HALO || c_loc < 1 ||
      chalo < 0 || chalo > HALO || n_blocks < 1 || steps < 1 ||
      steps > HALO || device < 0 || device >= gs::MAX_DEVICES ||
      sm90::tap_mask(c.k) != TAPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(on_kept<T>(
      tr, tc, threads, naive, [&](auto gate, auto read_site, auto g) {
        return c.read_site ? decltype(read_site)::launch(c, g, grid_out)
                           : decltype(gate)::launch(c, g, grid_out);
      }));
}

}  // namespace

extern "C" {

// The co-resident blocks on `device` of the compiled instantiation that a
// launch of tr x tc tiles on `threads` threads a block, `naive` or zero,
// with the read-site wait or the entry gate, float32 or bf16 (`bf16`),
// would take (negative: minus the CUDA error; cudaErrorInvalidValue: no
// such geometry is compiled).
int gs_sharded_mega_pinned_fixed_blocks(int device, int tr, int tc,
                                        int threads, int naive,
                                        int read_site, int bf16) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 0;
  if (err == cudaSuccess) {
    auto f = [&](auto gate, auto wait, auto g) {
      return read_site ? decltype(wait)::blocks(device, g, &n)
                       : decltype(gate)::blocks(device, g, &n);
    };
    err = bf16 ? on_kept<sm90::bf16>(tr, tc, threads, naive, f)
               : on_kept<float>(tr, tc, threads, naive, f);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// gs_sharded_mega_pinned_multistep on the compiled tr x tc tiles of
// `threads` threads a block (the default stencils' tap set; a kept form of
// its boundary), the launch's
// grid to *grid_out (host memory) where that is not null. Returns the CUDA
// error (0 when the launch was accepted), or cudaErrorInvalidValue for a
// geometry, thread count or tap set that is not compiled: nothing falls
// back to the run-time form.
int gs_sharded_mega_pinned_fixed_multistep(
    const void* shards, int n_shards, int rows, int cols, int r_loc,
    int c_loc, int chalo, int n_blocks, int steps, int naive, int device,
    float w0, float w1, float w2, float w3, float w4, float w5, float w6,
    float w7, float w8, float du, float dv, float feed, float min_feed_kill,
    float dt, int grid_blocks, int tr, int tc, int threads, int read_site,
    int* grid_out, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep<float>(shards, n_shards, rows, cols, r_loc, c_loc, chalo,
                          n_blocks, steps, naive, device, w, du, dv, feed,
                          min_feed_kill, dt, grid_blocks, tr, tc, threads,
                          read_site, grid_out, stream);
}

// gs_sharded_mega_pinned_fixed_multistep over shards with bfloat16 pairs
// (gs_sharded_mega_describe_bf16).
int gs_sharded_mega_pinned_fixed_multistep_bf16(
    const void* shards, int n_shards, int rows, int cols, int r_loc,
    int c_loc, int chalo, int n_blocks, int steps, int naive, int device,
    float w0, float w1, float w2, float w3, float w4, float w5, float w6,
    float w7, float w8, float du, float dv, float feed, float min_feed_kill,
    float dt, int grid_blocks, int tr, int tc, int threads, int read_site,
    int* grid_out, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep<sm90::bf16>(shards, n_shards, rows, cols, r_loc, c_loc,
                               chalo, n_blocks, steps, naive, device, w, du,
                               dv, feed, min_feed_kill, dt, grid_blocks, tr,
                               tc, threads, read_site, grid_out, stream);
}

}  // extern "C"
