// K2 with a window ring (mega_depth), written by hand for Hopper (sm_90a).
//
// Replaces grayscott_tpu/ops/megakernel.py:_mega_kernel(depth=D) in
// single-chip mode: the ring of D window slots with D - 1 window loads in
// flight ahead of the window being stepped (:562-630), D in 3..8. The launch
// is mega.cu's (one persistent cooperative launch of `n_blocks` time blocks
// of `steps` <= HALO steps on a pair per species, slot 0 current, a grid
// barrier a time block, the odd-count slot copy), and so is every step: only
// when a window loads changes, so the result is mega.cu's bit for bit, on
// float32 and bfloat16 pairs and in the fold's mode.
//
//   - The ring (gs_tile_sm90.cuh: ring_walk, RING_SCRATCH, and
//     ring_time_block_on; mega.cuh: ring_run, which mega_pins_ring.cu runs
//     on the tile pins' geometry): `nbuf` buffers of a window pair in
//     dynamic shared memory, D + 1 for depth D (D slots and the step's
//     scratch). Each block numbers its tiles of the time block j = 0, 1,
//     ...; tile j's window starts loading once tile j - nbuf + 1 has
//     stepped, so D - 1 loads are in flight while a tile steps and D while
//     it is written out (ops/megakernel.py:ring_walk_plan is the walk's CPU
//     twin).
//   - The tile follows the bytes (ops/megakernel.py:ring_geometry, the
//     port's counterpart of grayscott_tpu's choose_mega_geometry shrinking
//     the row tile with depth): Main's 64x64 tiles (a window pair 51,200 B)
//     while the ring fits the 227 KB a block may opt into (D = 3: 204,800
//     B), else Small's 32x32 tiles (18,432 B a pair; D = 8: 165,888 B). A
//     depth clamped to 2 on Small (too few tiles for the pin, as JAX clamps
//     it, :1022-1028) runs two buffers of this kernel.
//   - The threads and the register bound follow the bytes (the second form;
//     PERF.md §6 has the split that chose it): a ring leaves one block an SM
//     on Main and at most two on Small (D = 4 and 5; one beyond), so its
//     kernels run twice the double buffer's threads, 1024 on Main and 512 on
//     Small (MainWide, SmallWide), bound to 64 registers a thread: the SM
//     keeps the double buffer's 32 warps wherever the bytes leave room for
//     them, where the first form's 512 and 256 threads at 128 registers
//     kept 16 (and 8 at D >= 6). The grid is the occupancy API's count for
//     the geometry at `nbuf` buffers (cached per buffer count). The first
//     form and the split's other parts (the ring's loads and stores alone,
//     every window waited for, the double buffer on the ring's tile and
//     grid, each tile stepped in place in D buffers) are
//     splits/mega_ring_ablation.cu's.
//
// Why reads come after writes: mega.cu's argument holds unchanged. Every
// window a block loads in time block t is one of its own tiles of block t:
// the first nbuf - 1 load when the block enters the time block, after the
// grid barrier that ended block t - 1, and each later one after a tile of
// the same block has stepped; a block never loads a tile of block t + 1
// before the barrier that ends block t. Each block's last window of block t
// is waited for (cp.async.wait_group 0) before it steps, so no load of slot
// t % 2 is in flight when the barrier lets block t + 1 write that slot.
//
// What bounds it on the card: mega.cu's, and the blocks an SM that the
// ring's bytes leave. The split (PERF.md §6) finds the ring's loads hidden
// (every window waited for at once costs under 1 %) and its loads and
// stores alone 5-12 % of its time: a ring of depth D runs as fast as the
// double buffer on the same tile and grid, so what it costs against depth
// 2 is the tile and the blocks an SM its bytes force, and at D >= 4
// Small's halo recompute (1.56x the useful cell-steps over 8 steps,
// against Main's 1.24x).

#include "mega.cuh"

namespace {

// MODE and K as mega.cu's mega_kernel; T the state's element type; G
// MainWide or SmallWide. `nbuf` window buffers of G at the start of dynamic
// shared memory.
template <typename G, int TAPS, int MODE, typename T,
          typename K = gs::Constants>
__global__ void __launch_bounds__(G::NT, G::BLOCKS_AT_64_REGS)
ring_kernel(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
            int steps, K k, int aligned, int nbuf,
            unsigned long long* barrier) {
  extern __shared__ float4 window[];  // buffers [nbuf] x species [2]
  ring_run<TAPS, MODE, sm90::RING_SCRATCH, 1>(
      sm90::FixedShape<G>{}, u_pair, v_pair, rows, cols, n_blocks, steps, k,
      aligned, nbuf, barrier, reinterpret_cast<float*>(window));
}

// One instantiation of ring_kernel: its co-resident blocks at `nbuf`
// buffers (cached per device and buffer count; the kernel is allowed the
// largest ring its geometry holds, since the attribute caps every later
// launch) and its launch. `grid_blocks` <= 0 takes the co-resident maximum
// (capped at the tile count); a larger grid is refused with
// cudaErrorCooperativeLaunchTooLarge, and nothing falls back.
template <typename G, int TAPS, int MODE, typename T,
          typename K = gs::Constants>
struct Ring {
  static int* cache(int nbuf) {
    static int blocks[sm90::RING_MAX_BUFFERS + 1][gs::MAX_DEVICES];
    return blocks[nbuf];
  }

  static constexpr size_t ALLOW = sm90::ring_max_buffers<G>() * G::PAIR_BYTES;

  static cudaError_t max_blocks(int device, int nbuf, int* out) {
    return gs::coresident_blocks(ring_kernel<G, TAPS, MODE, T, K>, device,
                                 cache(nbuf), out, G::NT,
                                 nbuf * G::PAIR_BYTES, ALLOW);
  }

  static cudaError_t launch(const Call<T, K>& c, int nbuf) {
    Call<T, K> a = c;
    const size_t plane = static_cast<size_t>(c.rows) * c.cols;
    int aligned = sm90::rows_aligned<T>(c.cols, c.u_pair, c.v_pair,
                                        c.u_pair + plane, c.v_pair + plane);
    void* args[] = {&a.u_pair, &a.v_pair, &a.rows,    &a.cols, &a.n_blocks,
                    &a.steps,  &a.k,      &aligned, &nbuf,   &a.barrier};
    return gs::launch_persistent(ring_kernel<G, TAPS, MODE, T, K>, args,
                                 c.rows, c.cols, c.grid_blocks, c.device,
                                 cache(nbuf), c.stream, dim3(G::NT),
                                 nbuf * G::PAIR_BYTES, G::TR, ALLOW);
  }
};

template <typename G, int TAPS, typename T>
cudaError_t launch_on(const Call<T>& c, int nbuf) {
  return c.naive ? Ring<G, TAPS, sm90::MODE_NAIVE, T>::launch(c, nbuf)
                 : Ring<G, TAPS, sm90::MODE_ZERO, T>::launch(c, nbuf);
}

// Launch<TAPS>::run: the instantiation of the call's tile and boundary.
template <int TAPS>
struct Launch {
  template <typename T>
  static cudaError_t run(const Call<T>& c, int tile, int nbuf) {
    return tile == sm90::Main::TR
               ? launch_on<sm90::MainWide, TAPS>(c, nbuf)
               : launch_on<sm90::SmallWide, TAPS>(c, nbuf);
  }
};

// The fold entries' instantiation (TAPS: the fold's sum,
// sm90::dispatch_fold).
template <int TAPS>
struct LaunchFold {
  template <typename T>
  static cudaError_t run(const Call<T, sm90::FoldConstants>& c, int tile,
                         int nbuf) {
    using Fold = sm90::FoldConstants;
    using Main = sm90::MainWide;
    using Small = sm90::SmallWide;
    return tile == sm90::Main::TR
               ? Ring<Main, TAPS, sm90::MODE_FOLD, T, Fold>::launch(c, nbuf)
               : Ring<Small, TAPS, sm90::MODE_FOLD, T, Fold>::launch(c,
                                                                    nbuf);
  }
};

// *least becomes the fewer of itself and R's co-resident blocks at `nbuf`
// buffers; a failed query is kept in *err, and later calls do nothing.
template <typename R>
void take_fewer(int device, int nbuf, int* least, cudaError_t* err) {
  if (*err != cudaSuccess) return;
  int n = 0;
  *err = R::max_blocks(device, nbuf, &n);
  if (*err == cudaSuccess && n < *least) *least = n;
}

// Every instantiation of geometry G on T.
template <typename G, typename T>
void fewest_of(int device, int nbuf, int* least, cudaError_t* err) {
  using Fold = sm90::FoldConstants;
  constexpr int NAIVE = sm90::MODE_NAIVE, ZERO = sm90::MODE_ZERO;
  constexpr int FOLD = sm90::MODE_FOLD;
  take_fewer<Ring<G, sm90::TAPS_RING, NAIVE, T>>(device, nbuf, least, err);
  take_fewer<Ring<G, sm90::TAPS_RING, ZERO, T>>(device, nbuf, least, err);
  take_fewer<Ring<G, sm90::TAPS_ALL, NAIVE, T>>(device, nbuf, least, err);
  take_fewer<Ring<G, sm90::TAPS_ALL, ZERO, T>>(device, nbuf, least, err);
  take_fewer<Ring<G, sm90::TAPS_CROSS, NAIVE, T>>(device, nbuf, least, err);
  take_fewer<Ring<G, sm90::TAPS_CROSS, ZERO, T>>(device, nbuf, least, err);
  take_fewer<Ring<G, sm90::TAPS_ANY, NAIVE, T>>(device, nbuf, least, err);
  take_fewer<Ring<G, sm90::TAPS_ANY, ZERO, T>>(device, nbuf, least, err);
  take_fewer<Ring<G, sm90::TAPS_SEPARABLE, FOLD, T, Fold>>(device, nbuf,
                                                           least, err);
  take_fewer<Ring<G, sm90::TAPS_CROSS, FOLD, T, Fold>>(device, nbuf, least,
                                                       err);
  take_fewer<Ring<G, sm90::TAPS_ANY, FOLD, T, Fold>>(device, nbuf, least,
                                                     err);
}

// gs_mega_ring_multistep and its bf16 twin.
template <typename T>
int multistep(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
              int steps, int naive, int device, const float* w, float du,
              float dv, float feed, float min_feed_kill, float dt,
              int grid_blocks, void* barrier, void* stream, int tile,
              int nbuf) {
  cudaError_t err;
  const Call<T> c = make_call(u_pair, v_pair, rows, cols, n_blocks, steps,
                              naive, device, w, du, dv, feed, min_feed_kill,
                              dt, grid_blocks, barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sm90::ring_ok(tile, nbuf)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(sm90::dispatch_taps<Launch>(c.k, c, tile, nbuf));
}

// gs_mega_ring_multistep_fold and its bf16 twin.
template <typename T>
int fold_multistep(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
                   int steps, int device, const float* fold, int separable,
                   int dt_is_one, int grid_blocks, void* barrier,
                   void* stream, int tile, int nbuf) {
  cudaError_t err;
  const Call<T, sm90::FoldConstants> c =
      make_fold_call(u_pair, v_pair, rows, cols, n_blocks, steps, device,
                     fold, dt_is_one, grid_blocks, barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sm90::ring_ok(tile, nbuf)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      sm90::dispatch_fold<LaunchFold>(c.k, separable, c, tile, nbuf));
}

}  // namespace

extern "C" {

// The most window buffers a ring of `tile` x `tile` tiles (64 or 32) may
// have (negative: minus cudaErrorInvalidValue).
int gs_mega_ring_max_buffers(int tile) {
  if (tile == sm90::Main::TR) return sm90::ring_max_buffers<sm90::Main>();
  if (tile == sm90::Small::TR) return sm90::ring_max_buffers<sm90::Small>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// The most blocks one cooperative launch of the ring kernel with `tile` x
// `tile` tiles and `nbuf` buffers may have on `device`, whatever its
// weights, boundary, mode and storage type (negative: minus the CUDA
// error).
int gs_mega_ring_max_blocks(int device, int tile, int nbuf) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!sm90::ring_ok(tile, nbuf)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 1 << 30;
  if (tile == sm90::Main::TR) {
    fewest_of<sm90::MainWide, float>(device, nbuf, &n, &err);
    fewest_of<sm90::MainWide, sm90::bf16>(device, nbuf, &n, &err);
  } else {
    fewest_of<sm90::SmallWide, float>(device, nbuf, &n, &err);
    fewest_of<sm90::SmallWide, sm90::bf16>(device, nbuf, &n, &err);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// gs_mega_multistep (mega.cu) on a ring of `nbuf` window buffers of `tile`
// x `tile` tiles (mega_depth D: D + 1 buffers; ops/megakernel.py:
// ring_geometry); the same result, bit for bit.
int gs_mega_ring_multistep(float* u_pair, float* v_pair, int rows, int cols,
                           int n_blocks, int steps, int naive, int device,
                           float w0, float w1, float w2, float w3, float w4,
                           float w5, float w6, float w7, float w8, float du,
                           float dv, float feed, float min_feed_kill,
                           float dt, int grid_blocks, void* barrier,
                           void* stream, int tile, int nbuf) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(u_pair, v_pair, rows, cols, n_blocks, steps, naive,
                   device, w, du, dv, feed, min_feed_kill, dt, grid_blocks,
                   barrier, stream, tile, nbuf);
}

// gs_mega_ring_multistep on bfloat16 pairs (gs_mega_multistep_bf16's
// widening on load and rounding on store, once a time block).
int gs_mega_ring_multistep_bf16(void* u_pair, void* v_pair, int rows,
                                int cols, int n_blocks, int steps, int naive,
                                int device, float w0, float w1, float w2,
                                float w3, float w4, float w5, float w6,
                                float w7, float w8, float du, float dv,
                                float feed, float min_feed_kill, float dt,
                                int grid_blocks, void* barrier, void* stream,
                                int tile, int nbuf) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(static_cast<sm90::bf16*>(u_pair),
                   static_cast<sm90::bf16*>(v_pair), rows, cols, n_blocks,
                   steps, naive, device, w, du, dv, feed, min_feed_kill, dt,
                   grid_blocks, barrier, stream, tile, nbuf);
}

// gs_mega_multistep_fold on a ring of `nbuf` buffers of `tile` x `tile`
// tiles.
int gs_mega_ring_multistep_fold(float* u_pair, float* v_pair, int rows,
                                int cols, int n_blocks, int steps, int device,
                                const float* fold, int separable,
                                int dt_is_one, int grid_blocks, void* barrier,
                                void* stream, int tile, int nbuf) {
  return fold_multistep(u_pair, v_pair, rows, cols, n_blocks, steps, device,
                        fold, separable, dt_is_one, grid_blocks, barrier,
                        stream, tile, nbuf);
}

// gs_mega_ring_multistep_fold on bfloat16 pairs.
int gs_mega_ring_multistep_fold_bf16(void* u_pair, void* v_pair, int rows,
                                     int cols, int n_blocks, int steps,
                                     int device, const float* fold,
                                     int separable, int dt_is_one,
                                     int grid_blocks, void* barrier,
                                     void* stream, int tile, int nbuf) {
  return fold_multistep(static_cast<sm90::bf16*>(u_pair),
                        static_cast<sm90::bf16*>(v_pair), rows, cols,
                        n_blocks, steps, device, fold, separable, dt_is_one,
                        grid_blocks, barrier, stream, tile, nbuf);
}

}  // extern "C"
