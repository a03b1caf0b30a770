// K2, the single-card Gray-Scott megakernel, written by hand for Hopper
// (sm_90a).
//
// Replaces grayscott_tpu/ops/megakernel.py:_mega_kernel in single-chip mode
// (the TPU kernel that megastep_impl drives): a whole run of `n_blocks`
// time blocks of `steps` <= HALO steps, in one launch, on a pair
// (2, rows, cols) per species updated in place. Slot 0 holds the state at
// the launch and at its end.
//
//   - One persistent cooperative launch: the grid is at most the co-resident
//     block count (occupancy x SMs), so a grid-wide barrier is safe;
//     cudaLaunchCooperativeKernel refuses the launch otherwise.
//   - Time block t reads slot t % 2 and writes slot 1 - t % 2. Each block
//     walks its share of the 64x64 tiles and steps each as K1 does, on the
//     Hopper tile stepper (gs_tile_sm90.cuh: time_block): the tile's 80^2
//     window in dynamic shared memory (two buffers of two species, 102,400
//     B, 512 threads, two blocks an SM), register strips of 4 cells, the tap
//     set fixed at compile time, and the fixed term list with no boundary
//     arithmetic on tiles whose window lies inside the domain (82 % of the
//     tiles at 1080x1920, 94 % at 4096^2).
//   - Windows load with cp.async.cg (16 B) and __ldcg for ragged cells:
//     coherent, since in block t a tile reads what other blocks wrote in
//     t - 1. Once a tile's last step is done, the buffer that held that
//     step's input is free, and the next tile's window starts loading into
//     it before the finished tile is written out. A time block's first tile
//     loads after the grid barrier.
//   - A grid barrier ends each time block.
//   - When n_blocks is odd the state ends in slot 1, and a last pass copies
//     slot 1 to slot 0 (megakernel.py:24-31).
//
// Why reads come after writes: time block t reads only slot t % 2 and
// writes only slot 1 - t % 2, so within a block no tile reads what another
// writes. The barrier at the end of block t orders every write of t before
// every read of t + 1 (which reads the slot t wrote), and every read of t
// before block t + 1 writes slot t % 2 again; no window load is issued
// before the barrier that precedes its time block. The final copy runs
// after the barrier of the last block, so it reads slot 1 complete. Reads
// bypass L1, so a block cannot see a stale line after the barrier.
//
// What bounds it on the card: instruction issue for the float32 operations
// of the tree and the halo recompute (1.24x the useful cell-steps over 8
// steps), as in K1; each time block's state passes through L2 (or HBM
// beyond L2) once, as in K1's launch. Against K1 it saves the launch and
// pays a grid barrier a time block and the tail of its tile rounds: 510
// tiles on 264 blocks take 2 rounds at 1080x1920, the second 93 % full;
// 4096 tiles take 16 at 4096^2, the last half full. The overlap of the next
// window's load with the write-out, and the second block on each SM, hide
// the reloads. gs_mega_ablation runs the kernel with one part of the design
// taken out, or with the first stepper's kernel (part 0, kept unchanged as
// the in-call yardstick of the old code), for chip_smoke.py to time what
// each part buys.
//
// bf16 storage (gs_mega_multistep_bf16; megakernel.py:_mega_kernel with a
// bfloat16 dtype, :166-169, stores at :481 and :615): the same kernel on
// bfloat16 pairs, both slots bfloat16. Each tile's window widens to float32
// as it loads (gs_tile_sm90.cuh: the bf16 load_window, through registers,
// so the next window's load no longer overlaps the write-out), the time
// block runs in float32, and the store rounds to bfloat16 once a time
// block, so a run rounds where K1's launches and grayscott_tpu_torch's
// stencil.run_bf16 round. The odd-count copy moves the bfloat16 cells as
// they are.
//
// The fold entries (gs_mega_multistep_fold and its bf16 twin) run the second
// form of gs_fold_sm90.cuh on this walk (fold_time_block: R x C register
// blocks on interior tiles; float32 windows through TMA where the caller
// asks for it, the next window's request issued by one thread while the
// finished tile is written out). gs_mega_fold_ablation runs the first form
// (time_block's strips, the cp.async load) and each part of the split
// between the two forms.
//
// This is K2 at mega_depth 2 (the double buffer, and the default). Deeper
// rings run mega_ring.cu's kernels, a translation unit of their own that
// shares mega.cuh's call plumbing with this one.

#include "gs_fold_sm90.cuh"
#include "mega.cuh"

namespace {

// MODE: sm90::MODE_ZERO, MODE_NAIVE (K = gs::Constants) or MODE_FOLD (K =
// sm90::FoldConstants). SPECIALIZE = false takes every tile as an edge
// tile, PREFETCH = false loads each window only when its tile is due
// (ablations). T: the state's element type (float, or sm90::bf16).
template <typename G, int TAPS, int MODE, bool SPECIALIZE, bool PREFETCH,
          typename T, typename K = gs::Constants>
__global__ void __launch_bounds__(G::NT, G::BLOCKS_AT_64_REGS)
mega_kernel(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
            int steps, K k, int aligned, unsigned long long* barrier) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  mega_run<TAPS, MODE, SPECIALIZE, PREFETCH>(
      sm90::FixedShape<G>{}, u_pair, v_pair, rows, cols, n_blocks, steps, k,
      aligned, barrier, reinterpret_cast<float*>(window));
}

// The first stepper's kernel (gs_tile.cuh: step_tile<8>, 32x32 tiles in
// 48^2 windows of static shared memory, 256 threads), as K2 ran before the
// Hopper stepper: gs_mega_ablation's part 0.
__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
first_stepper_kernel(float* u_pair, float* v_pair, int rows, int cols,
                     int n_blocks, int steps, int naive, gs::Constants k,
                     unsigned long long* barrier) {
  __shared__ gs::Window<HALO> s;
  const size_t plane = static_cast<size_t>(rows) * cols;
  const int tiles_x = (cols + gs::TILE - 1) / gs::TILE;
  const int n_tiles = tiles_x * ((rows + gs::TILE - 1) / gs::TILE);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      gs::step_tile<HALO>(u_pair + src, v_pair + src, u_pair + dst,
                          v_pair + dst, i / tiles_x, i % tiles_x, rows, cols,
                          steps, naive, k, s);
    }
    if (t + 1 < n_blocks || (n_blocks & 1)) gs::grid_barrier(barrier, t + 1);
  }
  if (n_blocks & 1) {
    copy_slot(u_pair, v_pair, plane, gs::BLOCK_X * gs::BLOCK_Y,
              threadIdx.y * gs::BLOCK_X + threadIdx.x);
  }
}

int first_stepper_cache[gs::MAX_DEVICES];  // 0 = not known yet

// One instantiation of mega_kernel: its co-resident blocks (cached per
// device; the first query also allows it its dynamic shared memory) and its
// launch. `grid_blocks` <= 0 takes the co-resident maximum (capped at the
// tile count); a larger grid than the card can hold is refused with
// cudaErrorCooperativeLaunchTooLarge, and nothing falls back.
template <typename G, int TAPS, int MODE, bool SPECIALIZE = true,
          bool PREFETCH = true, typename T = float,
          typename K = gs::Constants>
struct Mega {

  static int* cache() {
    static int blocks[gs::MAX_DEVICES];  // 0 = not known yet
    return blocks;
  }

  static cudaError_t max_blocks(int device, int* out) {
    return gs::coresident_blocks(
        mega_kernel<G, TAPS, MODE, SPECIALIZE, PREFETCH, T, K>, device,
        cache(), out, G::NT, G::BYTES);
  }

  static cudaError_t launch(const Call<T, K>& c) {
    Call<T, K> a = c;
    const size_t plane = static_cast<size_t>(c.rows) * c.cols;
    int aligned = sm90::rows_aligned<T>(c.cols, c.u_pair, c.v_pair,
                                        c.u_pair + plane, c.v_pair + plane);
    void* args[] = {&a.u_pair, &a.v_pair, &a.rows,    &a.cols,   &a.n_blocks,
                    &a.steps,  &a.k,      &aligned, &a.barrier};
    return gs::launch_persistent(
        mega_kernel<G, TAPS, MODE, SPECIALIZE, PREFETCH, T, K>, args, c.rows,
        c.cols, c.grid_blocks, c.device, cache(), c.stream, dim3(G::NT),
        G::BYTES, G::TR);
  }
};

template <typename G, int TAPS, bool SPECIALIZE = true, bool PREFETCH = true,
          typename T>
cudaError_t launch(const Call<T>& c) {
  using Naive = Mega<G, TAPS, sm90::MODE_NAIVE, SPECIALIZE, PREFETCH, T>;
  using Zero = Mega<G, TAPS, sm90::MODE_ZERO, SPECIALIZE, PREFETCH, T>;
  return c.naive ? Naive::launch(c) : Zero::launch(c);
}

template <int TAPS>
struct Launch {
  template <typename T>
  static cudaError_t run(const Call<T>& c) {
    return launch<sm90::Main, TAPS>(c);
  }
};

// The fold entries' second form (gs_fold_sm90.cuh) on the register blocks
// of S: mega_run's time blocks walked by fold_time_block; TMA: the windows
// through the 3-D tensor maps (cols x rows x 2 planes) of the pairs.
template <typename S, int TAPS, bool TMA, typename T>
__global__ void __launch_bounds__(S::NT, 2)
mega_fold_kernel(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
                 int steps, sm90::FoldConstants k, int aligned,
                 unsigned long long* barrier,
                 const __grid_constant__ CUtensorMap map_u,
                 const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ __align__(128) float4 fold_window[];
  const S g{};
  float* smem = reinterpret_cast<float*>(fold_window);
  float* base = sm90::fold_base(smem);
  unsigned long long* bar = sm90::fold_barrier<S>(smem);
  if (TMA) {
    if (threadIdx.x == 0) sm90::mbar_init(bar);
    __syncthreads();
  }
  unsigned phase = 0;
  const size_t plane = static_cast<size_t>(rows) * cols;
  const int tiles_x = (cols + S::TC - 1) / S::TC;
  const int n_tiles = tiles_x * ((rows + S::TR - 1) / S::TR);
  for (int t = 0; t < n_blocks; ++t) {
    sm90::fold_time_block<TAPS, TMA>(g, u_pair, v_pair, plane, t & 1,
                                     blockIdx.x, gridDim.x, n_tiles, tiles_x,
                                     rows, cols, steps, k, aligned, &map_u,
                                     &map_v, base, bar, &phase);
    if (t + 1 < n_blocks || (n_blocks & 1)) gs::grid_barrier(barrier, t + 1);
  }
  if (n_blocks & 1) copy_slot(u_pair, v_pair, plane, S::NT, threadIdx.x);
}

// One instantiation of mega_fold_kernel: its co-resident blocks (cached per
// device) and its launch of `steps` steps a time block (0: the window
// loads and stores alone, an ablation), as Mega's.
template <typename S, int TAPS, bool TMA, typename T>
struct MegaFold {
  static constexpr size_t BYTES = sm90::fold_bytes<S>();

  static int* cache() {
    static int blocks[gs::MAX_DEVICES];  // 0 = not known yet
    return blocks;
  }

  static cudaError_t max_blocks(int device, int* out) {
    return gs::coresident_blocks(mega_fold_kernel<S, TAPS, TMA, T>, device,
                                 cache(), out, S::NT, BYTES);
  }

  static cudaError_t launch(const Call<T, sm90::FoldConstants>& c,
                            int steps) {
    Call<T, sm90::FoldConstants> a = c;
    a.steps = steps;
    const size_t plane = static_cast<size_t>(c.rows) * c.cols;
    int aligned = sm90::rows_aligned<T>(c.cols, c.u_pair, c.v_pair,
                                        c.u_pair + plane, c.v_pair + plane);
    CUtensorMap map_u = {}, map_v = {};
    if constexpr (TMA) {
      cudaError_t err =
          sm90::window_map<S>(&map_u, c.u_pair, c.rows, c.cols, 2);
      if (err == cudaSuccess) {
        err = sm90::window_map<S>(&map_v, c.v_pair, c.rows, c.cols, 2);
      }
      if (err != cudaSuccess) return err;
    }
    void* args[] = {&a.u_pair, &a.v_pair, &a.rows,    &a.cols,
                    &a.n_blocks, &a.steps, &a.k,      &aligned,
                    &a.barrier, &map_u,   &map_v};
    return gs::launch_persistent(mega_fold_kernel<S, TAPS, TMA, T>, args,
                                 c.rows, c.cols, c.grid_blocks, c.device,
                                 cache(), c.stream, dim3(S::NT), BYTES, S::TR);
  }
};

// The fold entries' blocks: 4x4 for the separable pass, 4x2 for a direct
// plan (whose three rows of C + 2 cells a species spilled at 4x4), the
// neighbour columns by scalar loads (by shuffles, the separable pass
// spilled at 64 registers and ran no faster, PERF.md §6).
template <int TAPS>
using FoldBlocks =
    std::conditional_t<TAPS == sm90::TAPS_SEPARABLE,
                       sm90::FoldShape<512, 4, 4, false>,
                       sm90::FoldShape<512, 4, 2, false>>;

// The fold entries' launch (TAPS: the fold's sum, sm90::dispatch_fold):
// the second form on FoldBlocks, through TMA when `tma`.
template <int TAPS>
struct LaunchFold {
  template <typename T>
  static cudaError_t run(const Call<T, sm90::FoldConstants>& c, int tma) {
    using Blocks = FoldBlocks<TAPS>;
    if constexpr (std::is_same<T, float>::value) {
      if (tma) return MegaFold<Blocks, TAPS, true, T>::launch(c, c.steps);
    }
    return MegaFold<Blocks, TAPS, false, T>::launch(c, c.steps);
  }
};

// The separable plan's instantiation on the blocks of S through TMA (the
// ablation parts 7-13).
template <typename S>
using TmaFold = MegaFold<S, sm90::TAPS_SEPARABLE, true, float>;

// The first form of the fold entries (time_block's strips on Main, the
// cp.async load; the separable pass) at `bytes` of dynamic shared memory,
// its co-resident grid cached per size: the ablation parts 0-3.
// SPECIALIZE = false takes every tile as an edge tile.
template <bool SPECIALIZE>
cudaError_t launch_first_fold(const Call<float, sm90::FoldConstants>& c,
                              int steps, size_t bytes) {
  static int blocks[2][gs::MAX_DEVICES];  // Main::BYTES, SMEM_OPTIN
  auto kernel = mega_kernel<sm90::Main, sm90::TAPS_SEPARABLE,
                            sm90::MODE_FOLD, SPECIALIZE, true, float,
                            sm90::FoldConstants>;
  Call<float, sm90::FoldConstants> a = c;
  a.steps = steps;
  const size_t plane = static_cast<size_t>(c.rows) * c.cols;
  int aligned = sm90::rows_aligned<float>(c.cols, c.u_pair, c.v_pair,
                                          c.u_pair + plane, c.v_pair + plane);
  void* args[] = {&a.u_pair, &a.v_pair, &a.rows,    &a.cols,   &a.n_blocks,
                  &a.steps,  &a.k,      &aligned, &a.barrier};
  return gs::launch_persistent(kernel, args, c.rows, c.cols, c.grid_blocks,
                               c.device, blocks[bytes != sm90::Main::BYTES],
                               c.stream, dim3(sm90::Main::NT), bytes,
                               sm90::Main::TR, sm90::SMEM_OPTIN);
}

// The fewer of *least and the co-resident blocks of TAPS's instantiations
// on T.
template <int TAPS, typename T>
cudaError_t fewest_blocks(int device, int* least) {
  int naive = 0, zero = 0;
  cudaError_t err = Mega<sm90::Main, TAPS, sm90::MODE_NAIVE, true, true,
                         T>::max_blocks(device, &naive);
  if (err == cudaSuccess) {
    err = Mega<sm90::Main, TAPS, sm90::MODE_ZERO, true, true,
               T>::max_blocks(device, &zero);
  }
  const int fewer = naive < zero ? naive : zero;
  if (fewer < *least) *least = fewer;
  return err;
}

// The fewer of *least and the co-resident blocks of the fold's TAPS
// instantiations on T (both loads on float32).
template <int TAPS, typename T>
cudaError_t fewest_fold_blocks(int device, int* least) {
  int n = 0, tma = 1 << 30;
  cudaError_t err =
      MegaFold<FoldBlocks<TAPS>, TAPS, false, T>::max_blocks(device, &n);
  if constexpr (std::is_same<T, float>::value) {
    if (err == cudaSuccess) {
      err = MegaFold<FoldBlocks<TAPS>, TAPS, true, T>::max_blocks(device,
                                                                   &tma);
    }
  }
  const int fewer = n < tma ? n : tma;
  if (fewer < *least) *least = fewer;
  return err;
}

// The fewer of *least and the co-resident blocks of every instantiation on
// T.
template <typename T>
cudaError_t fewest_blocks_all(int device, int* least) {
  cudaError_t err = fewest_blocks<sm90::TAPS_RING, T>(device, least);
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_ALL, T>(device, least);
  if (err == cudaSuccess) {
    err = fewest_blocks<sm90::TAPS_CROSS, T>(device, least);
  }
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_ANY, T>(device, least);
  if (err == cudaSuccess) {
    err = fewest_fold_blocks<sm90::TAPS_SEPARABLE, T>(device, least);
  }
  if (err == cudaSuccess) {
    err = fewest_fold_blocks<sm90::TAPS_CROSS, T>(device, least);
  }
  if (err == cudaSuccess) {
    err = fewest_fold_blocks<sm90::TAPS_ANY, T>(device, least);
  }
  return err;
}

// gs_mega_multistep and its bf16 twin.
template <typename T>
int multistep(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
              int steps, int naive, int device, const float* w, float du,
              float dv, float feed, float min_feed_kill, float dt,
              int grid_blocks, void* barrier, void* stream) {
  cudaError_t err;
  const Call<T> c = make_call(u_pair, v_pair, rows, cols, n_blocks, steps,
                              naive, device, w, du, dv, feed, min_feed_kill,
                              dt, grid_blocks, barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::dispatch_taps<Launch>(c.k, c));
}

// The fold entries' checks (mega.cuh: make_fold_call; `tma` 0 or 1, and 1
// only on float32 pairs whose rows TMA can describe); the call, or an
// error in `err`.
template <typename T>
Call<T, sm90::FoldConstants> make_tma_fold_call(
    T* u_pair, T* v_pair, int rows, int cols, int n_blocks, int steps,
    int device, const float* fold, int dt_is_one, int grid_blocks,
    void* barrier, void* stream, int tma, cudaError_t* err) {
  const Call<T, sm90::FoldConstants> c =
      make_fold_call(u_pair, v_pair, rows, cols, n_blocks, steps, device,
                     fold, dt_is_one, grid_blocks, barrier, stream, err);
  const size_t plane = static_cast<size_t>(rows) * cols;
  if (*err == cudaSuccess &&
      (tma < 0 || tma > 1 ||
       (tma && !(std::is_same<T, float>::value &&
                 sm90::fold_tma_ok(cols, u_pair, v_pair, u_pair + plane,
                                   v_pair + plane))))) {
    *err = cudaErrorInvalidValue;
  }
  return c;
}

// gs_mega_multistep_fold and its bf16 twin.
template <typename T>
int fold_multistep(T* u_pair, T* v_pair, int rows, int cols, int n_blocks,
                   int steps, int device, const float* fold, int separable,
                   int dt_is_one, int grid_blocks, void* barrier,
                   void* stream, int tma) {
  cudaError_t err;
  const Call<T, sm90::FoldConstants> c = make_tma_fold_call(
      u_pair, v_pair, rows, cols, n_blocks, steps, device, fold, dt_is_one,
      grid_blocks, barrier, stream, tma, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sm90::dispatch_fold<LaunchFold>(c.k, separable, c, tma));
}

}  // namespace

extern "C" {

int gs_mega_max_steps() { return HALO; }

// The most blocks one cooperative launch of the kernel may have on
// `device`, whatever its weights, boundary and storage type (negative:
// minus the CUDA error).
int gs_mega_max_blocks(int device) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 1 << 30;
  if (err == cudaSuccess) err = fewest_blocks_all<float>(device, &n);
  if (err == cudaSuccess) err = fewest_blocks_all<sm90::bf16>(device, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Enqueues one cooperative launch of `n_blocks` time blocks of `steps`
// steps on `stream`, on the pairs u_pair / v_pair (each 2 x rows x cols,
// slot 0 current). `barrier` is one zeroed 64-bit device word.
// `grid_blocks` <= 0 takes the co-resident maximum (capped at the tile
// count); a larger grid than the card can hold is refused with
// cudaErrorCooperativeLaunchTooLarge. Returns the CUDA error (0 when the
// launch was accepted).
int gs_mega_multistep(float* u_pair, float* v_pair, int rows, int cols,
                      int n_blocks, int steps, int naive, int device,
                      float w0, float w1, float w2, float w3, float w4,
                      float w5, float w6, float w7, float w8, float du,
                      float dv, float feed, float min_feed_kill, float dt,
                      int grid_blocks, void* barrier, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(u_pair, v_pair, rows, cols, n_blocks, steps, naive,
                   device, w, du, dv, feed, min_feed_kill, dt, grid_blocks,
                   barrier, stream);
}

// gs_mega_multistep on bfloat16 pairs: each window widened to float32 on
// load, each time block's `steps` steps in float32, each cell rounded to
// bfloat16 (to nearest even) on store.
int gs_mega_multistep_bf16(void* u_pair, void* v_pair, int rows, int cols,
                           int n_blocks, int steps, int naive, int device,
                           float w0, float w1, float w2, float w3, float w4,
                           float w5, float w6, float w7, float w8, float du,
                           float dv, float feed, float min_feed_kill,
                           float dt, int grid_blocks, void* barrier,
                           void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep(static_cast<sm90::bf16*>(u_pair),
                   static_cast<sm90::bf16*>(v_pair), rows, cols, n_blocks,
                   steps, naive, device, w, du, dv, feed, min_feed_kill, dt,
                   grid_blocks, barrier, stream);
}

// The folded naive reaction (megakernel.py:_mega_kernel with fast_fold;
// stencil.step_naive_fold): one cooperative launch of `n_blocks` time
// blocks of `steps` folded steps of the naive boundary, as
// gs_mega_multistep enqueues. `fold` holds gs_fold_floats() floats
// (sm90::FoldConstants' order); `separable`: the stencil's separable plan
// runs (else the direct sum); `dt_is_one`: the quadratic term is uv^2;
// `tma`: the windows load through TMA (1; only where cols is a multiple of
// 4 and both pairs 16-byte aligned, else cudaErrorInvalidValue) or with
// cp.async (0).
int gs_mega_multistep_fold(float* u_pair, float* v_pair, int rows, int cols,
                           int n_blocks, int steps, int device,
                           const float* fold, int separable, int dt_is_one,
                           int grid_blocks, void* barrier, void* stream,
                           int tma) {
  return fold_multistep(u_pair, v_pair, rows, cols, n_blocks, steps, device,
                        fold, separable, dt_is_one, grid_blocks, barrier,
                        stream, tma);
}

// gs_mega_multistep_fold on bfloat16 pairs (widened on load, rounded on
// store, once a time block; `tma` must be 0).
int gs_mega_multistep_fold_bf16(void* u_pair, void* v_pair, int rows,
                                int cols, int n_blocks, int steps,
                                int device, const float* fold, int separable,
                                int dt_is_one, int grid_blocks,
                                void* barrier, void* stream, int tma) {
  return fold_multistep(static_cast<sm90::bf16*>(u_pair),
                        static_cast<sm90::bf16*>(v_pair), rows, cols,
                        n_blocks, steps, device, fold, separable, dt_is_one,
                        grid_blocks, barrier, stream, tma);
}

// gs_mega_multistep_fold with the separable plan in another form, for
// timing what each part costs (chip_smoke.py phase 16e), numbered as
// gs_windowed_fold_ablation's parts: the first form (0), its window loads
// and stores alone (1, no step), with every tile an edge tile (2), at one
// block an SM (3, a grid of one block an SM); the second form with the
// cp.async load (5), its loads and stores alone (6, the load `tma` names);
// through TMA only (`tma` must be 1), on 4x2 blocks (7), on 8x4 blocks of
// 256 threads (8), with the neighbour columns from two scalar loads (9:
// the entry itself, here), on 2x4 blocks (10), on 416 threads (11), at a
// window pitch of 80 floats (12), every one with scalar neighbour loads.
// Part 4, the first form's walk on the exact tree, is gs_mega_multistep
// itself. The result is the fold's (the input for parts 1 and 6).
int gs_mega_fold_ablation(float* u_pair, float* v_pair, int rows, int cols,
                          int n_blocks, int steps, int device,
                          const float* fold, int separable, int dt_is_one,
                          int grid_blocks, void* barrier, void* stream,
                          int tma, int part) {
  cudaError_t err;
  const Call<float, sm90::FoldConstants> c = make_tma_fold_call(
      u_pair, v_pair, rows, cols, n_blocks, steps, device, fold, dt_is_one,
      grid_blocks, barrier, stream, tma, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!separable) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int SEP = sm90::TAPS_SEPARABLE;
  using Main = MegaFold<FoldBlocks<SEP>, SEP, false, float>;
  using MainTma = MegaFold<FoldBlocks<SEP>, SEP, true, float>;
  // (parts 7-12 time other blocks at the entry's load on shapes that load
  // through TMA, and are built for that load only)
  if (part >= 7 && !tma) return static_cast<int>(cudaErrorInvalidValue);
  switch (part) {
    case 0: err = launch_first_fold<true>(c, steps, sm90::Main::BYTES); break;
    case 1: err = launch_first_fold<true>(c, 0, sm90::Main::BYTES); break;
    case 2: err = launch_first_fold<false>(c, steps, sm90::Main::BYTES); break;
    case 3: err = launch_first_fold<true>(c, steps, sm90::SMEM_OPTIN); break;
    case 5: err = Main::launch(c, steps); break;
    case 6: err = tma ? MainTma::launch(c, 0) : Main::launch(c, 0); break;
    case 7:
      err = TmaFold<sm90::FoldShape<512, 4, 2, false>>::launch(c, steps);
      break;
    case 8:
      err = TmaFold<sm90::FoldShape<256, 8, 4, false>>::launch(c, steps);
      break;
    case 9: err = MainTma::launch(c, steps); break;
    case 10:
      err = TmaFold<sm90::FoldShape<512, 2, 4, false>>::launch(c, steps);
      break;
    case 11:
      err = TmaFold<sm90::FoldShape<416, 4, 4, false>>::launch(c, steps);
      break;
    case 12:
      err = TmaFold<sm90::FoldShape<512, 4, 4, false, 80>>::launch(c, steps);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// gs_mega_multistep with one part of the design taken out, for timing what
// it buys (weights of the default stencil's tap set only): 0 the first
// stepper's kernel, 1 no interior tiles, 2 the tap set tested at run time,
// 3 no prefetch of the next tile's window, 4 32x32 tiles in 48x48 windows.
// The result is the same.
int gs_mega_ablation(float* u_pair, float* v_pair, int rows, int cols,
                     int n_blocks, int steps, int naive, int device,
                     float w0, float w1, float w2, float w3, float w4,
                     float w5, float w6, float w7, float w8, float du,
                     float dv, float feed, float min_feed_kill, float dt,
                     int grid_blocks, void* barrier, void* stream, int part) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  cudaError_t err;
  Call<float> c = make_call(u_pair, v_pair, rows, cols, n_blocks, steps,
                            naive, device, w, du, dv, feed, min_feed_kill, dt,
                            grid_blocks, barrier, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sm90::tap_mask(c.k) != sm90::TAPS_RING) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int RING = sm90::TAPS_RING;
  switch (part) {
    case 0: {
      void* args[] = {&c.u_pair, &c.v_pair, &c.rows,  &c.cols,   &c.n_blocks,
                      &c.steps,  &c.naive,  &c.k,     &c.barrier};
      err = gs::launch_persistent(first_stepper_kernel, args, c.rows, c.cols,
                                  c.grid_blocks, c.device,
                                  first_stepper_cache, c.stream);
      break;
    }
    case 1: err = launch<sm90::Main, RING, false>(c); break;
    case 2: err = launch<sm90::Main, sm90::TAPS_ANY>(c); break;
    case 3: err = launch<sm90::Main, RING, true, false>(c); break;
    case 4: err = launch<sm90::Small, RING>(c); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
