// K7's read-site entry (sharded_mega.cu's READ_SITE kernels: a row mesh of
// shards, each waiting for the push from below only where it reads it) with
// one part of its design taken out or changed, for timing what each part
// costs. float32 pairs, the default stencils' tap set, naive and zero. The
// launches are not the main path's and are not counted.
//
//   0  the first form: Main's 64x64 tiles in 80x80 windows, register strips
//   1  the window loads and tile stores alone: no step, no push, no wait
//      (the group barrier of each time block kept); its result is its input
//   2  the exchange alone: each time block's entry wait, the read-site
//      gate's waits, the group barrier, the pushes and the arrivals, no
//      tile loaded, stepped or stored; its result is its input with its
//      halos exchanged
//   3  tile rows fitted to the shard (ops/sharded_mega.py:fitted_height) at
//      a run-time height on Main's compiled width and pitch (FitShape)
//   4  the fitted height compiled in (Fit68; Main where it is 64)
//   5  Main's tiles, interior tiles in gs_pin_sm90.cuh's 4x4 register
//      blocks with one 16-byte shared load a species a row (BlockSteps)
//   6  4 with 5
//
// Parts 1 and 2 take an even number of time blocks: an odd one ends in the
// copy of slot 1, which neither part fills.

#include "../gs_pin_sm90.cuh"
#include "../sharded_mega.cuh"

namespace {

// Part 3's tiles: a fitted tile's height at run time on Main's compiled
// width and pitch.
struct FitShape {
  static constexpr int NT = sm90::Main::NT, R = sm90::Main::R;
  int tr;
  gs::Fixed<sm90::Main::TC> tc;
  gs::Fixed<HALO> halo;
  int wr;
  gs::Fixed<sm90::Main::WC> wc;
  gs::Fixed<sm90::Main::WC> pitch;
  int cells;
};

// Parts 5 and 6's interior tiles: gs_pin_sm90.cuh's 4x4 register blocks,
// one 16-byte shared load a species a row (time_block_on's STEPS). A step
// may read one float past its input buffer (the last block of the window's
// last row: pin_step_blocks), which in time_block's double buffer may be
// the last buffer: those parts take BLOCK_PAD bytes more shared memory.
template <int TAPS, int MODE>
struct BlockSteps {
  template <typename S, typename K>
  __device__ __forceinline__ static void interior(const S& g,
                                                  const float* in_u,
                                                  const float* in_v,
                                                  float* out_u, float* out_v,
                                                  int lo, int, int, int, int,
                                                  const K& k) {
    sm90::pin_step_blocks<TAPS, MODE>(g, in_u, in_v, out_u, out_v, lo, k);
  }
};
constexpr size_t BLOCK_PAD = 16;

constexpr int PARTS = 7;
constexpr int TAPS = sm90::TAPS_RING;
// part 3's tallest tile: its window pair leaves two blocks an SM
constexpr int FIT_MAX = 72;

// Parts 1 and 2: sharded_mega_run's time blocks with the steps, or the
// tiles, taken out.
template <int PART, bool NAIVE, typename S>
__device__ __forceinline__ void part_run(const S& geo,
                                         const ShardDesc<float>* shards,
                                         int n_shards, int rows, int cols,
                                         int r_loc, int c_loc, int chalo,
                                         int n_blocks,
                                         const gs::Constants& k,
                                         float* base) {
  const int per = gridDim.x / n_shards, extra = gridDim.x % n_shards;
  const int b = blockIdx.x, big = extra * (per + 1);
  const int g = b < big ? b / (per + 1) : extra + (b - big) / per;
  const int rank = b - (b < big ? g * (per + 1) : big + (g - extra) * per);
  const unsigned int size = per + (g < extra ? 1 : 0);
  const ShardDesc<float>& me = shards[g];

  const size_t pitch = static_cast<size_t>(c_loc) + 2 * chalo;
  const size_t plane = (static_cast<size_t>(r_loc) + 2 * HALO) * pitch;
  const gs::ShardLayout mem = {me.row0, me.col0, r_loc, c_loc,
                               HALO,    chalo,   pitch};
  float* const u = me.pair[0];
  float* const v = me.pair[1];
  const int tiles_x = (c_loc + geo.tc - 1) / geo.tc;
  const int n_tiles = tiles_x * ((r_loc + geo.tr - 1) / geo.tr);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    if constexpr (PART == 1) {
      sm90::time_block_on<TAPS, NAIVE, true, true>(
          geo, mem, u + src, v + src, u + dst, v + dst, rank, size, n_tiles,
          tiles_x, me.row0, me.col0, rows, cols, 0, k, me.aligned, base);
      gs::group_barrier(me.counters + BARRIER, t + 1, size);
    } else {
      if (t > 0) wait_arrivals(me, t & 1, (t + 1) / 2, TOP_ROWS);
      const BottomGate<decltype(geo.tr), float> gate{me, t, r_loc, tiles_x,
                                                     geo.tr};
      for (int i = rank; i < n_tiles; i += size) gate(i, size);
      gs::group_barrier(me.counters + BARRIER, t + 1, size);
      push(me, 1 - (t & 1), r_loc, c_loc, chalo, pitch, plane, rank, size);
      arrive(me, 1 - (t & 1), t + 1, size, rank == 0);
    }
  }
  if constexpr (PART == 2) {
    wait_arrivals(me, n_blocks & 1, (n_blocks + 1) / 2);
  }
}

template <int PART, typename S, bool NAIVE>
__global__ void __launch_bounds__(S::NT, 2)
ablation_kernel(const ShardDesc<float>* shards, int n_shards, int rows,
                int cols, int r_loc, int c_loc, int chalo, int n_blocks,
                int steps, gs::Constants k, S geo) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  float* base = reinterpret_cast<float*>(window);
  if constexpr (PART == 1 || PART == 2) {
    part_run<PART, NAIVE>(geo, shards, n_shards, rows, cols, r_loc, c_loc,
                          chalo, n_blocks, k, base);
  } else if constexpr (PART == 5 || PART == 6) {
    sharded_mega_run<TAPS, NAIVE, float, true, BlockSteps>(
        geo, shards, n_shards, rows, cols, r_loc, c_loc, chalo, n_blocks,
        steps, k, base);
  } else {
    sharded_mega_run<TAPS, NAIVE, float, true>(geo, shards, n_shards, rows,
                                               cols, r_loc, c_loc, chalo,
                                               n_blocks, steps, k, base);
  }
}

struct AblationCall {
  const void* shards;
  int n_shards, rows, cols, r_loc, c_loc, chalo, n_blocks, steps, naive,
      device;
  gs::Constants k;
  cudaStream_t stream;
};

// One cooperative launch of PART on the tiles of geo: the co-resident
// blocks at its bytes, capped at the tiles; *grid_out gets the grid.
template <int PART, bool NAIVE, typename S>
cudaError_t launch_one(const AblationCall& c, const S& geo, int* grid_out) {
  static bool allowed[gs::MAX_DEVICES];
  auto kernel = ablation_kernel<PART, S, NAIVE>;
  const size_t bytes = 4 * sizeof(float) * static_cast<size_t>(geo.cells) +
                       (PART == 5 || PART == 6 ? BLOCK_PAD : 0);
  int most = 0;
  cudaError_t err = sm90::pinned_coresident(kernel, allowed, c.device, bytes,
                                            &most, S::NT);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(c.n_shards) *
                          ((c.c_loc + geo.tc - 1) / geo.tc) *
                          ((c.r_loc + geo.tr - 1) / geo.tr);
  const int grid = tiles < most ? static_cast<int>(tiles) : most;
  if (grid < c.n_shards) return cudaErrorInvalidValue;
  if (grid_out != nullptr) *grid_out = grid;
  AblationCall a = c;
  S g = geo;
  const ShardDesc<float>* desc = static_cast<const ShardDesc<float>*>(c.shards);
  void* args[] = {&desc,    &a.n_shards, &a.rows,     &a.cols,  &a.r_loc,
                  &a.c_loc, &a.chalo,    &a.n_blocks, &a.steps, &a.k,
                  &g};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(S::NT), args, bytes,
                                    c.stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

template <int PART, typename S>
cudaError_t launch_part(const AblationCall& c, const S& geo, int* grid_out) {
  return c.naive ? launch_one<PART, true>(c, geo, grid_out)
                 : launch_one<PART, false>(c, geo, grid_out);
}

// Part 3's geometry: a tr-row tile on Main's width and pitch.
FitShape fit_shape(int tr) {
  FitShape g = {};
  g.tr = tr;
  g.wr = tr + 2 * HALO;
  g.cells = g.wr * sm90::Main::WC;
  return g;
}

cudaError_t launch(int part, const AblationCall& c, int tr, int* grid_out) {
  using MainShape = sm90::FixedShape<sm90::Main>;
  using Fit68Shape = sm90::FixedShape<Fit68>;
  const bool main = tr == sm90::Main::TR;
  switch (part) {
    case 0:
      return launch_part<0>(c, MainShape{}, grid_out);
    case 1:
      return launch_part<1>(c, MainShape{}, grid_out);
    case 2:
      return launch_part<2>(c, MainShape{}, grid_out);
    case 3:
      return launch_part<3>(c, fit_shape(tr), grid_out);
    case 4:
      return main ? launch_part<0>(c, MainShape{}, grid_out)
                  : launch_part<4>(c, Fit68Shape{}, grid_out);
    case 5:
      return launch_part<5>(c, MainShape{}, grid_out);
    default:
      return main ? launch_part<5>(c, MainShape{}, grid_out)
                  : launch_part<6>(c, Fit68Shape{}, grid_out);
  }
}

// The tile heights a part takes: Main's 64 (parts 0-2, 5), Main's or
// Fit68's (parts 4, 6), any multiple of 4 from 12 to 72 (part 3).
bool part_takes(int part, int tr) {
  if (part == 3) return tr % 4 == 0 && tr > HALO && tr <= FIT_MAX;
  if (part == 4 || part == 6) return tr == sm90::Main::TR || tr == Fit68::TR;
  return tr == sm90::Main::TR;
}

}  // namespace

extern "C" {

int gs_sharded_mega_ablation_parts() { return PARTS; }

// One launch of part `part` (0..PARTS-1, above) of K7's read-site entry on
// tr-row tiles, over the `n_shards` shards of a row mesh described at
// `shards` (gs_sharded_mega_describe, copied to the card; zeroed
// counters), `n_blocks` time blocks of `steps` steps, on `stream`;
// float32 pairs, the default stencils' tap set (weights w0..w8). Writes
// the launch's grid to *grid_out (host memory) when it is not null.
// Returns the CUDA error (cudaErrorInvalidValue for a part, tile, tap set
// or block count the part does not take).
int gs_sharded_mega_ablation(int part, const void* shards, int n_shards,
                             int rows, int cols, int r_loc, int c_loc,
                             int chalo, int n_blocks, int steps, int naive,
                             int device, float w0, float w1, float w2,
                             float w3, float w4, float w5, float w6,
                             float w7, float w8, float du, float dv,
                             float feed, float min_feed_kill, float dt,
                             int tr, int* grid_out, void* stream) {
  const AblationCall c = {shards, n_shards, rows, cols, r_loc, c_loc,
                          chalo, n_blocks, steps, naive, device,
                          {{w0, w1, w2, w3, w4, w5, w6, w7, w8},
                           du, dv, feed, min_feed_kill, dt},
                          static_cast<cudaStream_t>(stream)};
  if (part < 0 || part >= PARTS || !part_takes(part, tr) ||
      sm90::tap_mask(c.k) != TAPS || n_shards < 2 || rows < 1 ||
      cols < 1 || r_loc < HALO || c_loc < 1 || chalo != 0 || n_blocks < 1 ||
      steps < 1 || steps > HALO || device < 0 ||
      device >= gs::MAX_DEVICES || ((part == 1 || part == 2) && n_blocks % 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(part, c, tr, grid_out));
}

}  // extern "C"
