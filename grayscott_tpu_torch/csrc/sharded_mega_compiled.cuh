// K7's compiled tiles (64^2 and 32^2), what its two translation units
// share: the kernel, its launch, the co-resident queries, the descriptors
// and the C interface's checks. sharded_mega.cu instantiates them on
// float32 states, sharded_mega_bf16.cu on bfloat16 (two units, so that
// nvcc builds the 64 instantiations side by side). See sharded_mega.cu for
// the design.

#pragma once

#include "sharded_mega.cuh"

namespace {


// The fitted tiles (Fit68: 64 columns, 68 rows) that the read-site entry
// runs where they take fewer rounds than Main's
// (ops/sharded_mega.py:choose_tile); only READ_SITE instantiates them, in
// their own unit (sharded_mega_fit.cu).
template <typename G>
constexpr bool FITTED = G::TR != G::TC;

// G: the tile geometry (gs_tile_sm90.cuh: Main, 64^2 tiles and 512
// threads, two blocks an SM; Small, 32^2 and 256, four blocks an SM;
// Fit68 on a row mesh). READ_SITE: the shards form a row mesh (the
// read-site wait: BottomGate), else each time block's entry is gated on
// every direction. Two kernels, not a run-time flag: a flag cost the naive
// instantiations a spill.
template <typename G, int TAPS, bool NAIVE, typename T, bool READ_SITE>
__global__ void __launch_bounds__(G::NT, G::BLOCKS_AT_64_REGS)
sharded_mega_kernel(const ShardDesc<T>* shards, int n_shards, int rows,
                    int cols, int r_loc, int c_loc, int chalo, int n_blocks,
                    int steps, gs::Constants k) {
  static_assert(READ_SITE || !FITTED<G>, "fitted tiles wait at the read site");
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  sharded_mega_run<TAPS, NAIVE, T, READ_SITE>(
      sm90::FixedShape<G>{}, shards, n_shards, rows, cols, r_loc, c_loc,
      chalo, n_blocks, steps, k, reinterpret_cast<float*>(window));
}

// One instantiation: its co-resident blocks (cached per device; the first
// query also allows it its dynamic shared memory) and its launch.
template <typename G, int TAPS, bool NAIVE, typename T, bool READ_SITE>
struct Sharded {
  static int* cache() {
    static int blocks[gs::MAX_DEVICES];  // 0 = not known yet
    return blocks;
  }

  static cudaError_t max_blocks(int device, int* out) {
    return gs::coresident_blocks(
        sharded_mega_kernel<G, TAPS, NAIVE, T, READ_SITE>, device, cache(),
        out, G::NT, G::BYTES);
  }
};

struct Call {
  const void* shards;
  int n_shards, rows, cols, r_loc, c_loc, chalo, n_blocks, steps, naive,
      device;
  gs::Constants k;
  int grid_blocks, tile, read_site;
  cudaStream_t stream;
};

// `grid_blocks` <= 0 takes the co-resident maximum (capped at the tile
// count); a grid smaller than n_shards is refused with
// cudaErrorInvalidValue, a larger grid than the card can hold with
// cudaErrorCooperativeLaunchTooLarge.
template <typename G, int TAPS, bool NAIVE, typename T, bool READ_SITE>
cudaError_t launch_one(const Call& c) {
  int most = 0;
  cudaError_t err =
      Sharded<G, TAPS, NAIVE, T, READ_SITE>::max_blocks(c.device, &most);
  if (err != cudaSuccess) return err;
  int grid = c.grid_blocks;
  if (grid <= 0) {
    grid = most;
    const long long tiles = static_cast<long long>(c.n_shards) *
                            ((c.c_loc + G::TC - 1) / G::TC) *
                            ((c.r_loc + G::TR - 1) / G::TR);
    if (tiles < grid) grid = static_cast<int>(tiles);
  }
  if (grid < c.n_shards) return cudaErrorInvalidValue;
  Call a = c;
  const ShardDesc<T>* desc = static_cast<const ShardDesc<T>*>(c.shards);
  void* args[] = {&desc,      &a.n_shards, &a.rows,  &a.cols,  &a.r_loc,
                  &a.c_loc,   &a.chalo,    &a.n_blocks, &a.steps, &a.k};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(
          sharded_mega_kernel<G, TAPS, NAIVE, T, READ_SITE>),
      dim3(grid), dim3(G::NT), args, G::BYTES, c.stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return err;
  }
  return cudaGetLastError();
}

// The instantiation of the call's boundary and wait on G.
template <typename G, int TAPS, typename T>
cudaError_t launch_on(const Call& c) {
  if (c.read_site) {
    return c.naive ? launch_one<G, TAPS, true, T, true>(c)
                   : launch_one<G, TAPS, false, T, true>(c);
  }
  return c.naive ? launch_one<G, TAPS, true, T, false>(c)
                 : launch_one<G, TAPS, false, T, false>(c);
}

// LaunchFitted<TAPS>::run<T>: the read-site instantiation of the call's
// boundary on the fitted tiles (sharded_mega_fit.cu, through
// dispatch_taps_lean: the default stencils' tap set, or TAPS_ANY).
template <int TAPS>
struct LaunchFitted {
  template <typename T>
  static cudaError_t run(const Call& c, T*) {
    return c.naive ? launch_one<Fit68, TAPS, true, T, true>(c)
                   : launch_one<Fit68, TAPS, false, T, true>(c);
  }
};

// Launch<TAPS>::run<T>: the instantiation of the call's tile, boundary and
// wait on T.
template <int TAPS>
struct Launch {
  template <typename T>
  static cudaError_t run(const Call& c, T*) {
    return c.tile == sm90::Small::TR ? launch_on<sm90::Small, TAPS, T>(c)
                                     : launch_on<sm90::Main, TAPS, T>(c);
  }
};

// The fewer of *least and the co-resident blocks of S.
template <typename S>
cudaError_t take_fewer(int device, int* least) {
  int n = 0;
  const cudaError_t err = S::max_blocks(device, &n);
  if (err == cudaSuccess && n < *least) *least = n;
  return err;
}

// The fewer of *least and the co-resident blocks of the G instantiations of
// TAPS on T, both boundaries and both waits.
template <typename G, int TAPS, typename T>
cudaError_t fewest_blocks(int device, int* least) {
  cudaError_t err = take_fewer<Sharded<G, TAPS, true, T, false>>(device, least);
  if (err == cudaSuccess) {
    err = take_fewer<Sharded<G, TAPS, false, T, false>>(device, least);
  }
  if (err == cudaSuccess) {
    err = take_fewer<Sharded<G, TAPS, true, T, true>>(device, least);
  }
  if (err == cudaSuccess) {
    err = take_fewer<Sharded<G, TAPS, false, T, true>>(device, least);
  }
  return err;
}

template <typename G, typename T>
cudaError_t fewest_blocks_all(int device, int* least) {
  cudaError_t err = fewest_blocks<G, sm90::TAPS_RING, T>(device, least);
  if (err == cudaSuccess) {
    err = fewest_blocks<G, sm90::TAPS_ALL, T>(device, least);
  }
  if (err == cudaSuccess) {
    err = fewest_blocks<G, sm90::TAPS_CROSS, T>(device, least);
  }
  if (err == cudaSuccess) {
    err = fewest_blocks<G, sm90::TAPS_ANY, T>(device, least);
  }
  return err;
}

// The fewer of *least and the co-resident blocks of the fitted G's
// instantiations on T (the read-site wait, both tap sets and boundaries).
template <typename G, typename T>
cudaError_t fewest_fitted(int device, int* least) {
  constexpr int RING = sm90::TAPS_RING, ANY = sm90::TAPS_ANY;
  cudaError_t err =
      take_fewer<Sharded<G, RING, true, T, true>>(device, least);
  if (err == cudaSuccess) {
    err = take_fewer<Sharded<G, RING, false, T, true>>(device, least);
  }
  if (err == cudaSuccess) {
    err = take_fewer<Sharded<G, ANY, true, T, true>>(device, least);
  }
  if (err == cudaSuccess) {
    err = take_fewer<Sharded<G, ANY, false, T, true>>(device, least);
  }
  return err;
}

// The fewer of *least and the co-resident blocks of every T instantiation
// of the `tile` x `tile` tiles (64 or 32), after the C interface's checks
// of the device and the tile, which it makes current.
template <typename T>
cudaError_t fewest_blocks_on(int device, int tile, int* least) {
  if (device < 0 || device >= gs::MAX_DEVICES) return cudaErrorInvalidDevice;
  if (tile != sm90::Main::TR && tile != sm90::Small::TR) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return tile == sm90::Main::TR
             ? fewest_blocks_all<sm90::Main, T>(device, least)
             : fewest_blocks_all<sm90::Small, T>(device, least);
}

// gs_sharded_mega_describe and its bf16 twin (see there).
template <typename T>
int describe(void* out, T* u_pairs, T* v_pairs, void* counters, int n_rows,
             int n_cols, int r_loc, int c_loc, int chalo) {
  auto aligned16 = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  constexpr int E = sm90::vec_cells<T>();
  if (n_rows < 1 || n_cols < 1 || r_loc < HALO || c_loc < 1 || chalo < 0 ||
      c_loc % E || chalo % E || !aligned16(u_pairs) || !aligned16(v_pairs) ||
      (n_cols > 1 && (chalo < 1 || chalo > HALO || c_loc < chalo))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t pitch = static_cast<size_t>(c_loc) + 2 * chalo;
  const size_t plane = (static_cast<size_t>(r_loc) + 2 * HALO) * pitch;
  auto* desc = static_cast<ShardDesc<T>*>(out);
  auto* ctr = static_cast<unsigned long long*>(counters);
  for (int i = 0; i < n_rows; ++i) {
    for (int j = 0; j < n_cols; ++j) {
      const size_t at = static_cast<size_t>(i) * n_cols + j;
      ShardDesc<T> d = {};
      d.pair[0] = u_pairs + at * 2 * plane;
      d.pair[1] = v_pairs + at * 2 * plane;
      d.counters = ctr + at * COUNTER_WORDS;
      d.row0 = i * r_loc;
      d.col0 = j * c_loc;
      d.aligned = sm90::rows_aligned<T>(static_cast<int>(pitch), d.pair[0],
                                        d.pair[1], d.pair[0] + plane,
                                        d.pair[1] + plane);
      for (int dir = 0; dir < N_DIRS; ++dir) {
        const int ni = i + dir_row(dir), nj = j + dir_col(dir);
        if (ni < 0 || ni >= n_rows || nj < 0 || nj >= n_cols) continue;
        const size_t nat = static_cast<size_t>(ni) * n_cols + nj;
        d.nbr_pair[dir][0] = u_pairs + nat * 2 * plane;
        d.nbr_pair[dir][1] = v_pairs + nat * 2 * plane;
        d.nbr_counters[dir] = ctr + nat * COUNTER_WORDS;
      }
      desc[at] = d;
    }
  }
  return 0;
}

// gs_sharded_mega_multistep and its bf16 twin (see there); FITTED_ENTRY:
// the fitted entries' (sharded_mega_fit.cu: Fit68's tiles, the read-site
// wait, tile = 68).
template <typename T, bool FITTED_ENTRY = false>
int multistep(const void* shards, int n_shards, int rows, int cols,
              int r_loc, int c_loc, int chalo, int n_blocks, int steps,
              int naive, int device, const float* w, float du, float dv,
              float feed, float min_feed_kill, float dt, int grid_blocks,
              int tile, int read_site, void* stream) {
  if (n_shards < 1 || rows < 1 || cols < 1 || r_loc < HALO || c_loc < 1 ||
      chalo < 0 || chalo > HALO || n_blocks < 1 || steps < 1 ||
      steps > HALO || device < 0 || device >= gs::MAX_DEVICES ||
      !(FITTED_ENTRY ? tile == Fit68::TR && read_site
                     : tile == sm90::Main::TR || tile == sm90::Small::TR)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Call c = {shards, n_shards, rows, cols, r_loc, c_loc, chalo,
                  n_blocks, steps, naive, device,
                  {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
                   du, dv, feed, min_feed_kill, dt},
                  grid_blocks, tile, read_site,
                  static_cast<cudaStream_t>(stream)};
  if constexpr (FITTED_ENTRY) {
    return static_cast<int>(sm90::dispatch_taps_lean<LaunchFitted>(
        c.k, c, static_cast<T*>(nullptr)));
  } else {
    return static_cast<int>(
        sm90::dispatch_taps<Launch>(c.k, c, static_cast<T*>(nullptr)));
  }
}

}  // namespace
