// K9, the row-split resident multistep, written by hand for Hopper (sm_90a).
//
// Replaces scripts/ilpsplit.py:_split_kernel (the TPU kernel that
// ilpsplit.run_split drives). It is K3 (resident.cu) with the domain split
// into `split` row slabs. On the TPU each slab's step was an independent op
// chain, to let the scheduler overlap their fixed latencies. Here the same
// split lets each slab wait only for its two neighbours instead of the
// whole grid: it tests whether K3's grid barrier a step is what holds it
// back.
//
//   - Slabs are whole tile rows: slab k owns tile rows [first_k, first_k +
//     count_k), with equal counts and the remainder given to the leading
//     slabs (ilpsplit.py:49-56, in 32-row quanta here instead of 8). Every
//     tile is stepped by K3's code on the Hopper tile stepper
//     (gs_tile_sm90.cuh: ring::load_tile and ring::step_tile: a 32^2 tile in
//     a 34^2 window at pitch 40, 256 threads each stepping a register strip
//     of 4 cells, the fixed term list on interior tiles and per-cell tests
//     on edge tiles, the tap set a template parameter) from the full
//     domain's pair, so the rows a slab owns change only who waits for
//     whom, never the result: the kernel equals K3 bit for bit at every
//     split.
//   - The grid is co-resident and even: the same number of blocks on every
//     SM, the fewest that walk the tiles in as many rounds as the
//     co-resident maximum would. At 1080x1920 the naive instantiations hold
//     5 blocks an SM (660 on 132 SMs) where K3's hold 4 (528): 2040 tiles
//     on 660 blocks left a fourth round of 60 tiles, each stepped by a
//     block alone on its SM, and took 1.39x K3's time (chip_smoke.py on
//     NVIDIA H100 80GB HBM3, 700 W; ablation part 4). The fewest blocks
//     that keep four rounds (510, not a multiple of the SMs) took 1.17x; 4
//     blocks on every SM (528, K3's grid) take K3's time. The grid is
//     divided among the slabs in proportion to their tiles, at least one
//     block each (so the grid must hold `split` blocks). Slab k's blocks
//     walk its tiles as K3's blocks walk the grid: while a tile steps, the
//     window of the block's next tile of the slab is already loading into
//     a second buffer with cp.async.
//   - One 64-bit arrival counter per slab. After step s (but the last) each
//     block of slab k adds one to counter k; before step s + 1 it waits
//     until counter k and the counters of slabs k - 1 and k + 1 show step s
//     done by all their blocks ((s + 1) x their block count). With one slab
//     this is K3's grid barrier.
//   - The TPU kernel's `unroll` (n_steps / unroll groups of `unroll` steps,
//     then the remainder) has no counterpart here: a step ends in a wait, so
//     the groups are the same steps in the same order, and the kernel runs
//     them in one loop.
//   - The block's place (slab, tile rows, blocks, the grid's width in
//     tiles) lives in shared memory, read once a tile, as K3's walk does.
//
// Why reads come after writes: step s reads pair s % 2 and writes pair
// 1 - s % 2. A tile of slab k reads, through its window's one-cell ring,
// rows of slabs k - 1 and k + 1 only, and writes rows of slab k only.
//   - Read after write: step s + 1 reads in pair (s + 1) % 2 the rows that
//     slabs k - 1, k and k + 1 wrote at step s; slab k starts step s + 1
//     only when all three have finished step s.
//   - Write after read: step s + 1 writes pair s % 2, which slabs k - 1, k
//     and k + 1 read at step s (and at the steps before it); the same wait
//     orders those reads first. Each neighbour likewise starts its step
//     s + 1 only after slab k has finished step s, so neighbours are never
//     more than one step apart, and slabs further apart share no rows.
//   - The prefetch. K3 issues a step's first window load only after its
//     grid barrier; here only after the block's slab_wait for the step
//     before has returned, since that window's ring reads rows of the
//     neighbouring slabs. Within a step the next window belongs to the same
//     step and pair, which the wait before it already covered. And no load
//     is in flight when a block arrives: a step's last tile waits for all of
//     its copies (cp_async_wait<0>) before it steps, so every read of step
//     s is done before the block counts step s done.
//   - Visibility, as in grid_barrier (gs_tile.cuh:233-263): __syncthreads()
//     orders the block's writes before thread 0's __threadfence() and
//     arrival; thread 0's fence after it sees the counts orders the other
//     slabs' writes before the block's later reads, and the closing
//     __syncthreads() extends that to the whole block. Window loads bypass
//     L1 (16-byte cp.async.cg, and __ldcg for the ragged cells), never the
//     non-coherent path, so no block sees a stale line.
//
// What bounds it on the card: K3's: instruction issue for the float32
// operations of the tree while the state fits L2, and beyond it the state's
// pass through HBM every step; the waits replace K3's grid barrier with one
// on three slabs' blocks. gs_ilpsplit_ablation runs the kernel with one part
// of the design taken out, or the first form (part 0: gs_tile.cuh's
// step_tile<1> on 34^2 windows, kept unchanged as the in-call yardstick of
// the old code), for chip_smoke.py to time what each part buys.

#include "gs_tile_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;
namespace ring = sm90::ring;  // the tile: 32^2 in a 34^2 window

constexpr int HALO = 1;  // one step per wait (the first form's window)

// Where a block works: its slab and the block counts of the slab and its
// neighbours (0 where there is none); and the grid's width in tiles.
struct Place {
  int slab;    // its index
  int first;   // its first tile row
  int count;   // its tile rows
  int block0;  // its first block
  int blocks;  // its blocks
  int blocks_above, blocks_below;
  int tiles_x;
};

// Tile rows of slab k: equal counts, the remainder to the leading slabs.
__device__ __forceinline__ void slab_rows(int k, int split, int tile_rows,
                                          int* first, int* count) {
  const int base = tile_rows / split, extra = tile_rows % split;
  *count = base + (k < extra ? 1 : 0);
  *first = k * base + min(k, extra);
}

// The block's place. Every slab gets 1 + (grid - split) x its share of the
// tile rows, rounded down (at most grid blocks in all, and fewer than
// `split` short of it), and the blocks left over go one each to the
// leading slabs.
__device__ Place find_place(int split, int tile_rows) {
  const long long spare = static_cast<long long>(gridDim.x) - split;
  int given = 0;
  for (int k = 0; k < split; ++k) {
    int first, count;
    slab_rows(k, split, tile_rows, &first, &count);
    given += 1 + static_cast<int>(spare * count / tile_rows);
  }
  const int left = static_cast<int>(gridDim.x) - given;
  Place p = {-1, 0, 0, 0, 1, 0, 0};
  int block0 = 0, prev = 0;
  for (int k = 0; k < split; ++k) {
    int first, count;
    slab_rows(k, split, tile_rows, &first, &count);
    const int blocks =
        1 + static_cast<int>(spare * count / tile_rows) + (k < left ? 1 : 0);
    if (p.slab >= 0) {  // k is the slab after the block's own
      p.blocks_below = blocks;
      break;
    }
    if (static_cast<int>(blockIdx.x) < block0 + blocks) {
      p = {k, first, count, block0, blocks, prev, 0};
    }
    prev = blocks;
    block0 += blocks;
  }
  return p;
}

// After a step: the block's arrival on its slab's counter; then the wait
// until its slab and both neighbours have finished step `done` (1, 2, ...).
__device__ __forceinline__ void slab_wait(unsigned long long* arrivals,
                                          int split, const Place& p,
                                          unsigned long long done) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    __threadfence();
    atomicAdd(arrivals + p.slab, 1ULL);
    const volatile unsigned long long* a = arrivals;
    while (a[p.slab] < done * p.blocks) __nanosleep(32);
    if (p.slab > 0) {
      while (a[p.slab - 1] < done * p.blocks_above) __nanosleep(32);
    }
    if (p.slab + 1 < split) {
      while (a[p.slab + 1] < done * p.blocks_below) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// SPECIALIZE = false takes every tile as an edge tile, PREFETCH = false
// loads each window only when its tile is due (ablations).
template <int TAPS, bool NAIVE, bool SPECIALIZE = true, bool PREFETCH = true>
__global__ void __launch_bounds__(ring::NT)
ilpsplit_kernel(float* u0, float* v0, float* u1, float* v1, int rows,
                int cols, int n_steps, int split, gs::Constants k,
                int aligned, unsigned long long* arrivals) {
  // window buffers [2] x species [2], 16-byte rows
  __shared__ __align__(16) float window[2][2][ring::CELLS];
  __shared__ Place p;
  if (threadIdx.x == 0) {
    p = find_place(split, (rows + ring::TILE - 1) / ring::TILE);
    p.tiles_x = (cols + ring::TILE - 1) / ring::TILE;
  }
  __syncthreads();

  for (int st = 0; st < n_steps; ++st) {
    const bool odd = st & 1;
    const float* in_u = odd ? u1 : u0;
    const float* in_v = odd ? v1 : v0;
    float* out_u = odd ? u0 : u1;
    float* out_v = odd ? v0 : v1;
    // the slab's tiles: [first * tiles_x, end)
    const int end = (p.first + p.count) * p.tiles_x;
    int t = p.first * p.tiles_x + static_cast<int>(blockIdx.x) - p.block0;
    int b = 0;
    if (PREFETCH && t < end) {
      ring::load_tile(in_u, in_v, window[0][0], window[0][1], t, p, rows,
                      cols, aligned);
    }
    for (; t < end; t += p.blocks) {
      const int next = t + p.blocks;
      if (!PREFETCH) {
        ring::load_tile(in_u, in_v, window[0][0], window[0][1], t, p, rows,
                        cols, aligned);
        sm90::cp_async_wait<0>();
      } else if (next < end) {
        ring::load_tile(in_u, in_v, window[b ^ 1][0], window[b ^ 1][1], next,
                        p, rows, cols, aligned);
        sm90::cp_async_wait<1>();
      } else {
        sm90::cp_async_wait<0>();
      }
      __syncthreads();  // the window of tile t is in place
      ring::step_tile<TAPS, NAIVE, SPECIALIZE>(window[b][0], window[b][1],
                                               out_u, out_v, t, p, rows,
                                               cols, k);
      __syncthreads();  // and free for the window after next
      if (PREFETCH) b ^= 1;
    }
    if (st + 1 < n_steps) slab_wait(arrivals, split, p, st + 1);
  }
}

// The first form (gs_tile.cuh: step_tile<1> on a 34^2 window of static
// shared memory, 256 threads as 32 x 8, per-cell tests on every cell), as
// K9 ran before the Hopper tile stepper: gs_ilpsplit_ablation's part 0.
__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
first_form_kernel(float* u0, float* v0, float* u1, float* v1, int rows,
                  int cols, int n_steps, int naive, int split,
                  gs::Constants k, unsigned long long* arrivals) {
  __shared__ gs::Window<HALO> s;
  __shared__ Place p;
  const int tiles_x = (cols + gs::TILE - 1) / gs::TILE;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    p = find_place(split, (rows + gs::TILE - 1) / gs::TILE);
  }
  __syncthreads();

  for (int st = 0; st < n_steps; ++st) {
    const bool odd = st & 1;
    const float* in_u = odd ? u1 : u0;
    const float* in_v = odd ? v1 : v0;
    float* out_u = odd ? u0 : u1;
    float* out_v = odd ? v0 : v1;
    for (int t = static_cast<int>(blockIdx.x) - p.block0;
         t < p.count * tiles_x; t += p.blocks) {
      gs::step_tile<HALO>(in_u, in_v, out_u, out_v, p.first + t / tiles_x,
                          t % tiles_x, rows, cols, 1, naive, k, s);
    }
    if (st + 1 < n_steps) slab_wait(arrivals, split, p, st + 1);
  }
}

int first_form_cache[gs::MAX_DEVICES];  // 0 = not known yet

struct Call {
  float *u0, *v0, *u1, *v1;
  int rows, cols, n_steps, naive, split, device;
  gs::Constants k;
  int grid_blocks;
  unsigned long long* arrivals;
  cudaStream_t stream;
  bool even;  // the even grid (else the co-resident maximum)
};

// The launch's grid: `grid_blocks`, or (<= 0) the co-resident `most`
// (blocks an SM x SMs), capped at the tile count, and if c.even with the
// fewest blocks an SM that take as many rounds of tiles; a grid smaller
// than the split is refused.
cudaError_t grid_of(const Call& c, int most, int* grid) {
  *grid = c.grid_blocks;
  if (*grid <= 0) {
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, c.device);
    if (err != cudaSuccess) return err;
    const long long tiles =
        static_cast<long long>((c.cols + ring::TILE - 1) / ring::TILE) *
        ((c.rows + ring::TILE - 1) / ring::TILE);
    long long per_sm = most / sms;
    if (c.even) {
      const long long rounds = (tiles + most - 1) / most;
      per_sm = (tiles + rounds * sms - 1) / (rounds * sms);
    }
    *grid = static_cast<int>(tiles < per_sm * sms ? tiles : per_sm * sms);
  }
  return *grid < c.split ? cudaErrorInvalidValue : cudaSuccess;
}

// One instantiation of ilpsplit_kernel: its co-resident blocks (cached per
// device) and its launch. A larger grid than the card can hold is refused
// with cudaErrorCooperativeLaunchTooLarge, and nothing falls back.
template <int TAPS, bool NAIVE, bool SPECIALIZE = true, bool PREFETCH = true>
struct Split {
  static int* cache() {
    static int blocks[gs::MAX_DEVICES];  // 0 = not known yet
    return blocks;
  }

  static cudaError_t max_blocks(int device, int* out) {
    return gs::coresident_blocks(
        ilpsplit_kernel<TAPS, NAIVE, SPECIALIZE, PREFETCH>, device, cache(),
        out, ring::NT);
  }

  static cudaError_t launch(const Call& c) {
    int most = 0, grid = 0;
    cudaError_t err = max_blocks(c.device, &most);
    if (err == cudaSuccess) err = grid_of(c, most, &grid);
    if (err != cudaSuccess) return err;
    Call a = c;
    int aligned = sm90::rows_aligned(c.cols, c.u0, c.v0, c.u1, c.v1);
    void* args[] = {&a.u0,    &a.v0,    &a.u1,  &a.v1,    &a.rows,
                    &a.cols,  &a.n_steps, &a.split, &a.k, &aligned,
                    &a.arrivals};
    return gs::launch_persistent(
        ilpsplit_kernel<TAPS, NAIVE, SPECIALIZE, PREFETCH>, args, c.rows,
        c.cols, grid, c.device, cache(), c.stream, dim3(ring::NT));
  }
};

template <int TAPS, bool SPECIALIZE = true, bool PREFETCH = true>
cudaError_t launch(const Call& c) {
  return c.naive ? Split<TAPS, true, SPECIALIZE, PREFETCH>::launch(c)
                 : Split<TAPS, false, SPECIALIZE, PREFETCH>::launch(c);
}

template <int TAPS>
struct Launch {
  static cudaError_t run(const Call& c) { return launch<TAPS>(c); }
};

// The fewer of *least and the co-resident blocks of TAPS's instantiations.
template <int TAPS>
cudaError_t fewest_blocks(int device, int* least) {
  int naive = 0, zero = 0;
  cudaError_t err = Split<TAPS, true>::max_blocks(device, &naive);
  if (err == cudaSuccess) err = Split<TAPS, false>::max_blocks(device, &zero);
  const int fewer = naive < zero ? naive : zero;
  if (fewer < *least) *least = fewer;
  return err;
}

// The C interface's checks; the call, or an error in `err`.
Call make_call(float* u0, float* v0, float* u1, float* v1, int rows,
               int cols, int n_steps, int naive, int split, int device,
               const float* w, float du, float dv, float feed,
               float min_feed_kill, float dt, int grid_blocks, void* arrivals,
               void* stream, cudaError_t* err) {
  const int tile_rows = (rows + ring::TILE - 1) / ring::TILE;
  *err = cudaSuccess;
  if (rows < 1 || cols < 1 || n_steps < 1 || split < 1 || split > tile_rows ||
      device < 0 || device >= gs::MAX_DEVICES) {
    *err = cudaErrorInvalidValue;
  } else {
    *err = cudaSetDevice(device);
  }
  return {u0, v0, u1, v1, rows, cols, n_steps, naive, split, device,
          {{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]},
           du, dv, feed, min_feed_kill, dt},
          grid_blocks, static_cast<unsigned long long*>(arrivals),
          static_cast<cudaStream_t>(stream), true};
}

}  // namespace

extern "C" {

// The most blocks one cooperative launch of the kernel may have on
// `device`, whatever its weights and boundary (negative: minus the CUDA
// error). A launch that leaves the grid to the kernel may take fewer (the
// even grid).
int gs_ilpsplit_max_blocks(int device) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 1 << 30;
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_RING>(device, &n);
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_ALL>(device, &n);
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_CROSS>(device, &n);
  if (err == cudaSuccess) err = fewest_blocks<sm90::TAPS_ANY>(device, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Enqueues one cooperative launch of `n_steps` steps on `stream`, from pair
// (u0, v0), in `split` row slabs; the result is in (u0, v0) when n_steps is
// even, else in (u1, v1), as K3's. `arrivals` is `split` zeroed 64-bit
// device words. `grid_blocks` <= 0 takes the even grid: the fewest blocks
// an SM that walk the tiles in as many rounds as the co-resident maximum
// (capped at the tile count); a larger grid than the card can hold is
// refused with cudaErrorCooperativeLaunchTooLarge. A split above the
// tile-row count, or a grid smaller than the split, is refused with
// cudaErrorInvalidValue.
// Returns the CUDA error (0 when the launch was accepted).
int gs_ilpsplit_multistep(float* u0, float* v0, float* u1, float* v1,
                          int rows, int cols, int n_steps, int naive,
                          int split, int device, float w0,
                          float w1, float w2, float w3, float w4, float w5,
                          float w6, float w7, float w8, float du, float dv,
                          float feed, float min_feed_kill, float dt,
                          int grid_blocks, void* arrivals, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  cudaError_t err;
  const Call c = make_call(u0, v0, u1, v1, rows, cols, n_steps, naive, split,
                           device, w, du, dv, feed, min_feed_kill, dt,
                           grid_blocks, arrivals, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::dispatch_taps<Launch>(c.k, c));
}

// gs_ilpsplit_multistep with one part of the design taken out, for timing
// what it buys: 0 the first form's kernel (any weights, on its co-resident
// maximum grid, as it ran), and for the weights of the default stencil's
// tap set only, 1 no interior tiles, 2 the tap set tested at run time, 3 no
// prefetch of the next tile's window, 4 the co-resident maximum grid
// instead of the even one. The result is the same.
int gs_ilpsplit_ablation(float* u0, float* v0, float* u1, float* v1,
                         int rows, int cols, int n_steps, int naive,
                         int split, int device, float w0, float w1, float w2,
                         float w3, float w4, float w5, float w6, float w7,
                         float w8, float du, float dv, float feed,
                         float min_feed_kill, float dt, int grid_blocks,
                         void* arrivals, void* stream, int part) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  cudaError_t err;
  Call c = make_call(u0, v0, u1, v1, rows, cols, n_steps, naive, split,
                     device, w, du, dv, feed, min_feed_kill, dt, grid_blocks,
                     arrivals, stream, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (part == 0) {
    c.even = false;
    int most = 0, grid = 0;
    err = gs::coresident_blocks(first_form_kernel, device, first_form_cache,
                                &most);
    if (err == cudaSuccess) err = grid_of(c, most, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&c.u0,    &c.v0,      &c.u1,    &c.v1,
                    &c.rows,  &c.cols,    &c.n_steps, &c.naive,
                    &c.split, &c.k,       &c.arrivals};
    return static_cast<int>(gs::launch_persistent(
        first_form_kernel, args, c.rows, c.cols, grid, device,
        first_form_cache, c.stream));
  }
  if (sm90::tap_mask(c.k) != sm90::TAPS_RING) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (part) {
    case 1: err = launch<sm90::TAPS_RING, false>(c); break;
    case 2: err = launch<sm90::TAPS_ANY>(c); break;
    case 3: err = launch<sm90::TAPS_RING, true, false>(c); break;
    case 4:
      c.even = false;
      err = launch<sm90::TAPS_RING>(c);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
