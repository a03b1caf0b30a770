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
//     tile is stepped by K3's code (gs_tile.cuh: step_tile<1> on a 34^2
//     window) from the full domain's pair, so the rows a slab owns change
//     only who waits for whom, never the result: the kernel equals K3 bit
//     for bit at every split.
//   - The co-resident grid is divided among the slabs in proportion to
//     their tiles, at least one block each (so the grid must hold `split`
//     blocks). Slab k's blocks walk its tiles.
//   - One 64-bit arrival counter per slab. After step s (but the last) each
//     block of slab k adds one to counter k; before step s + 1 it waits
//     until counter k and the counters of slabs k - 1 and k + 1 show step s
//     done by all their blocks ((s + 1) x their block count). With one slab
//     this is K3's grid barrier.
//   - The TPU kernel's `unroll` (n_steps / unroll groups of `unroll` steps,
//     then the remainder) has no counterpart here: a step ends in a wait, so
//     the groups are the same steps in the same order, and the kernel runs
//     them in one loop.
//   - The block's place (slab, tile rows, blocks) lives in shared memory,
//     read once a tile. That keeps the kernel at K3's 40 registers and 6
//     blocks an SM without spills. A first version with the steps in
//     groups and 6 blocks forced by __launch_bounds__ spilled and took
//     1-6 % more time than K3 at split 1 (chip_smoke.py on an H100 SXM at
//     700 W); this one takes 5-6 % less.
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
//   - Visibility, as in grid_barrier (gs_tile.cuh:183-206): __syncthreads()
//     orders the block's writes before thread 0's __threadfence() and
//     arrival; thread 0's fence after it sees the counts orders the other
//     slabs' writes before the block's later reads, and the closing
//     __syncthreads() extends that to the whole block. Reads go through
//     __ldcg, never the non-coherent path, so no block sees a stale line.
//
// What bounds it on the card: K3's per-cell arithmetic and 34^2 reload; the
// waits replace K3's grid barrier with one on three slabs' blocks.

#include "gs_tile.cuh"

namespace {

constexpr int HALO = 1;  // one step per wait

// Where a block works: its slab and the block counts of the slab and its
// neighbours (0 where there is none).
struct Place {
  int slab;    // its index
  int first;   // its first tile row
  int count;   // its tile rows
  int block0;  // its first block
  int blocks;  // its blocks
  int blocks_above, blocks_below;
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

__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y)
ilpsplit_kernel(float* u0, float* v0, float* u1, float* v1, int rows,
                int cols, int n_steps, int naive, int split, gs::Constants k,
                unsigned long long* arrivals) {
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

int max_blocks_cache[gs::MAX_DEVICES];  // 0 = not known yet

}  // namespace

extern "C" {

// The most blocks one cooperative launch of the kernel may have on
// `device` (negative: minus the CUDA error).
int gs_ilpsplit_max_blocks(int device) {
  return gs::max_blocks_or_error(ilpsplit_kernel, device, max_blocks_cache);
}

// Enqueues one cooperative launch of `n_steps` steps on `stream`, from pair
// (u0, v0), in `split` row slabs; the result is in (u0, v0) when n_steps is
// even, else in (u1, v1), as K3's. `arrivals` is `split` zeroed 64-bit
// device words. `grid_blocks` <= 0 takes the co-resident maximum (capped at
// the tile count); a larger grid than the card can hold is refused with
// cudaErrorCooperativeLaunchTooLarge. A split above the tile-row count, or
// a grid smaller than the split, is refused with cudaErrorInvalidValue.
// Returns the CUDA error (0 when the launch was accepted).
int gs_ilpsplit_multistep(float* u0, float* v0, float* u1, float* v1,
                          int rows, int cols, int n_steps, int naive,
                          int split, int device, float w0,
                          float w1, float w2, float w3, float w4, float w5,
                          float w6, float w7, float w8, float du, float dv,
                          float feed, float min_feed_kill, float dt,
                          int grid_blocks, void* arrivals, void* stream) {
  const int tile_rows = (rows + gs::TILE - 1) / gs::TILE;
  if (rows < 1 || cols < 1 || n_steps < 1 || split < 1 || split > tile_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = grid_blocks;
  if (grid <= 0) {
    err = gs::coresident_blocks(ilpsplit_kernel, device, max_blocks_cache,
                                &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles =
        static_cast<long long>((cols + gs::TILE - 1) / gs::TILE) * tile_rows;
    if (tiles < grid) grid = static_cast<int>(tiles);
  }
  if (grid < split) return static_cast<int>(cudaErrorInvalidValue);
  gs::Constants k = {{w0, w1, w2, w3, w4, w5, w6, w7, w8},
                     du, dv, feed, min_feed_kill, dt};
  unsigned long long* counters = static_cast<unsigned long long*>(arrivals);
  void* args[] = {&u0, &v0, &u1, &v1, &rows, &cols, &n_steps, &naive,
                  &split, &k, &counters};
  return static_cast<int>(gs::launch_persistent(
      ilpsplit_kernel, args, rows, cols, grid, device, max_blocks_cache,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
