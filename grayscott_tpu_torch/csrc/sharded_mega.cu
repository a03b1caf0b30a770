// K7, the sharded Gray-Scott megakernel, written by hand for Hopper
// (sm_90a).
//
// Replaces grayscott_tpu/ops/megakernel.py:_mega_kernel with n_shards > 1 or
// n_shard_cols > 1, as grayscott_tpu/parallel/halo.py:sharded_mega_run and
// sharded_mega_run2d drive it: a whole run of `n_blocks` time blocks of
// `steps` <= HALO steps over a mesh of shards, in one launch. Each shard
// holds a pair (2, HALO + r_loc + HALO, chalo + c_loc + chalo) per species
// (grayscott_tpu_torch/parallel/halo.py): its interior cells, HALO rows of
// its row neighbours' cells above and below and, on a 2-D mesh, chalo = 8
// columns of its column neighbours' cells on each side. Slot 0 holds the
// state, halos included, at the launch and at its end.
//
//   - One persistent cooperative launch for all shards of one card: the grid
//     is at most the co-resident block count, split into one contiguous
//     group of blocks per shard (the first gridDim.x % n_shards groups one
//     block larger). A grid smaller than the shard count is refused.
//   - Time block t reads slot t % 2 and writes slot 1 - t % 2. A group walks
//     its shard's 32x32 tiles and steps each as K2 does (mega.cu, through
//     gs_tile.cuh: step_tile_at<8>), at the shard's global origin: the
//     domain mask and the naive window are taken against the global
//     (rows, cols), so a shard seam is never a domain edge, and cells past
//     the domain in the last shards are written 0.0 in the window each step
//     and never stored.
//   - Each group has its own barrier; no barrier spans shards. Shards meet
//     only through arrival counters, one per (slot, direction) at the
//     receiver (the TPU's per-slot recv semaphores, megakernel.py:100-134).
//   - At the end of time block t the group pushes the boundary cells of its
//     slot 1 - t % 2 into the same slot of each neighbour, with plain stores:
//     HALO interior rows into the row neighbours' halo rows (across the
//     interior columns), chalo interior columns into the column neighbours'
//     halo columns (across the interior rows), and a HALO x chalo corner
//     into each diagonal neighbour's halo corner (megakernel.py:324-353).
//     Then one thread bumps each neighbour's counter for (slot, direction).
//   - A shard enters time block t > 0 once the counter of slot t % 2 of
//     every present neighbour shows the pushes of block t - 1: (t + 1) / 2,
//     the pushes into that slot so far. Counters only grow within a launch,
//     and the wrapper zeroes them for each launch. (Entry gating on every
//     direction, as the TPU's 2-D form does, megakernel.py:419-427.)
//   - After the last block the shard waits for the last pushes, so that its
//     halos are fresh; when n_blocks is odd it then copies slot 1, halos
//     included, to slot 0 (megakernel.py:635-671).
//
// Why reads come after writes. Within a shard, as in K2 (mega.cu): block t
// reads only slot t % 2 and writes only the interior of slot 1 - t % 2; the
// group barrier after its tiles orders every write of t before the pushes
// of t and the reads of t + 1, and every read of t before t + 1 writes slot
// t % 2 again. Across shards, every halo cell is written by exactly one
// neighbour, and only by its pushes; pushes read only the sender's interior
// and write only the receiver's halos.
//   - Read after write: the pushes of block t into slot s = 1 - t % 2 of
//     shard A are read by A in block t + 1, which A enters only after the
//     counter shows them.
//   - Write after read: the next pushes into A's slot s come at the end of
//     block t + 2. The sender B enters block t + 2 only after A's pushes of
//     block t + 1 arrived, which A makes only after all its reads of block
//     t + 1. So no push overwrites a halo cell before its reader is done
//     (megakernel.py:512-520). Counters per slot keep a push into one slot
//     from standing in for the other's (megakernel.py:382-391).
//   - Visibility: each block's pushes are ordered before the bump by
//     __syncthreads(), a __threadfence() and an arrival on the group's gather
//     counter; the group's first block waits for every arrival, fences and
//     bumps. The receiver's thread 0 sees the count, fences, and
//     __syncthreads() extends that to its block (the protocol of
//     gs::group_barrier). State is read through __ldcg, never the
//     non-coherent path.
//   - The final copy runs after the last pushes into the shard have arrived
//     and after the group barrier of the last block; nothing writes the
//     shard's slot 0 then (the last pushes into it were consumed at the entry
//     to the last block).
//
// Several cards: each shard is given to the kernel as a descriptor (its
// pairs, its counters, its global origin, and its neighbours' pairs and
// counters), built on the host (gs_sharded_mega_describe). Here all shards
// lie on one card and one launch runs them; the same kernel would run one
// shard a card with peer pointers in the descriptors.
//
// What bounds it on the card: K2's per-cell arithmetic and 1.5x halo
// recompute of 48^2 windows on tiles rounded to each shard (a shard of 270
// rows is 9 tile rows, 288 rows of work), plus a group barrier and the
// pushes (a few hundred KB a time block) per time block. The TPU kernel's
// overlap of interior rows with the exchange (its 1-D read-site waits,
// megakernel.py:451-463) is later work.

#include "gs_tile.cuh"

namespace {

constexpr int HALO = 8;  // most steps per time block, and the halo rows
constexpr int N_DIRS = 8;
// a shard's 64-bit counters: arrivals [slot][direction], its group's
// barrier and its group's push gather
constexpr int ARRIVALS = 0;
constexpr int BARRIER = 2 * N_DIRS;
constexpr int GATHER = BARRIER + 1;
constexpr int COUNTER_WORDS = GATHER + 1;

// Push direction d: the receiver's (row, column) offset in the mesh, in the
// order of megakernel.py:324-353: down, up, right, left, down-right,
// down-left, up-right, up-left.
__host__ __device__ constexpr int dir_row(int d) {
  return (d == 0 || d == 4 || d == 5) ? 1 : (d == 1 || d == 6 || d == 7) ? -1
                                                                          : 0;
}
__host__ __device__ constexpr int dir_col(int d) {
  return (d == 2 || d == 4 || d == 6) ? 1 : (d == 3 || d == 5 || d == 7) ? -1
                                                                          : 0;
}
// The direction whose pushes come from the neighbour in direction d.
__host__ __device__ constexpr int opposite(int d) {
  return d < 4 ? d ^ 1 : d ^ 3;
}

struct ShardDesc {
  float* pair[2];                  // its (U, V) pairs
  unsigned long long* counters;    // its COUNTER_WORDS counters
  int row0, col0;                  // global (row, col) of interior (0, 0)
  float* nbr_pair[N_DIRS][2];      // the neighbour in direction d, or null
  unsigned long long* nbr_counters[N_DIRS];
};

__device__ __forceinline__ bool first_thread() {
  return threadIdx.x == 0 && threadIdx.y == 0;
}

// Wait until the counter of `slot` shows `count` pushes from every present
// neighbour, then make what they pushed visible to the whole block.
__device__ __forceinline__ void wait_arrivals(const ShardDesc& me, int slot,
                                              unsigned long long count) {
  if (first_thread()) {
    const volatile unsigned long long* a =
        me.counters + ARRIVALS + slot * N_DIRS;
    for (int d = 0; d < N_DIRS; ++d) {
      if (me.nbr_pair[opposite(d)][0] == nullptr) continue;
      while (a[d] < count) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The block's share of the pushes of `slot` into every present neighbour.
__device__ __forceinline__ void push(const ShardDesc& me, int slot,
                                     int r_loc, int c_loc, int chalo,
                                     size_t pitch, size_t plane, int rank,
                                     unsigned int size) {
  constexpr int THREADS = gs::BLOCK_X * gs::BLOCK_Y;
  const size_t first =
      static_cast<size_t>(rank) * THREADS + threadIdx.y * gs::BLOCK_X +
      threadIdx.x;
  const size_t stride = static_cast<size_t>(size) * THREADS;
  const float* u = me.pair[0] + slot * plane;
  const float* v = me.pair[1] + slot * plane;
  for (int d = 0; d < N_DIRS; ++d) {
    if (me.nbr_pair[d][0] == nullptr) continue;
    float* nu = me.nbr_pair[d][0] + slot * plane;
    float* nv = me.nbr_pair[d][1] + slot * plane;
    const int dr = dir_row(d), dc = dir_col(d);
    // the band: HALO rows / chalo columns on the side of the push, else the
    // whole interior; into the receiver's opposite halo
    const int n_rows = dr ? HALO : r_loc, n_cols = dc ? chalo : c_loc;
    const int from_r = dr > 0 ? r_loc : HALO;
    const int to_r = dr > 0 ? 0 : dr < 0 ? HALO + r_loc : HALO;
    const int from_c = dc > 0 ? c_loc : chalo;
    const int to_c = dc > 0 ? 0 : dc < 0 ? chalo + c_loc : chalo;
    const size_t n = static_cast<size_t>(n_rows) * n_cols;
    for (size_t i = first; i < n; i += stride) {
      const size_t r = i / n_cols, c = i % n_cols;
      const size_t from = (from_r + r) * pitch + from_c + c;
      const size_t to = (to_r + r) * pitch + to_c + c;
      nu[to] = __ldcg(u + from);
      nv[to] = __ldcg(v + from);
    }
  }
}

// After the block's pushes of `slot` (the n-th time, n = 1, 2, ...): its
// arrival on the group's gather; the group's first block waits for all
// `size` of them and bumps each neighbour's counter of (slot, direction).
__device__ __forceinline__ void arrive(const ShardDesc& me, int slot,
                                       unsigned long long n,
                                       unsigned int size, bool leader) {
  __syncthreads();
  if (first_thread()) {
    __threadfence();
    atomicAdd(me.counters + GATHER, 1ULL);
    if (leader) {
      const volatile unsigned long long* gather = me.counters + GATHER;
      while (*gather < n * size) __nanosleep(32);
      __threadfence();
      for (int d = 0; d < N_DIRS; ++d) {
        if (me.nbr_counters[d] == nullptr) continue;
        atomicAdd(me.nbr_counters[d] + ARRIVALS + slot * N_DIRS + d, 1ULL);
      }
    }
  }
}

// 6 blocks an SM, as K2 runs: left free, ptxas takes 48 registers (the
// shard layout stays live across the step loop) and 5 blocks fit an SM.
__global__ void __launch_bounds__(gs::BLOCK_X * gs::BLOCK_Y, 6)
sharded_mega_kernel(const ShardDesc* shards, int n_shards, int rows,
                    int cols, int r_loc, int c_loc, int chalo, int n_blocks,
                    int steps, int naive, gs::Constants k) {
  __shared__ gs::Window<HALO> s;
  // the block's shard g and its rank among the shard's `size` blocks
  const int per = gridDim.x / n_shards, extra = gridDim.x % n_shards;
  const int b = blockIdx.x, big = extra * (per + 1);
  const int g = b < big ? b / (per + 1) : extra + (b - big) / per;
  const int rank = b - (b < big ? g * (per + 1) : big + (g - extra) * per);
  const unsigned int size = per + (g < extra ? 1 : 0);
  const ShardDesc& me = shards[g];

  const size_t pitch = static_cast<size_t>(c_loc) + 2 * chalo;
  const size_t plane = (static_cast<size_t>(r_loc) + 2 * HALO) * pitch;
  const gs::ShardLayout mem = {me.row0, me.col0, r_loc, c_loc,
                               HALO,    chalo,   pitch};
  float* const u = me.pair[0];
  float* const v = me.pair[1];
  const int tiles_x = (c_loc + gs::TILE - 1) / gs::TILE;
  const int n_tiles = tiles_x * ((r_loc + gs::TILE - 1) / gs::TILE);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    if (t > 0) wait_arrivals(me, t & 1, (t + 1) / 2);
    for (int i = rank; i < n_tiles; i += size) {
      gs::step_tile_at<HALO>(mem, u + src, v + src, u + dst, v + dst,
                             me.row0 + (i / tiles_x) * gs::TILE - HALO,
                             me.col0 + (i % tiles_x) * gs::TILE - HALO, rows,
                             cols, steps, naive, k, s);
    }
    gs::group_barrier(me.counters + BARRIER, t + 1, size);
    push(me, 1 - (t & 1), r_loc, c_loc, chalo, pitch, plane, rank, size);
    arrive(me, 1 - (t & 1), t + 1, size, rank == 0);
  }
  wait_arrivals(me, n_blocks & 1, (n_blocks + 1) / 2);
  if (n_blocks & 1) {
    constexpr int THREADS = gs::BLOCK_X * gs::BLOCK_Y;
    const size_t stride = static_cast<size_t>(size) * THREADS;
    for (size_t i = static_cast<size_t>(rank) * THREADS +
                    threadIdx.y * gs::BLOCK_X + threadIdx.x;
         i < plane; i += stride) {
      u[i] = __ldcg(u + plane + i);
      v[i] = __ldcg(v + plane + i);
    }
  }
}

int max_blocks_cache[gs::MAX_DEVICES];  // 0 = not known yet

}  // namespace

extern "C" {

int gs_sharded_mega_max_steps() { return HALO; }

int gs_sharded_mega_counter_words() { return COUNTER_WORDS; }

int gs_sharded_mega_desc_bytes() { return sizeof(ShardDesc); }

// The most blocks one cooperative launch of the kernel may have on
// `device` (negative: minus the CUDA error).
int gs_sharded_mega_max_blocks(int device) {
  return gs::max_blocks_or_error(sharded_mega_kernel, device,
                                 max_blocks_cache);
}

// Writes to `out` (host memory) the descriptors of the n_rows x n_cols
// shards, row-major, whose pairs are the sub-tensors of `u_pairs` and
// `v_pairs` (n_rows, n_cols, 2, HALO + r_loc + HALO, chalo + c_loc + chalo)
// and whose counters are COUNTER_WORDS each of `counters`, all on one card.
// Returns cudaErrorInvalidValue for a geometry the kernel does not take.
int gs_sharded_mega_describe(void* out, float* u_pairs, float* v_pairs,
                             void* counters, int n_rows, int n_cols,
                             int r_loc, int c_loc, int chalo) {
  if (n_rows < 1 || n_cols < 1 || r_loc < HALO || c_loc < 1 || chalo < 0 ||
      (n_cols > 1 && (chalo < 1 || chalo > HALO || c_loc < chalo))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t pair = 2 * (static_cast<size_t>(r_loc) + 2 * HALO) *
                      (static_cast<size_t>(c_loc) + 2 * chalo);
  auto* desc = static_cast<ShardDesc*>(out);
  auto* ctr = static_cast<unsigned long long*>(counters);
  for (int i = 0; i < n_rows; ++i) {
    for (int j = 0; j < n_cols; ++j) {
      const size_t at = static_cast<size_t>(i) * n_cols + j;
      ShardDesc d = {};
      d.pair[0] = u_pairs + at * pair;
      d.pair[1] = v_pairs + at * pair;
      d.counters = ctr + at * COUNTER_WORDS;
      d.row0 = i * r_loc;
      d.col0 = j * c_loc;
      for (int dir = 0; dir < N_DIRS; ++dir) {
        const int ni = i + dir_row(dir), nj = j + dir_col(dir);
        if (ni < 0 || ni >= n_rows || nj < 0 || nj >= n_cols) continue;
        const size_t nat = static_cast<size_t>(ni) * n_cols + nj;
        d.nbr_pair[dir][0] = u_pairs + nat * pair;
        d.nbr_pair[dir][1] = v_pairs + nat * pair;
        d.nbr_counters[dir] = ctr + nat * COUNTER_WORDS;
      }
      desc[at] = d;
    }
  }
  return 0;
}

// Enqueues one cooperative launch of `n_blocks` time blocks of `steps`
// steps on `stream`, over the `n_shards` shards described in device memory
// at `shards` (gs_sharded_mega_describe, copied to the card), of a
// rows x cols domain. Each shard's counters must be zero. `grid_blocks`
// <= 0 takes the co-resident maximum (capped at the tile count); a larger
// grid than the card can hold is refused with
// cudaErrorCooperativeLaunchTooLarge, and a grid smaller than n_shards with
// cudaErrorInvalidValue. Returns the CUDA error (0 when the launch was
// accepted).
int gs_sharded_mega_multistep(const void* shards, int n_shards, int rows,
                              int cols, int r_loc, int c_loc, int chalo,
                              int n_blocks, int steps, int naive, int device,
                              float w0, float w1, float w2, float w3,
                              float w4, float w5, float w6, float w7,
                              float w8, float du, float dv, float feed,
                              float min_feed_kill, float dt, int grid_blocks,
                              void* stream) {
  if (n_shards < 1 || rows < 1 || cols < 1 || r_loc < HALO || c_loc < 1 ||
      chalo < 0 || chalo > HALO || n_blocks < 1 || steps < 1 ||
      steps > HALO) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = grid_blocks;
  if (grid <= 0) {
    err = gs::coresident_blocks(sharded_mega_kernel, device,
                                max_blocks_cache, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles =
        static_cast<long long>(n_shards) *
        ((c_loc + gs::TILE - 1) / gs::TILE) *
        ((r_loc + gs::TILE - 1) / gs::TILE);
    if (tiles < grid) grid = static_cast<int>(tiles);
  }
  if (grid < n_shards) return static_cast<int>(cudaErrorInvalidValue);
  gs::Constants k = {{w0, w1, w2, w3, w4, w5, w6, w7, w8},
                     du, dv, feed, min_feed_kill, dt};
  const ShardDesc* desc = static_cast<const ShardDesc*>(shards);
  void* args[] = {&desc,     &n_shards, &rows,  &cols,  &r_loc, &c_loc,
                  &chalo,    &n_blocks, &steps, &naive, &k};
  return static_cast<int>(gs::launch_persistent(
      sharded_mega_kernel, args, rows, cols, grid, device, max_blocks_cache,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
