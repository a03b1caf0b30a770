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
//     its shard's tiles and steps each as K2 does (mega.cu, on the Hopper
//     tile stepper, gs_tile_sm90.cuh: time_block, with the shard's layout,
//     gs::ShardLayout), at the shard's global origin: the interior test,
//     the domain mask and the naive window are taken against the global
//     (rows, cols), so a shard seam is never a domain edge and tiles along
//     a seam are interior tiles; cells the shard's buffer does not hold load
//     as 0.0 (with steps <= HALO they cannot reach a stored cell), and only
//     cells in the domain that the shard stores are written. Two tile
//     geometries are built: 64x64 tiles in 80^2 windows (512 threads, two
//     blocks an SM) and 32x32 in 48^2 (256 threads); the wrapper picks one
//     per mesh from the rounds of tiles each needs
//     (ops/sharded_mega.py:choose_tile).
//   - Each group has its own barrier; no barrier spans shards. Shards meet
//     only through arrival counters, one per (slot, direction) at the
//     receiver (the TPU's per-slot recv semaphores, megakernel.py:100-134).
//   - At the end of time block t the group pushes the boundary cells of its
//     slot 1 - t % 2 into the same slot of each neighbour, with plain stores:
//     HALO interior rows into the row neighbours' halo rows (across the
//     interior columns), chalo interior columns into the column neighbours'
//     halo columns (across the interior rows), and a HALO x chalo corner
//     into each diagonal neighbour's halo corner (megakernel.py:324-353),
//     as 16-byte float4 copies (every band's width is a multiple of 4).
//     Then one thread bumps each neighbour's counter for (slot, direction).
//   - On a 2-D mesh, and on a row mesh run with read_site = 0 (the
//     entry-gated kernel, kept to time the read-site wait against), a shard
//     enters time block t > 0 once the counter of slot t % 2 of every
//     present neighbour shows the pushes of block t - 1: (t + 1) / 2, the
//     pushes into that slot so far (the TPU's 2-D form, megakernel.py:
//     419-427). Counters only grow within a launch, and the wrapper zeroes
//     them for each launch.
//   - On a row mesh (read_site = 1, a kernel of its own; the TPU's 1-D
//     read-site waits, megakernel.py:428-463) a shard enters block t once
//     the pushes of its neighbour above (its top halo rows) have arrived,
//     steps every tile whose window stops above its bottom halo rows, and
//     waits for the pushes of its neighbour below only before it loads the
//     first tile whose window reaches them (tile rows from (r_loc - HALO) /
//     TR on). The interior tiles step while that push is in flight. The
//     wait comes before the load, not before the step: time_block's
//     PREFETCH loads the next tile's window while it writes the current one
//     out, so time_block calls the wait's gate (BottomGate) before every
//     window load it issues, the prefetch's included.
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
//     shard A are read by A in block t + 1. Under the entry gate A enters
//     block t + 1 only after the counter shows all of them. Under the
//     read-site wait A reads its top halo rows only in windows of tile row
//     0, which load after the entry wait for the pushes from above, and its
//     bottom halo rows only in windows from tile row (r_loc - HALO) / TR
//     on, which load after the wait for the pushes from below: each block
//     waits before it loads the first of its tiles there (the prefetch's
//     load included), and its later tiles come after that one.
//   - Write after read: the next pushes into A's slot s come at the end of
//     block t + 2, after B's group barrier of that block. Before it, B has
//     seen A's pushes of block t + 1 arrive: the entry gate waits for every
//     neighbour at the entry; the read-site form waits for the neighbour
//     above at the entry, and for the one below in each block that loads a
//     tile of the bottom rows, of which the group has at least one, ahead of
//     the group barrier, whose fences order the others after it. A makes
//     those pushes only after its own group barrier, after all its reads of
//     block t + 1. So no push overwrites a halo cell before
//     its reader is done (megakernel.py:512-520). Counters per slot keep a
//     push into one slot from standing in for the other's
//     (megakernel.py:382-391).
//   - No window load crosses a group barrier or a wait for arrivals: a time
//     block's first tile loads after both, and the gate's wait, whose
//     __syncthreads() comes after the previous tile's last step, precedes
//     the load it guards.
//   - Visibility: each block's pushes are ordered before the bump by
//     __syncthreads(), a __threadfence() and an arrival on the group's gather
//     counter; the group's first block waits for every arrival, fences and
//     bumps. The receiver's thread 0 sees the count, fences, and
//     __syncthreads() extends that to its block (the protocol of
//     gs::group_barrier). State is read through __ldcg and cp.async.cg,
//     never the non-coherent path or L1.
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
// What bounds it on the card: K2's (mega.cu): instruction issue for the
// tree and the halo recompute on tiles rounded to each shard, plus a group
// barrier and the pushes (a few hundred KB a time block) per time block.
// Each shard's tiles are walked by its own group of about 1/n_shards of the
// co-resident blocks, so a mesh can take more rounds of tiles than K2 (2x2
// at 1080x1920: 135 tiles of 64^2 a shard on 66 blocks, 3 rounds, where K2
// takes 2); the 32^2 geometry, with more blocks an SM, can take fewer. On a
// row mesh the read-site wait lets a shard's interior tile rows step while
// the push from below is in flight.
//
// bf16 storage (gs_sharded_mega_describe_bf16, gs_sharded_mega_multistep_bf16;
// the TPU kernel with a bfloat16 dtype): every shard's pairs are bfloat16.
// Tiles step as K2's bf16 form does (widened on load, float32 steps, one
// rounding to nearest even at the store), so the pushes, which follow the
// group barrier, move cells that are already rounded: 16-byte copies of 8
// bfloat16 cells, so every band's width is a multiple of 8 (c_loc and
// chalo are: parallel/halo.py:QUANTUM, COL_HALO), and the pitch too.

#include "gs_tile_sm90.cuh"

namespace {

namespace sm90 = gs::sm90;

constexpr int HALO = sm90::HALO;  // most steps per time block, the halo rows
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

// T: the state's element type (float, or sm90::bf16).
template <typename T>
struct ShardDesc {
  T* pair[2];                      // its (U, V) pairs
  unsigned long long* counters;    // its COUNTER_WORDS counters
  int row0, col0;                  // global (row, col) of interior (0, 0)
  int aligned;                     // its rows 16-byte aligned
  T* nbr_pair[N_DIRS][2];          // the neighbour in direction d, or null
  unsigned long long* nbr_counters[N_DIRS];
};
static_assert(sizeof(ShardDesc<float>) == sizeof(ShardDesc<sm90::bf16>),
              "one descriptor size for both storage types");

__device__ __forceinline__ bool first_thread() { return threadIdx.x == 0; }

// The arrivals a shard waits for: every direction (the entry gate), or on a
// row mesh those that fill its top halo rows (pushed down by the neighbour
// above) and its bottom halo rows (pushed up by the neighbour below).
constexpr unsigned ALL_DIRS = (1u << N_DIRS) - 1;
constexpr unsigned TOP_ROWS = 1u << 0;
constexpr unsigned BOTTOM_ROWS = 1u << 1;

// Wait until the counter of `slot` shows `count` pushes from every present
// neighbour whose direction is in `dirs`, then make what they pushed
// visible to the whole block.
template <typename T>
__device__ __forceinline__ void wait_arrivals(const ShardDesc<T>& me, int slot,
                                              unsigned long long count,
                                              unsigned dirs = ALL_DIRS) {
  if (first_thread()) {
    const volatile unsigned long long* a =
        me.counters + ARRIVALS + slot * N_DIRS;
    for (int d = 0; d < N_DIRS; ++d) {
      if (!((dirs >> d) & 1) || me.nbr_pair[opposite(d)][0] == nullptr) {
        continue;
      }
      while (a[d] < count) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The block's share of the pushes of `slot` into every present neighbour,
// in 16-byte copies: float4s, or 8 bfloat16 cells (pitch, chalo and c_loc
// are multiples of a copy's cells and the pairs 16-byte aligned:
// gs_sharded_mega_describe).
template <typename T>
__device__ __forceinline__ void push(const ShardDesc<T>& me, int slot,
                                     int r_loc, int c_loc, int chalo,
                                     size_t pitch, size_t plane, int rank,
                                     unsigned int size) {
  using V = typename sm90::Vec16<T>::type;
  constexpr int E = sm90::vec_cells<T>();
  const int first = rank * blockDim.x + threadIdx.x;
  const int stride = size * blockDim.x;
  const T* u = me.pair[0] + slot * plane;
  const T* v = me.pair[1] + slot * plane;
  for (int d = 0; d < N_DIRS; ++d) {
    if (me.nbr_pair[d][0] == nullptr) continue;
    T* nu = me.nbr_pair[d][0] + slot * plane;
    T* nv = me.nbr_pair[d][1] + slot * plane;
    const int dr = dir_row(d), dc = dir_col(d);
    // the band: HALO rows / chalo columns on the side of the push, else the
    // whole interior; into the receiver's opposite halo
    const int n_rows = dr ? HALO : r_loc, n_cols = dc ? chalo : c_loc;
    const int from_r = dr > 0 ? r_loc : HALO;
    const int to_r = dr > 0 ? 0 : dr < 0 ? HALO + r_loc : HALO;
    const int from_c = dc > 0 ? c_loc : chalo;
    const int to_c = dc > 0 ? 0 : dc < 0 ? chalo + c_loc : chalo;
    const int quads = n_cols / E;  // 16-byte copies a band row
    const int n = n_rows * quads;
    for (int i = first; i < n; i += stride) {
      const int r = i / quads, c = E * (i - r * quads);
      const size_t from = (from_r + r) * pitch + from_c + c;
      const size_t to = (to_r + r) * pitch + to_c + c;
      *reinterpret_cast<V*>(nu + to) =
          __ldcg(reinterpret_cast<const V*>(u + from));
      *reinterpret_cast<V*>(nv + to) =
          __ldcg(reinterpret_cast<const V*>(v + from));
    }
  }
}

// After the block's pushes of `slot` (the n-th time, n = 1, 2, ...): its
// arrival on the group's gather; the group's first block waits for all
// `size` of them and bumps each neighbour's counter of (slot, direction).
template <typename T>
__device__ __forceinline__ void arrive(const ShardDesc<T>& me, int slot,
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

// The read-site wait's gate (READ_SITE; time_block calls it before each
// window load): in time block t > 0, before the block loads its first tile
// whose window reaches the bottom halo rows, the pushes from below. Tile row
// r's window ends at (r + 1) * TR + HALO, so those are the tiles from
// `split` = (r_loc - HALO) / TR rows of tiles_x on; a block's tiles lie
// `stride` apart, so its first one there is the one in [split, split +
// stride). One wait a block and a time block, from values the kernel holds
// anyway (a second walk of time_block, or a flag, cost the naive
// instantiations, at the 64 registers they are bound to, a spill).
template <typename G, typename T>
struct BottomGate {
  const ShardDesc<T>& me;
  int t, r_loc, tiles_x;

  __device__ __forceinline__ void operator()(int i, int stride) const {
    const int split = (r_loc - HALO) / G::TR * tiles_x;
    if (t > 0 && i >= split && i - split < stride) {
      wait_arrivals(me, t & 1, (t + 1) / 2, BOTTOM_ROWS);
    }
  }
};

// G: the tile geometry (gs_tile_sm90.cuh: Main, 64^2 tiles and 512
// threads, two blocks an SM; Small, 32^2 and 256, four blocks an SM).
// READ_SITE: the shards form a row mesh (the read-site wait: BottomGate),
// else each time block's entry is gated on every direction. Two kernels,
// not a run-time flag: a flag cost the naive instantiations a spill.
template <typename G, int TAPS, bool NAIVE, typename T, bool READ_SITE>
__global__ void __launch_bounds__(G::NT, G::BLOCKS_AT_64_REGS)
sharded_mega_kernel(const ShardDesc<T>* shards, int n_shards, int rows,
                    int cols, int r_loc, int c_loc, int chalo, int n_blocks,
                    int steps, gs::Constants k) {
  extern __shared__ float4 window[];  // buffers [2] x species [2]
  float* const base = reinterpret_cast<float*>(window);
  // the block's shard g and its rank among the shard's `size` blocks
  const int per = gridDim.x / n_shards, extra = gridDim.x % n_shards;
  const int b = blockIdx.x, big = extra * (per + 1);
  const int g = b < big ? b / (per + 1) : extra + (b - big) / per;
  const int rank = b - (b < big ? g * (per + 1) : big + (g - extra) * per);
  const unsigned int size = per + (g < extra ? 1 : 0);
  const ShardDesc<T>& me = shards[g];

  const size_t pitch = static_cast<size_t>(c_loc) + 2 * chalo;
  const size_t plane = (static_cast<size_t>(r_loc) + 2 * HALO) * pitch;
  const gs::ShardLayout mem = {me.row0, me.col0, r_loc, c_loc,
                               HALO,    chalo,   pitch};
  T* const u = me.pair[0];
  T* const v = me.pair[1];
  const int tiles_x = (c_loc + G::TC - 1) / G::TC;
  const int n_tiles = tiles_x * ((r_loc + G::TR - 1) / G::TR);
  for (int t = 0; t < n_blocks; ++t) {
    const size_t src = (t & 1) ? plane : 0, dst = (t & 1) ? 0 : plane;
    if (!READ_SITE) {
      if (t > 0) wait_arrivals(me, t & 1, (t + 1) / 2);
      sm90::time_block<G, TAPS, NAIVE, true, true>(
          mem, u + src, v + src, u + dst, v + dst, rank, size, n_tiles,
          tiles_x, me.row0, me.col0, rows, cols, steps, k, me.aligned, base);
    } else {
      if (t > 0) wait_arrivals(me, t & 1, (t + 1) / 2, TOP_ROWS);
      sm90::time_block<G, TAPS, NAIVE, true, true>(
          mem, u + src, v + src, u + dst, v + dst, rank, size, n_tiles,
          tiles_x, me.row0, me.col0, rows, cols, steps, k, me.aligned, base,
          BottomGate<G, T>{me, t, r_loc, tiles_x});
    }
    gs::group_barrier(me.counters + BARRIER, t + 1, size);
    push(me, 1 - (t & 1), r_loc, c_loc, chalo, pitch, plane, rank, size);
    arrive(me, 1 - (t & 1), t + 1, size, rank == 0);
  }
  wait_arrivals(me, n_blocks & 1, (n_blocks + 1) / 2);
  if (n_blocks & 1) {  // slot 1 to slot 0, halos included, 16 B a copy
    using V = typename sm90::Vec16<T>::type;
    const size_t stride = static_cast<size_t>(size) * blockDim.x;
    for (size_t i = static_cast<size_t>(rank) * blockDim.x + threadIdx.x;
         i < plane / sm90::vec_cells<T>(); i += stride) {
      reinterpret_cast<V*>(u)[i] =
          __ldcg(reinterpret_cast<const V*>(u + plane) + i);
      reinterpret_cast<V*>(v)[i] =
          __ldcg(reinterpret_cast<const V*>(v + plane) + i);
    }
  }
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

// Both storage types' instantiations of G.
template <typename G>
cudaError_t fewest_blocks_any(int device, int* least) {
  cudaError_t err = fewest_blocks_all<G, float>(device, least);
  if (err == cudaSuccess) err = fewest_blocks_all<G, sm90::bf16>(device, least);
  return err;
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

// gs_sharded_mega_multistep and its bf16 twin (see there).
template <typename T>
int multistep(const void* shards, int n_shards, int rows, int cols,
              int r_loc, int c_loc, int chalo, int n_blocks, int steps,
              int naive, int device, const float* w, float du, float dv,
              float feed, float min_feed_kill, float dt, int grid_blocks,
              int tile, int read_site, void* stream) {
  if (n_shards < 1 || rows < 1 || cols < 1 || r_loc < HALO || c_loc < 1 ||
      chalo < 0 || chalo > HALO || n_blocks < 1 || steps < 1 ||
      steps > HALO || device < 0 || device >= gs::MAX_DEVICES ||
      (tile != sm90::Main::TR && tile != sm90::Small::TR)) {
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
  return static_cast<int>(
      sm90::dispatch_taps<Launch>(c.k, c, static_cast<T*>(nullptr)));
}

}  // namespace

extern "C" {

int gs_sharded_mega_max_steps() { return HALO; }

int gs_sharded_mega_counter_words() { return COUNTER_WORDS; }

int gs_sharded_mega_desc_bytes() { return sizeof(ShardDesc<float>); }

// The most blocks one cooperative launch of the kernel may have on
// `device` with `tile` x `tile` tiles (64 or 32), whatever its weights,
// boundary and storage type (negative: minus the CUDA error).
int gs_sharded_mega_max_blocks(int device, int tile) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  if (tile != sm90::Main::TR && tile != sm90::Small::TR) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 1 << 30;
  if (err == cudaSuccess) {
    err = tile == sm90::Main::TR ? fewest_blocks_any<sm90::Main>(device, &n)
                                 : fewest_blocks_any<sm90::Small>(device, &n);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Writes to `out` (host memory) the descriptors of the n_rows x n_cols
// shards, row-major, whose pairs are the sub-tensors of `u_pairs` and
// `v_pairs` (n_rows, n_cols, 2, HALO + r_loc + HALO, chalo + c_loc + chalo)
// and whose counters are COUNTER_WORDS each of `counters`, all on one card.
// Returns cudaErrorInvalidValue for a geometry the kernel does not take
// (the pushes move float4s: c_loc and chalo multiples of 4, the pairs
// 16-byte aligned).
int gs_sharded_mega_describe(void* out, float* u_pairs, float* v_pairs,
                             void* counters, int n_rows, int n_cols,
                             int r_loc, int c_loc, int chalo) {
  return describe(out, u_pairs, v_pairs, counters, n_rows, n_cols, r_loc,
                  c_loc, chalo);
}

// gs_sharded_mega_describe for bfloat16 pairs: c_loc and chalo multiples of
// 8 (a push moves 8 bfloat16 cells a copy).
int gs_sharded_mega_describe_bf16(void* out, void* u_pairs, void* v_pairs,
                                  void* counters, int n_rows, int n_cols,
                                  int r_loc, int c_loc, int chalo) {
  return describe(out, static_cast<sm90::bf16*>(u_pairs),
                  static_cast<sm90::bf16*>(v_pairs), counters, n_rows,
                  n_cols, r_loc, c_loc, chalo);
}

// Enqueues one cooperative launch of `n_blocks` time blocks of `steps`
// steps on `stream`, over the `n_shards` shards described in device memory
// at `shards` (gs_sharded_mega_describe, copied to the card), of a
// rows x cols domain, in `tile` x `tile` tiles (64 or 32). Each shard's
// counters must be zero. `grid_blocks` <= 0 takes the co-resident maximum
// (capped at the tile count); a larger grid than the card can hold is
// refused with cudaErrorCooperativeLaunchTooLarge, and a grid smaller than
// n_shards with cudaErrorInvalidValue. Returns the CUDA error (0 when the
// launch was accepted).
int gs_sharded_mega_multistep(const void* shards, int n_shards, int rows,
                              int cols, int r_loc, int c_loc, int chalo,
                              int n_blocks, int steps, int naive, int device,
                              float w0, float w1, float w2, float w3,
                              float w4, float w5, float w6, float w7,
                              float w8, float du, float dv, float feed,
                              float min_feed_kill, float dt, int grid_blocks,
                              int tile, int read_site, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep<float>(shards, n_shards, rows, cols, r_loc, c_loc, chalo,
                          n_blocks, steps, naive, device, w, du, dv, feed,
                          min_feed_kill, dt, grid_blocks, tile, read_site,
                          stream);
}

// gs_sharded_mega_multistep over shards with bfloat16 pairs (described by
// gs_sharded_mega_describe_bf16): each window widened to float32 on load,
// each cell rounded to bfloat16 (to nearest even) on store, before the
// pushes.
int gs_sharded_mega_multistep_bf16(
    const void* shards, int n_shards, int rows, int cols, int r_loc,
    int c_loc, int chalo, int n_blocks, int steps, int naive, int device,
    float w0, float w1, float w2, float w3, float w4, float w5, float w6,
    float w7, float w8, float du, float dv, float feed, float min_feed_kill,
    float dt, int grid_blocks, int tile, int read_site, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep<sm90::bf16>(shards, n_shards, rows, cols, r_loc, c_loc,
                               chalo, n_blocks, steps, naive, device, w, du,
                               dv, feed, min_feed_kill, dt, grid_blocks,
                               tile, read_site, stream);
}

}  // extern "C"
