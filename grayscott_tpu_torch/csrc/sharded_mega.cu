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
//     blocks an SM) and 32x32 in 48^2 (256 threads), and for the read-site
//     wait 68x64 tiles in 84x80 windows (sharded_mega_fit.cu: where 64-row
//     tiles leave a shard's last tile row short); the wrapper picks one
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
// takes 2); the 32^2 geometry, with more blocks an SM, can take fewer, and
// on a row mesh the fitted 68x64 tiles do (4x1 at 1080x1920: 120 tiles a
// shard, 2 rounds, where 64^2 take 150 in 3). On a row mesh the read-site
// wait lets a shard's interior tile rows step while the push from below is
// in flight. The split of the read-site entry (splits/sharded_mega_ablation.cu)
// found the exchange 5 % of a launch and the 4x4 register blocks slower
// than the strips at 64 registers (PERF.md §6).
//
// bf16 storage (gs_sharded_mega_describe_bf16, gs_sharded_mega_multistep_bf16;
// the TPU kernel with a bfloat16 dtype): every shard's pairs are bfloat16.
// Tiles step as K2's bf16 form does (widened on load, float32 steps, one
// rounding to nearest even at the store), so the pushes, which follow the
// group barrier, move cells that are already rounded: 16-byte copies of 8
// bfloat16 cells, so every band's width is a multiple of 8 (c_loc and
// chalo are: parallel/halo.py:QUANTUM, COL_HALO), and the pitch too. The
// bf16 entries live in sharded_mega_bf16.cu, the kernel and its launch in
// sharded_mega_compiled.cuh: two units, so that nvcc builds the float32
// and bfloat16 instantiations side by side.

#include "sharded_mega_compiled.cuh"


extern "C" {

// sharded_mega_bf16.cu's instantiations (the same query on bfloat16).
int gs_sharded_mega_max_blocks_bf16(int device, int tile);

int gs_sharded_mega_max_steps() { return HALO; }

int gs_sharded_mega_counter_words() { return COUNTER_WORDS; }

int gs_sharded_mega_desc_bytes() { return sizeof(ShardDesc<float>); }

// The most blocks one cooperative launch of the kernel may have on
// `device` with `tile` x `tile` tiles (64 or 32), whatever its weights,
// boundary and storage type (negative: minus the CUDA error).
int gs_sharded_mega_max_blocks(int device, int tile) {
  int n = 1 << 30;
  const cudaError_t err = fewest_blocks_on<float>(device, tile, &n);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int bf16 = gs_sharded_mega_max_blocks_bf16(device, tile);
  return bf16 < n ? bf16 : n;
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

}  // extern "C"
