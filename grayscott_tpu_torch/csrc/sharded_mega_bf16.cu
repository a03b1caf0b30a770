// K7 on bfloat16 states: the bf16 entries of the sharded megakernel, the
// kernels of sharded_mega.cu (sharded_mega_compiled.cuh) instantiated on
// bfloat16 pairs in their own translation unit, so that nvcc builds them
// beside the float32 ones. See sharded_mega.cu for the design.

#include "sharded_mega_compiled.cuh"

extern "C" {

// gs_sharded_mega_max_blocks over the bfloat16 instantiations alone (the
// float32 entry takes the fewer of both; negative: minus the CUDA error).
int gs_sharded_mega_max_blocks_bf16(int device, int tile) {
  int n = 1 << 30;
  const cudaError_t err = fewest_blocks_on<sm90::bf16>(device, tile, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
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
