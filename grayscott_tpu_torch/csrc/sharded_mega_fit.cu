// K7's read-site entry on tiles fitted to the shard: the READ_SITE kernels
// of sharded_mega_compiled.cuh on Fit68 (64 columns, 68 rows: 1080x1920 on
// 4x1 and 2x1, whose 272- and 544-row shards take 4 and 8 tile rows of 68
// where 64-row tiles take 5 and 9, 2 rounds of tiles where they take 3;
// ops/sharded_mega.py:fitted_height, choose_tile), on float32 and bfloat16
// pairs, for the default stencils' tap set and any other (TAPS_ANY), in a
// unit of their own so that nvcc builds them beside sharded_mega.cu and
// sharded_mega_bf16.cu. The descriptors are gs_sharded_mega_describe's
// (and its bf16 twin's). The split that chose this form is
// splits/sharded_mega_ablation.cu's; see sharded_mega.cu for the design.

#include "sharded_mega_compiled.cuh"

extern "C" {

// The most blocks of one cooperative launch of the fitted entries on
// `device`, float32 and bf16, both tap sets and boundaries (negative: minus
// the CUDA error).
int gs_sharded_mega_fit_max_blocks(int device) {
  if (device < 0 || device >= gs::MAX_DEVICES) {
    return -static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  int n = 1 << 30;
  if (err == cudaSuccess) err = fewest_fitted<Fit68, float>(device, &n);
  if (err == cudaSuccess) err = fewest_fitted<Fit68, sm90::bf16>(device, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// gs_sharded_mega_multistep on the fitted tiles (`tile` 68, `read_site` 1:
// a row mesh; else cudaErrorInvalidValue).
int gs_sharded_mega_fit_multistep(
    const void* shards, int n_shards, int rows, int cols, int r_loc,
    int c_loc, int chalo, int n_blocks, int steps, int naive, int device,
    float w0, float w1, float w2, float w3, float w4, float w5, float w6,
    float w7, float w8, float du, float dv, float feed, float min_feed_kill,
    float dt, int grid_blocks, int tile, int read_site, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep<float, true>(shards, n_shards, rows, cols, r_loc, c_loc,
                                chalo, n_blocks, steps, naive, device, w, du,
                                dv, feed, min_feed_kill, dt, grid_blocks,
                                tile, read_site, stream);
}

// gs_sharded_mega_fit_multistep over bfloat16 pairs
// (gs_sharded_mega_describe_bf16).
int gs_sharded_mega_fit_multistep_bf16(
    const void* shards, int n_shards, int rows, int cols, int r_loc,
    int c_loc, int chalo, int n_blocks, int steps, int naive, int device,
    float w0, float w1, float w2, float w3, float w4, float w5, float w6,
    float w7, float w8, float du, float dv, float feed, float min_feed_kill,
    float dt, int grid_blocks, int tile, int read_site, void* stream) {
  const float w[9] = {w0, w1, w2, w3, w4, w5, w6, w7, w8};
  return multistep<sm90::bf16, true>(shards, n_shards, rows, cols, r_loc,
                                     c_loc, chalo, n_blocks, steps, naive,
                                     device, w, du, dv, feed, min_feed_kill,
                                     dt, grid_blocks, tile, read_site, stream);
}

}  // extern "C"
