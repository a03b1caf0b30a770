// K1's pinned entries (windowed_pins.cu) on the geometries users pin most,
// their sizes compiled in: 64x64 tiles at a halo of 16 (K = 9..16 on the
// default tiles) and 32x64 tiles at a halo of 16 (the sharded windowed
// engine's row tile of 32 at K = 16), the second form of
// windowed_pins.cuh on FixedPin, the default stencils' tap set, zero and
// naive, float32 and bf16 storage. With the tile's sizes constants, the
// window's row pitch folds into the shared loads' offsets; the split
// measured 0.89-0.92x the run-time sizes on the strips (PERF.md §6). The
// folded entry's one launch (windowed_folded.cuh) on 64x64 tiles at a halo
// of 8 (Main's sizes) and 16 lives here too. A unit of its own, so that the
// library's units build side by side.

#include "windowed_folded.cuh"

namespace gs {
namespace pins {

namespace {

using Fixed64 = sm90::FixedPin<64, 64, 16>;
using Fixed32 = sm90::FixedPin<32, 64, 16>;
constexpr int TAPS = sm90::TAPS_RING;

}  // namespace

template <typename T>
cudaError_t launch_fixed(const Call<T, gs::Constants>& c) {
  if (!fixed_geometry(c.g) || sm90::tap_mask(c.k) != TAPS) {
    return cudaErrorInvalidValue;
  }
  if (c.g.tr == 64) {
    return c.naive ? launch_form<TAPS, sm90::MODE_NAIVE, T>(c, Fixed64{})
                   : launch_form<TAPS, sm90::MODE_ZERO, T>(c, Fixed64{});
  }
  return c.naive ? launch_form<TAPS, sm90::MODE_NAIVE, T>(c, Fixed32{})
                 : launch_form<TAPS, sm90::MODE_ZERO, T>(c, Fixed32{});
}

template <typename T>
cudaError_t launch_shard_fixed(const ShardCall<T>& c) {
  if (!fixed_geometry(c.g) || sm90::tap_mask(c.k) != TAPS) {
    return cudaErrorInvalidValue;
  }
  if (c.g.tr == 64) {
    return c.naive
               ? launch_shard_form<TAPS, sm90::MODE_NAIVE, T>(c, Fixed64{})
               : launch_shard_form<TAPS, sm90::MODE_ZERO, T>(c, Fixed64{});
  }
  return c.naive ? launch_shard_form<TAPS, sm90::MODE_NAIVE, T>(c, Fixed32{})
                 : launch_shard_form<TAPS, sm90::MODE_ZERO, T>(c, Fixed32{});
}

cudaError_t fixed_blocks(const PinGeometry& g, int shard, int* per_sm) {
  if (!fixed_geometry(g)) return cudaErrorInvalidValue;
  const size_t bytes = sm90::pin_bytes(g);
  constexpr int MODE = sm90::MODE_NAIVE;
  if (g.tr == 64) {
    return shard ? form_blocks(shard_form_kernel<TAPS, MODE, float, Fixed64>,
                               bytes, per_sm)
                 : form_blocks(pinned_form_kernel<TAPS, MODE, float, Fixed64>,
                               bytes, per_sm);
  }
  return shard ? form_blocks(shard_form_kernel<TAPS, MODE, float, Fixed32>,
                             bytes, per_sm)
               : form_blocks(pinned_form_kernel<TAPS, MODE, float, Fixed32>,
                             bytes, per_sm);
}

template cudaError_t launch_fixed<float>(const Call<float, gs::Constants>&);
template cudaError_t launch_fixed<sm90::bf16>(
    const Call<sm90::bf16, gs::Constants>&);
template cudaError_t launch_shard_fixed<float>(const ShardCall<float>&);
template cudaError_t launch_shard_fixed<sm90::bf16>(
    const ShardCall<sm90::bf16>&);

}  // namespace pins

namespace folded {

cudaError_t launch_fixed(const FoldedCall& c) {
  using Main = sm90::FixedShape<sm90::Main>;
  using Fixed64 = sm90::FixedPin<64, 64, 16>;
  constexpr int TAPS = sm90::TAPS_RING;
  constexpr int NAIVE = sm90::MODE_NAIVE, ZERO = sm90::MODE_ZERO;
  if (!fixed_geometry(c.g) || sm90::tap_mask(c.k) != TAPS) {
    return cudaErrorInvalidValue;
  }
  if (c.g.halo == sm90::HALO) {
    return c.naive ? launch_form<TAPS, NAIVE, FORM, ONE_LAUNCH>(c, Main{})
                   : launch_form<TAPS, ZERO, FORM, ONE_LAUNCH>(c, Main{});
  }
  return c.naive ? launch_form<TAPS, NAIVE, FORM, ONE_LAUNCH>(c, Fixed64{})
                 : launch_form<TAPS, ZERO, FORM, ONE_LAUNCH>(c, Fixed64{});
}

}  // namespace folded
}  // namespace gs
