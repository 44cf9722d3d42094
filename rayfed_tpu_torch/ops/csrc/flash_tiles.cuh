// The tile classes and the mask of the flash-attention kernels, shared by
// all of them so their boundary conditions cannot drift: the TPU kernels'
// `_causal_dispatch` (rayfed_tpu/ops/flash_attention.py) for a (q tile,
// k/v tile) pair, and the per-pair visibility test of a masked tile.

#pragma once

namespace flash {

// Whether a (q tile, k/v tile) pair is active (some pair of positions is
// visible) and whether it straddles the diagonal or the window edge (some
// pair is not).  Positions are global: q_first/q_last and kv_first/kv_last
// already include the offsets.
struct TileClass {
  bool active;
  bool straddles;
};

__device__ __forceinline__ TileClass classify(int q_first, int q_last, int kv_first, int kv_last,
                                              int causal, int window) {
  TileClass c{true, false};
  if (causal) {
    c.active = kv_first <= q_last;
    c.straddles = kv_last > q_first;
    if (window > 0) {
      c.active = c.active && kv_last > q_first - window;
      c.straddles = c.straddles || q_last - kv_first >= window;
    }
  }
  return c;
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int causal, int window) {
  if (!causal) return true;
  return q_pos >= k_pos && (window <= 0 || q_pos - k_pos < window);
}

}  // namespace flash
