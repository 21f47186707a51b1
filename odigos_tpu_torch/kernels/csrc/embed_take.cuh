// How K2 (span_embed.cu) and K18 (span_embed_bwd.cu) read an id: as Flax's
// nn.Embed gathers a table, jnp.take in fill mode (flax 0.12.3). The plain
// versions' rule is kernels/embed.py take_rows.

#pragma once

namespace {

// The row an id takes in a table of n rows: an id in [0, n) its own, one in
// [-n, 0) row id + n, any other none (-1: the slot's embedding is NaN and
// its gradient dropped); a one-row table is broadcast to every id
__device__ __forceinline__ int take_row(int i, int n) {
  if (n == 1) return 0;
  const int r = i < 0 ? i + n : i;
  return r >= 0 && r < n ? r : -1;
}

}  // namespace
