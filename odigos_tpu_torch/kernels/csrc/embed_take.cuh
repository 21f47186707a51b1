// How K2 (span_embed.cu) and K18 (span_embed_bwd.cu) read an id: as Flax's
// nn.Embed gathers a table, jnp.take in fill mode (flax 0.12.3). The plain
// versions' rule is kernels/embed.py take_rows. And how K11 (recon_ce.cu)
// and K20 (recon_ce_bwd.cu) read a label: as the reference's _ce takes the
// label's log-probability, jnp.take_along_axis in fill mode; the plain
// versions' rule is kernels/recon.py take_labels.

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

// The row a label takes in a head of v rows: a label in [0, v) its own, one
// in [-v, 0) row label + v, any other none (-1: the position's error is
// NaN and that head's gradient there is zero); no broadcast
__device__ __forceinline__ int take_label(int lab, int v) {
  const int r = lab < 0 ? lab + v : lab;
  return r >= 0 && r < v ? r : -1;
}

// The row of a head's slice [lo, lo + v) that a label takes, the label read
// against the whole head of vf rows (take_label): -1 where it takes no row
// of the whole head or one of another shard's slice. At lo 0 and vf v it
// is take_label(lab, v): the unsliced heads' rule
__device__ __forceinline__ int take_slice_label(int lab, int vf, int lo,
                                                int v) {
  const int r = take_label(lab, vf);
  return r >= lo && r < lo + v ? r - lo : -1;
}

}  // namespace
