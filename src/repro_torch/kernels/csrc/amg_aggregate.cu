// Greedy aggregation of AMG set-up, as host code in the port's library.
//
// Replaces: src/repro_torch/precond/amg.py::aggregate (pure Python) for a
// hierarchy on the card; the JAX package's src/repro/precond/amg.py::aggregate
// has the same three passes.  No device code: the passes are sequential by
// definition (each decision reads the ones before it), so they run on the
// host, here compiled rather than interpreted.
//
// Over a CSR pattern (int64 row pointers and columns) and a strength mask
// (one byte an entry, nonzero where strong), in row order:
//   1. seed: a row not yet aggregated whose strong neighbours are all free
//      opens a new aggregate of itself and those neighbours;
//   2. attach: a row still free joins the aggregate of its first strong
//      neighbour (in CSR order) that has one, rows attached earlier in this
//      pass included;
//   3. singletons: every row still free opens an aggregate of its own.
// agg[i] is the aggregate of row i, numbered in the order they open; the
// same array as the Python passes give, bit for bit.  The wrapper checks the
// sizes and the columns' range before the call.
#include <cstdint>

extern "C" int repro_amg_aggregate(const int64_t* indptr, const int64_t* indices,
                                   const uint8_t* strong, int64_t n,
                                   int64_t* agg, int64_t* n_agg_out) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  int64_t n_agg = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool all_free = true;
    for (int64_t t = indptr[i]; t < indptr[i + 1]; ++t) {
      if (strong[t] && agg[indices[t]] != -1) {
        all_free = false;
        break;
      }
    }
    if (!all_free) continue;
    agg[i] = n_agg;
    for (int64_t t = indptr[i]; t < indptr[i + 1]; ++t) {
      if (strong[t]) agg[indices[t]] = n_agg;
    }
    ++n_agg;
  }
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int64_t t = indptr[i]; t < indptr[i + 1]; ++t) {
      if (strong[t] && agg[indices[t]] != -1) {
        agg[i] = agg[indices[t]];
        break;
      }
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] == -1) agg[i] = n_agg++;
  }
  *n_agg_out = n_agg;
  return 0;
}
