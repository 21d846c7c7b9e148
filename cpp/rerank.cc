// Fused gather + dequant + dot for the host exact re-rank stage of the
// codes-only (10M / config-5) serving regime.
//
// Under MRAG_VECTOR_RESIDENCY=host the device returns k*over_fetch fused
// candidates ranked on residual-PQ codes; the truth vectors live in host
// RAM as int8 rows + per-row scales, and SearchEngine._host_rerank
// (mobius_rag_tpu/query/engine.py) recomputes the exact cosine for each
// candidate. The numpy expression
//     rows = hv[idx].astype(f32) * hs[idx][..., None]
//     cos  = einsum("bwd,bd->bw", rows, qv)
// materialises a [B, W, D] float32 temporary (three passes over ~2-5 MB
// per batch) on the serving host's CPU. This kernel streams each int8 row once, fusing the
// dequant scale into the accumulated dot product, no temporaries.
//
// The reference has no analogue: its second stage is pgvector's own
// `<=>` operator inside Postgres (reference vector_store.py:274-287);
// this shim is the native replacement serving the same exact-distance
// truth from host memory.
//
// C API (ctypes-friendly):
//   mrag_gather_cos(hv, hs, n_rows, d, idx, b, w, qv, out) -> 0
//     hv  : [n_rows, d] int8, row-major (the host vector matrix)
//     hs  : [n_rows] float32 per-row dequant scales
//     idx : [b, w] int32 candidate rows (clamped into range here, like
//           the numpy np.clip — dead slots carry garbage indices and are
//           masked out by the caller via the `alive` rerank mask)
//     qv  : [b, d] float32 L2-normalised query vectors
//     out : [b, w] float32; out[i,j] = hs[r] * dot(hv[r], qv[i]), r=idx[i,j]
//
// Build: make -C cpp   (part of libmrag_native.so)
#include <cstdint>

extern "C" int mrag_gather_cos(const int8_t *hv, const float *hs,
                               long long n_rows, int d, const int32_t *idx,
                               int b, int w, const float *qv, float *out) {
  if (n_rows <= 0 || d <= 0)
    return -1;
  for (int i = 0; i < b; ++i) {
    const float *q = qv + (long long)i * d;
    for (int j = 0; j < w; ++j) {
      long long r = idx[(long long)i * w + j];
      if (r < 0)
        r = 0;
      if (r >= n_rows)
        r = n_rows - 1;
      const int8_t *row = hv + r * d;
      // Eight accumulators: breaks the serial dependence chain for the
      // auto-vectorizer AND keeps f32 rounding error ~8x below a single
      // sequential sum (ranking-grade accuracy vs numpy's pairwise
      // einsum — pinned by the parity test).
      float acc[8] = {0.f};
      int k = 0;
      for (; k + 7 < d; k += 8)
        for (int u = 0; u < 8; ++u)
          acc[u] += (float)row[k + u] * q[k + u];
      for (; k < d; ++k)
        acc[0] += (float)row[k] * q[k];
      float s01 = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      float s23 = (acc[4] + acc[5]) + (acc[6] + acc[7]);
      out[(long long)i * w + j] = hs[r] * (s01 + s23);
    }
  }
  return 0;
}
