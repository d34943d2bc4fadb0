// The product that every step of the GRU kernels (gru_scan.cu,
// gru_scan_bwd.cu) makes: a [B, G] row that other blocks wrote during this
// launch, times the block's resident [G, C] slice of a weight matrix.
//
//   out[b][c] = sum_{g < G} row[b * ld + g] * w_s[g * C + c]
//
// The row lives in device memory (L2) and is read with ld.global.cg, so
// that no stale L1 line is used.  It is staged through shared memory in
// chunks of up to PASS rows x KC columns; only live rows are staged and
// multiplied (at B=1, serving, one row of 32).  Each thread issues its
// share of a chunk as batches of LOADS independent loads, all in flight
// before the first store, rather than as a chain of dependent loads.
// Each thread then holds a BT x CG register tile of the product over a
// KS-strided share of the chunk's columns, so every shared-memory read
// feeds 4 or 8 FMAs.  The KS partial sums meet in part_s and are added in
// out.
//
// Shared memory the caller provides: w_s [G][C] (16-byte aligned),
// d_s [PASS][KCP], part_s [KS][B][C] (KS * C = 256, so 256 * B floats for
// every C), out [B][C].  Every thread of the block must call it: it
// synchronises the block, also on return.
#pragma once

#include "common.cuh"

namespace rowc {

constexpr int THREADS = 256;
constexpr int CG = 4;           // output columns per thread tile (a float4)
constexpr int BT = 8;           // batch rows per thread tile
constexpr int BG = 4;           // batch-row groups per pass
constexpr int PASS = BG * BT;   // batch rows per pass
constexpr int KC = 256;         // row columns per staged chunk
constexpr int KCP = KC + 1;     // padded stride: conflict-free column reads
constexpr int LOADS = 16;       // independent loads in flight per thread

template <int C>
struct Split {
  static_assert(C % CG == 0, "C must be a multiple of 4");
  static constexpr int KS = THREADS / ((C / CG) * BG);
  static_assert(KS * (C / CG) * BG == THREADS, "C must divide 64");
};

__host__ __device__ inline size_t part_floats(int batch) {
  return static_cast<size_t>(THREADS) * CG / BG * batch;
}

// acc[i][*] += d_s[row i of the tile][k] * w_s[k][cg*CG ..] over this
// thread's columns k of a chunk; FULL: all BT rows of the tile are live,
// so the row loop unrolls with no test (with a runtime bound inside it the
// GRU kernels took 30 % longer at B=32)
template <int C, int KS, bool FULL>
__device__ __forceinline__ void tile_fma(float (&acc)[BT][CG],
                                         const float* w_s, const float* d_s,
                                         int k0, int kn, int ks, int cg,
                                         int bg, int mine) {
  for (int k = ks; k < kn; k += KS) {
    const float4 w =
        *reinterpret_cast<const float4*>(w_s + (k0 + k) * C + cg * CG);
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      if (FULL || i < mine) {
        const float d = d_s[(bg * BT + i) * KCP + k];
        acc[i][0] = fmaf(d, w.x, acc[i][0]);
        acc[i][1] = fmaf(d, w.y, acc[i][1]);
        acc[i][2] = fmaf(d, w.z, acc[i][2]);
        acc[i][3] = fmaf(d, w.w, acc[i][3]);
      }
    }
  }
}

template <int C, typename T>
__device__ void contract_row(const T* row, int ld, int batch, int G,
                             const float* w_s, float* d_s, float* part_s,
                             float* out) {
  constexpr int KS = Split<C>::KS;
  const int tid = threadIdx.x;
  const int cg = tid % (C / CG);
  const int bg = (tid / (C / CG)) % BG;
  const int ks = tid / ((C / CG) * BG);

  for (int p0 = 0; p0 < batch; p0 += PASS) {
    const int rows = min(PASS, batch - p0);
    const int mine = min(BT, rows - bg * BT);  // live rows of this tile
    float acc[BT][CG];
#pragma unroll
    for (int i = 0; i < BT; ++i)
#pragma unroll
      for (int j = 0; j < CG; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < G; k0 += KC) {
      const int kn = min(KC, G - k0);
      const int n = rows * kn;
      __syncthreads();  // the previous chunk is no longer read
      for (int e0 = tid; e0 < n; e0 += THREADS * LOADS) {
        float v[LOADS];
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const int e = e0 + j * THREADS;
          const int r = e / kn, k = e % kn;
          v[j] = e < n
                     ? load_cg(row + static_cast<size_t>(p0 + r) * ld + k0 + k)
                     : 0.f;
        }
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const int e = e0 + j * THREADS;
          if (e < n) d_s[(e / kn) * KCP + e % kn] = v[j];
        }
      }
      __syncthreads();
      if (mine == BT)
        tile_fma<C, KS, true>(acc, w_s, d_s, k0, kn, ks, cg, bg, mine);
      else if (mine > 0)
        tile_fma<C, KS, false>(acc, w_s, d_s, k0, kn, ks, cg, bg, mine);
    }
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const int b = p0 + bg * BT + i;
      if (i < mine)
#pragma unroll
        for (int j = 0; j < CG; ++j)
          part_s[(ks * batch + b) * C + cg * CG + j] = acc[i][j];
    }
  }
  __syncthreads();
  for (int e = tid; e < batch * C; e += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < KS; ++p) s += part_s[p * batch * C + e];
    out[e] = s;
  }
  __syncthreads();
}

}  // namespace rowc
