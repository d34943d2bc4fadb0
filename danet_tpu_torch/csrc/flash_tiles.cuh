// Shared by the flash-attention kernels (flash_attn.cu, flash_attn_bwd.cu):
// tile sizes, the mask value, tile loads into shared memory, and the
// 64 x 64 tile product that each of them computes S = Q K^T with.
//
// Thread layout of every 64-row tile product: 256 threads, thread
// (tx, ty) = (tid % 16, tid / 16) owns rows ty + 16 i (i < 4) and columns
// tx + 16 j.  The 16 threads of one row are 16 consecutive lanes of one
// warp, so a row reduction is four xor-shuffles.
#pragma once

#include "common.cuh"

namespace flash {

constexpr int TILE = 64;      // query rows and key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int RI = 4;         // rows per thread
constexpr int LD_P = TILE + 1;  // row stride of a [64, 64] score tile
// -0.7 * float32 max, computed in double and rounded once, as the Python
// float DEFAULT_MASK_VALUE becomes a float32 when it meets float32 logits
constexpr float MASK_VALUE = static_cast<float>(-0.7 * 3.4028234663852886e38);

// The row stride of a [64, D] tile in shared memory: D + 1 floats, so that
// 16 threads reading one column of 16 different rows hit 16 banks.
template <int D>
__host__ __device__ constexpr int ld() { return D + 1; }

// Input addressing: element (b, t, h, d) of q, k or v sits at
// b * sb + t * st + h * sh + d (the [B, T, 3, H, D] qkv projection's
// views, or contiguous [B, T, H, D]).
struct Strides {
  long long b, t, h;
};

// Rounding to the storage type and back (identity for float32): where the
// stock kernel casts p or ds to the input dtype before a product.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Load rows t0 .. t0 + 63 of head h of batch b into tile[64][D + 1] (f32).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          Strides s, int b, int t0, int h) {
  const T* p = base + b * s.b + h * s.h;
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D, d = e % D;
    tile[r * ld<D>() + d] = to_f32(p[(t0 + r) * s.t + d]);
  }
}

// Load rows t0 .. t0 + 63 of a contiguous [B, T, H, D] tensor.
template <typename T, int D>
__device__ __forceinline__ void load_tile_dense(float* tile, const T* base,
                                                int b, int t0, int h,
                                                int seq, int heads) {
  const Strides s{static_cast<long long>(seq) * heads * D,
                  static_cast<long long>(heads) * D, D};
  load_tile<T, D>(tile, base, s, b, t0, h);
}

// acc[i][j] += sum_d a[r_i][d] * c[c_j][d] over two [64, D] tiles: the
// thread's 4 x 4 block of a 64 x 64 product with the second operand
// transposed (S = Q K^T, dP = dO V^T).
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[RI][RI],
                                         const float* a, const float* c,
                                         int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RI], cv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = a[(ty + 16 * i) * ld<D>() + d];
#pragma unroll
    for (int j = 0; j < RI; ++j) cv[j] = c[(tx + 16 * j) * ld<D>() + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
  }
}

// The 16 lanes that share a row (xor-shuffles within each half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel; -> 0, a
// cudaError_t, or DANET_SMEM_TOO_LARGE.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  int optin = 0;
  const int status = smem_optin(&optin);
  if (status != 0) return status;
  if (bytes > static_cast<size_t>(optin)) return DANET_SMEM_TOO_LARGE;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// The launch arguments every entry point checks the same way.
inline bool bad_shape(int batch, int heads, int seq) {
  return batch <= 0 || heads <= 0 || seq <= 0 || seq % TILE != 0 ||
         batch > 65535 || heads > 65535;
}

}  // namespace flash
