// Shared by the flash-attention kernels (flash_attn.cu, flash_attn_bwd.cu):
// tile sizes, the mask value, the staging of tiles into shared memory and
// the 64 x 64 tile products.
//
// Thread layout of every 64-row tile product: 256 threads, thread
// (tx, ty) = (tid % 16, tid / 16) owns rows ty + 16 i (i < 4) and columns
// tx + 16 j (a product over D: columns DJ tx .. DJ tx + DJ - 1, DJ =
// D / 16).  The 16 threads of one row are 16 consecutive lanes of one
// warp, so a row reduction is four xor-shuffles.
//
// Every kernel (5f, 5dkv, 5dq) stages its tiles the same way: rows copied
// raw, in the storage type T, by 16-byte cp.async into rows padded by 16
// bytes (stage_tile, ldr), and read 16 bytes at a time (load_row): the
// padding puts the 16-byte reads of 8 different rows (a quarter warp) in
// distinct banks.
#pragma once

#include "common.cuh"

namespace flash {

constexpr int TILE = 64;      // query rows and key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int RI = 4;         // rows per thread
constexpr int LDP = TILE + 4;  // row stride of a [64, 64] score tile
// -0.7 * float32 max, computed in double and rounded once, as the Python
// float DEFAULT_MASK_VALUE becomes a float32 when it meets float32 logits
constexpr float MASK_VALUE = static_cast<float>(-0.7 * 3.4028234663852886e38);

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

// Row stride (elements) of a staged [64, D] tile of T: 16 bytes of padding.
template <typename T, int D>
__host__ __device__ constexpr int ldr() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// N consecutive values at p (16-byte aligned for N * sizeof(T) >= 16,
// else aligned to N * sizeof(T)) as float32
template <int N>
__device__ __forceinline__ void load_row(float (&out)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + e);
      out[e] = v.x;
      out[e + 1] = v.y;
      out[e + 2] = v.z;
      out[e + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

// two bf16 in one 32-bit word (element 0 in the low half) -> float32
__device__ __forceinline__ void bf16x2(unsigned w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_row(float (&out)[N],
                                         const __nv_bfloat16* p) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + e);
      bf16x2(v.x, out + e);
      bf16x2(v.y, out + e + 2);
      bf16x2(v.z, out + e + 4);
      bf16x2(v.w, out + e + 6);
    }
  } else if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    bf16x2(v.x, out);
    bf16x2(v.y, out + 2);
  } else if constexpr (N == 2) {
    bf16x2(*reinterpret_cast<const unsigned*>(p), out);
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}

// Issue the 16-byte copies of rows t0 .. t0 + 63 of head h of batch b into
// tile[64][ldr] (raw T), by a block of NT threads.
template <typename T, int D, int NT = THREADS>
__device__ __forceinline__ void stage_tile(T* tile, const T* base, Strides s,
                                           int b, int t0, int h) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int CPR = D / VEC;  // 16-byte copies per row, a power of 2
  const T* p = base + b * s.b + h * s.h;
  for (int c = threadIdx.x; c < TILE * CPR; c += NT) {
    const int r = c / CPR, k = c % CPR * VEC;
    cp_async16(tile + r * ldr<T, D>() + k, p + (t0 + r) * s.t + k);
  }
}

// the segment ids of rows t0 .. t0 + 63 (zeros without masking)
__device__ __forceinline__ void stage_seg(int* dst, const int* seg, int b,
                                          int seq, int t0) {
  const int tid = threadIdx.x;
  if (seg == nullptr) {
    if (tid < TILE) dst[tid] = 0;
  } else if (tid < TILE / 4) {
    cp_async16(dst + 4 * tid,
               seg + static_cast<size_t>(b) * seq + t0 + 4 * tid);
  }
}

// acc[i][j] += sum_d a[ty + 64 / R i][d] c[tx + 16 j][d] over two staged
// [64][ldr] tiles of T, d in increasing order, 16 bytes per shared read:
// S = Q K^T, dP = dO V^T.  R rows per thread (a block of 16 x 64 / R
// threads, ty < 64 / R).
template <typename T, int D, int R = RI>
__device__ __forceinline__ void tile_abt16(float (&acc)[R][RI], const T* a,
                                           const T* c, int tx, int ty) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int L = ldr<T, D>();
#pragma unroll 2
  for (int d = 0; d < D; d += VEC) {
    float cv[RI][VEC];  // the c rows, then one a row at a time
#pragma unroll
    for (int j = 0; j < RI; ++j) load_row<VEC>(cv[j], c + (tx + 16 * j) * L + d);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float av[VEC];
      load_row<VEC>(av, a + (ty + TILE / R * i) * L + d);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int j = 0; j < RI; ++j)
          acc[i][j] = fmaf(av[e], cv[j][e], acc[i][j]);
    }
  }
}

// acc[i][jj] += sum_k p[ty + 64 / R i][k] b[k][DJ tx + jj] over a
// [64][LDP] float32 tile p and a staged [64][ldr] tile b of T, k in
// increasing order, 16 bytes per read of p: O = P V and dQ = dS K (p by
// query), dV = P^T dO and dK = dS^T Q (p stored transposed, by key).  R
// rows per thread, as for tile_abt16.
template <typename T, int D, int R = RI>
__device__ __forceinline__ void tile_pb16(float (&acc)[R][D / 16],
                                          const float* p, const T* bt,
                                          int tx, int ty) {
  constexpr int DJ = D / 16;
  constexpr int L = ldr<T, D>();
#pragma unroll 2
  for (int kk = 0; kk < TILE; kk += 4) {
    float pv[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
      load_row<4>(pv[i], p + (ty + TILE / R * i) * LDP + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float bv[DJ];
      load_row<DJ>(bv, bt + (kk + e) * L + DJ * tx);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          acc[i][jj] = fmaf(pv[i][e], bv[jj], acc[i][jj]);
    }
  }
}

// 16-byte alignment of a pointer, and of strides of `elem`-byte elements
inline bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}
inline bool strides_aligned(const Strides& s, int elem) {
  const long long vec = 16 / elem;
  return s.b % vec == 0 && s.t % vec == 0 && s.h % vec == 0;
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
