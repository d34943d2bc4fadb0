// Kernel 5f: the flash-attention forward with segment masking.
//
// Replaces the forward pallas_call of the stock TPU kernel that
// danet_tpu/ops/pallas/attention.py::flash_attention_masked wraps
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_impl / _flash_attention_kernel).  Per (b, h) and query
// row i, over the keys j:
//
//   s_ij = (q_i . k_j) * sm_scale + (seg_i == seg_j ? 0 : MASK_VALUE)
//   m_i = max_j s_ij,  l_i = sum_j exp(s_ij - m_i)
//   o_i = sum_j T(exp(s_ij - m)) v_j / l_i
//
// in float32, with the probabilities rounded to the storage type T before
// their product with v (as the stock kernel casts p to v's dtype), o
// stored in T and l, m in float32 [B, H, T] for the backward.  The mask
// value is finite (-0.7 float32 max), so a key tile that is all masked for
// a row leaves no NaN: its contribution is scaled by exp(MASK - m) = 0 as
// soon as a visible key raises m.
//
// What bounds it on this card: 4 B H T^2 D FLOPs (two T x T x D products)
// against 4 B T H D inputs and outputs: at the serving shape (B=1, H=4,
// T=1280, D=64) 1.68 GFLOP and 1.3 MB, at the training shape (B=32,
// T=128) 0.54 GFLOP: operations, not bytes, at the float32 rate (the
// kernel keeps float32 math on the CUDA cores, no TF32: the parity bar
// with the plain version is 1e-5).  Design, simple first: one block of 256
// threads per (b, h, 64-query tile), the online softmax over 64-key tiles
// staged in shared memory; S = Q K^T and the update O = alpha O + P V are
// register-tiled 4 x 4 per thread (flash_tiles.cuh); the row max and sum
// are half-warp shuffles, and each thread keeps m, l and the rescaling of
// its own four rows in registers.  q, k and v are read through the strides
// of the qkv projection's views, so no transposed copy exists.
#include "flash_tiles.cuh"

namespace {

using flash::LD_P;
using flash::RI;
using flash::Strides;
using flash::THREADS;
using flash::TILE;
using flash::ld;

template <int D>
size_t fwd_smem_bytes() {
  // q_s, k_s, v_s [64][D + 1], p_s [64][65]; segment ids of both tiles
  return sizeof(float) * (3 * TILE * ld<D>() + TILE * LD_P) +
         sizeof(int) * 2 * TILE;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 T* __restrict__ o, float* __restrict__ l_out,
                 float* __restrict__ m_out, int heads, int seq, Strides st,
                 float sm_scale) {
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + TILE * ld<D>();
  float* v_s = k_s + TILE * ld<D>();
  float* p_s = v_s + TILE * ld<D>();
  int* segq_s = reinterpret_cast<int*>(p_s + TILE * LD_P);
  int* segk_s = segq_s + TILE;

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  flash::load_tile<T, D>(q_s, q, st, b, q0, h);
  if (tid < TILE) segq_s[tid] = seg ? seg[b * seq + q0 + tid] : 0;

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += TILE) {
    flash::load_tile<T, D>(k_s, k, st, b, k0, h);
    flash::load_tile<T, D>(v_s, v, st, b, k0, h);
    if (tid < TILE) segk_s[tid] = seg ? seg[b * seq + k0 + tid] : 0;
    __syncthreads();

    float s[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
    flash::tile_abt<D>(s, q_s, k_s, tx, ty);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        s[i][j] *= sm_scale;
        if (segq_s[r] != segk_s[tx + 16 * j]) s[i][j] += flash::MASK_VALUE;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_next = fmaxf(m[i], flash::row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const float p = expf(s[i][j] - m_next);
        sum += p;
        p_s[r * LD_P + tx + 16 * j] = flash::round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_next);
      l[i] = flash::row_sum(sum) + alpha * l[i];
      m[i] = m_next;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[kk * ld<D>() + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[(ty + 16 * i) * LD_P + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = q0 + ty + 16 * i;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    T* row = o + ((static_cast<size_t>(b) * seq + t) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      row[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    if (tx == 0) {
      const size_t at = (static_cast<size_t>(b) * heads + h) * seq + t;
      l_out[at] = l[i];
      m_out[at] = m[i];
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg,
               void* o, void* l, void* m, int batch, int heads, int seq,
               Strides st, float sm_scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  const int status = flash::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (status != 0) return status;
  const dim3 grid(seq / TILE, heads, batch);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg),
      static_cast<T*>(o), static_cast<float*>(l), static_cast<float*>(m),
      heads, seq, st, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_by_dim(int head_dim, const void* q, const void* k, const void* v,
               const void* seg, void* o, void* l, void* m, int batch,
               int heads, int seq, Strides st, float sm_scale,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_fwd<T, 16>(q, k, v, seg, o, l, m, batch, heads, seq, st,
                               sm_scale, stream);
    case 32:
      return launch_fwd<T, 32>(q, k, v, seg, o, l, m, batch, heads, seq, st,
                               sm_scale, stream);
    case 64:
      return launch_fwd<T, 64>(q, k, v, seg, o, l, m, batch, heads, seq, st,
                               sm_scale, stream);
    case 128:
      return launch_fwd<T, 128>(q, k, v, seg, o, l, m, batch, heads, seq, st,
                                sm_scale, stream);
    default:
      return DANET_BAD_ARGUMENT;
  }
}

}  // namespace

// q, k, v [B, T, H, D] of storage type `dtype` (0 float32, 1 bfloat16) at
// element offsets b * sb + t * st + h * sh + d; seg int32 [B, T] or NULL
// (no masking); o [B, T, H, D] contiguous of the same type; l, m float32
// [B, H, T].  T a multiple of 64, D in {16, 32, 64, 128}.  Launches on
// `stream`; no sync.
extern "C" int danet_flash_attn(const void* q, const void* k, const void* v,
                                const void* seg, void* o, void* l, void* m,
                                int batch, int heads, int seq, int head_dim,
                                int dtype, long long sb, long long st,
                                long long sh, float sm_scale, void* stream) {
  if (flash::bad_shape(batch, heads, seq) || seq / TILE > 65535)
    return DANET_BAD_ARGUMENT;
  const Strides strides{sb, st, sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_by_dim<float>(head_dim, q, k, v, seg, o, l, m, batch, heads,
                             seq, strides, sm_scale, s);
  if (dtype == 1)
    return fwd_by_dim<__nv_bfloat16>(head_dim, q, k, v, seg, o, l, m, batch,
                                     heads, seq, strides, sm_scale, s);
  return DANET_BAD_ARGUMENT;
}
