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
// with the plain version is 1e-5).
//
// Design.  One block of 256 threads per (b, h, 64-query tile) and key
// split: the online softmax over 64-key tiles; S = Q K^T and O = alpha O +
// P V register-tiled 4 x 4 per thread; the row max and sum are half-warp
// shuffles, and each thread keeps m, l and the rescaling of its own four
// rows in registers.
//   * Key split.  At B=1 the (T/64) H B tiles leave SMs idle (80 blocks on
//     132 SMs at T=1280), so the wrapper asks for S = 2, 4 or 8 blocks per
//     query tile (ops/cuda/attention.py::flash_splits), launched as one
//     thread-block cluster.  Rank r runs the online softmax over key tiles
//     [r n / S, (r + 1) n / S) of the n tiles (uneven splits are fine;
//     every rank has at least one tile).  The ranks then combine through
//     distributed shared memory: each leaves m, l and its unnormalised
//     accumulator in its own shared memory, the cluster synchronises, and
//     rank r reads all S of them for rows [r 64 / S, (r + 1) 64 / S):
//     m = max_s m_s, l = sum_s exp(m_s - m) l_s, o = sum_s exp(m_s - m)
//     acc_s / l; a second cluster barrier keeps every block's shared
//     memory alive until the others have read it.  With S = 1 there is no
//     cluster and the block writes o, l and m itself, as before.
//   * Staging.  K, V (and Q once) are copied raw, in their storage type,
//     by 16-byte cp.async into shared tiles whose rows carry 16 bytes of
//     padding, double-buffered: the copies of key tile j + 1 are in flight
//     while tile j is multiplied.  The padding makes the 16-byte reads of
//     16 different key rows (one per thread of a half warp) fall in
//     distinct banks per quarter warp, so S = Q K^T reads 16 bytes of q and
//     of k per shared load (4 f32 or 8 bf16 values), and P V reads each
//     thread's DJ = D / 16 contiguous output columns of a v row at once.
//   * q, k and v are read through the strides of the qkv projection's
//     views, so no transposed copy exists; cp.async needs the pointers and
//     strides 16-byte aligned, which the wrapper ensures (it copies
//     otherwise) and the entry point checks.
// Shared memory: q [64][D + pad], 2 x (k, v) [64][D + pad] in T, p
// [64][68] f32 and the segment ids: 102 KB at D=64 in f32 (two blocks per
// SM), 53 KB in bf16; 186 KB at D=128 in f32.
#include <cooperative_groups.h>

#include "flash_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using flash::LDP;
using flash::RI;
using flash::Strides;
using flash::THREADS;
using flash::TILE;
using flash::ldr;
using flash::stage_seg;
using flash::stage_tile;

constexpr int MAX_SPLITS = 8;     // the portable cluster size

template <typename T, int D>
size_t fwd_smem_bytes() {
  // q, then 2 stages of (k, v), each [64][ldr] of T; p_s [64][LDP] f32;
  // segment ids of the queries and of both key stages
  return sizeof(T) * 5 * TILE * ldr<T, D>() + sizeof(float) * TILE * LDP +
         sizeof(int) * 3 * TILE;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 T* __restrict__ o, float* __restrict__ l_out,
                 float* __restrict__ m_out, int heads, int seq, int splits,
                 Strides st, float sm_scale) {
  constexpr int DJ = D / 16;  // output columns per thread (contiguous)
  constexpr int L = ldr<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + TILE * L;  // stage j: k at kv_s + 2 j TILE L, v after it
  float* p_s = reinterpret_cast<float*>(kv_s + 4 * TILE * L);
  int* segq_s = reinterpret_cast<int*>(p_s + TILE * LDP);
  int* segk_s = segq_s + TILE;  // [2][64]

  const int rank = blockIdx.x % splits;
  const int q0 = blockIdx.x / splits * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_tiles = seq / TILE;
  const int kb = rank * n_tiles / splits, ke = (rank + 1) * n_tiles / splits;

  auto issue = [&](int j) {  // key tile j into stage j % 2
    if (j < ke) {
      T* ks = kv_s + (j % 2) * 2 * TILE * L;
      stage_tile<T, D>(ks, k, st, b, j * TILE, h);
      stage_tile<T, D>(ks + TILE * L, v, st, b, j * TILE, h);
      stage_seg(segk_s + (j % 2) * TILE, seg, b, seq, j * TILE);
    }
    cp_async_commit();
  };
  stage_tile<T, D>(q_s, q, st, b, q0, h);
  stage_seg(segq_s, seg, b, seq, q0);
  issue(kb);  // one group: q and the first key tile

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int j = kb; j < ke; ++j) {
    issue(j + 1);           // in flight while tile j is multiplied
    cp_async_wait<1>();     // this thread's copies of tile j landed
    __syncthreads();        // ... and every other thread's
    const T* k_t = kv_s + (j % 2) * 2 * TILE * L;
    const T* v_t = k_t + TILE * L;
    const int* segk = segk_s + (j % 2) * TILE;

    // S = Q K^T: rows ty + 16 i, key columns tx + 16 jj, d in order
    float s[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < RI; ++jj) s[i][jj] = 0.f;
    flash::tile_abt16<T, D>(s, q_s, k_t, tx, ty);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < RI; ++jj) {
        s[i][jj] *= sm_scale;
        if (segq_s[r] != segk[tx + 16 * jj]) s[i][jj] += flash::MASK_VALUE;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_next = fmaxf(m[i], flash::row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < RI; ++jj) {
        const float p = expf(s[i][jj] - m_next);
        sum += p;
        p_s[r * LDP + tx + 16 * jj] = flash::round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_next);
      l[i] = flash::row_sum(sum) + alpha * l[i];
      m[i] = m_next;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    // O += P V: rows ty + 16 i, columns DJ tx .. DJ tx + DJ - 1, keys in
    // order
    flash::tile_pb16<T, D>(acc, p_s, v_t, tx, ty);
    __syncthreads();  // stage j % 2 and p_s are free
  }
  cp_async_wait<0>();

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int t = q0 + ty + 16 * i;
      const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
      T* row = o + ((static_cast<size_t>(b) * seq + t) * heads + h) * D;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        row[DJ * tx + jj] = from_f32<T>(acc[i][jj] * inv);
      if (tx == 0) {
        const size_t at = (static_cast<size_t>(b) * heads + h) * seq + t;
        l_out[at] = l[i];
        m_out[at] = m[i];
      }
    }
    return;
  }

  // Combine the S ranks of the cluster through distributed shared memory:
  // this rank's unnormalised acc [64][D + 4] where its key stages were,
  // m [64] and l [64] where p_s was (both idle after the loop's last
  // barrier).
  constexpr int LDA = D + 4;
  float* acc_s = reinterpret_cast<float*>(kv_s);
  float* ml_s = p_s;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc_s[r * LDA + DJ * tx + jj] = acc[i][jj];
    if (tx == 0) {
      ml_s[r] = m[i];
      ml_s[TILE + r] = l[i];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partials written (and visible)
  const int rows = TILE / splits, r0 = rank * rows;
  for (int e = tid; e < rows * D; e += THREADS) {
    const int r = r0 + e / D, d = e % D;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, cluster.map_shared_rank(ml_s, s)[r]);
    float lsum = 0.f, out = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(cluster.map_shared_rank(ml_s, s)[r] - mx);
      lsum += w * cluster.map_shared_rank(ml_s, s)[TILE + r];
      out += w * cluster.map_shared_rank(acc_s, s)[r * LDA + d];
    }
    const int t = q0 + r;
    const float inv = lsum == 0.f ? 1.f : 1.f / lsum;
    o[((static_cast<size_t>(b) * seq + t) * heads + h) * D + d] =
        from_f32<T>(out * inv);
    if (d == 0) {
      const size_t at = (static_cast<size_t>(b) * heads + h) * seq + t;
      l_out[at] = lsum;
      m_out[at] = mx;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg,
               void* o, void* l, void* m, int batch, int heads, int seq,
               int splits, Strides st, float sm_scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T, D>();
  const int status = flash::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (status != 0) return status;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(seq / TILE * splits, heads, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_fwd_kernel<T, D>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg), static_cast<T*>(o),
      static_cast<float*>(l), static_cast<float*>(m), heads, seq, splits, st,
      sm_scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_by_dim(int head_dim, const void* q, const void* k, const void* v,
               const void* seg, void* o, void* l, void* m, int batch,
               int heads, int seq, int splits, Strides st, float sm_scale,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_fwd<T, 16>(q, k, v, seg, o, l, m, batch, heads, seq,
                               splits, st, sm_scale, stream);
    case 32:
      return launch_fwd<T, 32>(q, k, v, seg, o, l, m, batch, heads, seq,
                               splits, st, sm_scale, stream);
    case 64:
      return launch_fwd<T, 64>(q, k, v, seg, o, l, m, batch, heads, seq,
                               splits, st, sm_scale, stream);
    case 128:
      return launch_fwd<T, 128>(q, k, v, seg, o, l, m, batch, heads, seq,
                                splits, st, sm_scale, stream);
    default:
      return DANET_BAD_ARGUMENT;
  }
}

}  // namespace

// q, k, v [B, T, H, D] of storage type `dtype` (0 float32, 1 bfloat16) at
// element offsets b * sb + t * st + h * sh + d, 16-byte aligned pointers
// and strides; seg int32 [B, T] (16-byte aligned) or NULL (no masking); o
// [B, T, H, D] contiguous of the same type; l, m float32 [B, H, T].  T a
// multiple of 64, D in {16, 32, 64, 128}; `splits` blocks (a cluster) per
// query tile, 1 to 8 and at most T / 64.  Launches on `stream`; no sync.
extern "C" int danet_flash_attn(const void* q, const void* k, const void* v,
                                const void* seg, void* o, void* l, void* m,
                                int batch, int heads, int seq, int head_dim,
                                int splits, int dtype, long long sb,
                                long long st, long long sh, float sm_scale,
                                void* stream) {
  const Strides strides{sb, st, sh};
  const int elem = dtype == 1 ? 2 : 4;
  if (flash::bad_shape(batch, heads, seq) || splits < 1 ||
      splits > MAX_SPLITS || TILE % splits != 0 || splits > seq / TILE ||
      static_cast<long long>(seq / TILE) * splits > 0x7fffffff ||
      !flash::aligned16(q) || !flash::aligned16(k) || !flash::aligned16(v) ||
      (seg != nullptr && !flash::aligned16(seg)) ||
      !flash::strides_aligned(strides, elem))
    return DANET_BAD_ARGUMENT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_by_dim<float>(head_dim, q, k, v, seg, o, l, m, batch, heads,
                             seq, splits, strides, sm_scale, s);
  if (dtype == 1)
    return fwd_by_dim<__nv_bfloat16>(head_dim, q, k, v, seg, o, l, m, batch,
                                     heads, seq, splits, strides, sm_scale,
                                     s);
  return DANET_BAD_ARGUMENT;
}
