// Kernels 5dkv and 5dq: the flash-attention backward with segment masking.
//
// Replace the two backward pallas_calls of the stock TPU kernel that
// danet_tpu/ops/pallas/attention.py::flash_attention_masked wraps
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq), split the same
// way.  From the saved row statistics l, m (float32 [B, H, T]), the
// cotangent do and di = rowsum(o * do) (float32, computed outside):
//
//   p_ij  = exp(s_ij - m_i) * (1 / l_i)   (s as in the forward, masked)
//   ds_ij = (do_i . v_j - di_i) * p_ij * sm_scale
//   dV_j  = sum_i T(p_ij) do_i,   dK_j = sum_i T(ds_ij) q_i
//   dQ_i  = sum_j T(ds_ij) k_j
//
// with p and ds rounded to the storage type T before their products, as
// the stock kernel casts them to do's and k's dtype.
//
//   * flash_attn_bwd_dkv: one block per (b, h, 64-key tile); it loops over
//     the query tiles and keeps its dK and dV rows in registers;
//   * flash_attn_bwd_dq: one block per (b, h, 64-query tile); it loops over
//     the key tiles and keeps its dQ rows in registers.
//
// Each output row is owned by one block, so no atomics and the result is
// deterministic.  What bounds them on this card: operations -- dK/dV does
// four T x T x D products (S, dP, dV, dK: 8 B H T^2 D FLOPs), dQ three (S,
// dP, dQ: 6 B H T^2 D) -- at the float32 rate: the math stays float32 on
// the CUDA cores, as in the forward (flash_attn.cu).  The products are
// register tiles over 64-row shared-memory tiles (flash_tiles.cuh): the
// forward's 4 x 4 per thread in dK/dV (256 threads), 8 x 4 in dQ (128
// threads, DQ_ROWS).
//
// Both kernels stage their tiles as the forward does: each tile copied
// raw, in the storage type, by 16-byte cp.async into rows padded by 16
// bytes, and read 16 bytes at a time in every product.  One buffer per
// tile, in an order that hides the copies behind the products:
//
//   * dK/dV: K and V once, then per query tile Q and dO (and l, m, di and
//     the segment ids); dP = dO V^T runs while Q lands, dK += dS^T Q while
//     the next dO lands, and the next dP while the next Q lands (the first
//     dO and Q are in flight with K and V).  103 KB at D=64 in float32
//     (71 KB in bfloat16).  P and dS are stored transposed, [key][query],
//     so that dV += P^T dO and dK += dS^T Q read them 16 bytes at a time.
//   * dQ: Q, dO and the row statistics once, then per key tile K and V;
//     dP = dO V^T runs while the first Q and K land, the next V is issued
//     as soon as dP has read V and lands during S = Q K^T, the scores and
//     dQ += dS K, and the next K is issued once dQ has read K and lands
//     during the next dP.  88 KB at D=64 in float32 (56 KB in bfloat16).
//     dS is stored [query][key], so that dQ += dS K reads it 16 bytes at a
//     time.
//
// So two blocks share an SM at D <= 64, and the training shape (B=32, H=4,
// T=128: 256 blocks per kernel) is one wave on 132 SMs.  Each output
// element sums its queries (dK, dV) or keys (dQ) in increasing order in
// one fmaf chain, S, dP, p and ds are computed as the first design of
// these kernels computed them (d in increasing order from 0), and ds is
// rounded to the storage type before its products, so the outputs are bit
// for bit that design's (scalar loads into float32 tiles).  On an H100 at
// the training shape, a layout that read both operands of every product
// k-major, through transposes of K, V, Q and dO in shared memory, made
// dK/dV 5 % slower: the products do not wait on the width of the shared
// reads (PERF.md).
#include "flash_tiles.cuh"

namespace {

using flash::LDP;
using flash::RI;
using flash::Strides;
using flash::THREADS;
using flash::TILE;
using flash::ldr;
using flash::stage_seg;
using flash::stage_tile;

// 5dq's query rows per thread: 8 (128 threads, an 8 x 4 tile), or 4 (256
// threads, the 4 x 4 tile of the other kernels), which read 5 % slower at
// the training shape on an H100 (PERF.md)
constexpr int DQ_ROWS = 8;
constexpr int DQ_STEP = TILE / DQ_ROWS;     // rows ty + DQ_STEP i
constexpr int DQ_THREADS = 16 * DQ_STEP;

template <typename T, int D>
size_t dkv_smem_bytes() {
  // k, v, q, do [64][ldr] of T; pT, dsT [64][LDP] f32; l, m, di [64] f32;
  // the segment ids of the query and key tiles
  return sizeof(T) * 4 * TILE * ldr<T, D>() +
         sizeof(float) * (2 * TILE * LDP + 3 * TILE) + sizeof(int) * 2 * TILE;
}

// Issue the copies of l, m and di (float32 rows at `at`) and the segment
// ids of query rows t0 .. t0 + 63.
__device__ __forceinline__ void stage_stats(float* l_s, float* m_s,
                                            float* di_s, int* segq_s,
                                            const float* l, const float* m,
                                            const float* di, const int* seg,
                                            size_t at, int b, int seq,
                                            int t0) {
  const int tid = threadIdx.x;
  if (tid < 16)
    cp_async16(l_s + 4 * tid, l + at + 4 * tid);
  else if (tid < 32)
    cp_async16(m_s + 4 * (tid - 16), m + at + 4 * (tid - 16));
  else if (tid < 48)
    cp_async16(di_s + 4 * (tid - 32), di + at + 4 * (tid - 32));
  stage_seg(segq_s, seg, b, seq, t0);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     const float* __restrict__ l, const float* __restrict__ m,
                     const T* __restrict__ dout,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int seq, Strides st,
                     float sm_scale) {
  constexpr int DJ = D / 16;  // output columns per thread (contiguous)
  constexpr int L = ldr<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + TILE * L;
  T* q_s = v_s + TILE * L;
  T* do_s = q_s + TILE * L;
  float* pt_s = reinterpret_cast<float*>(do_s + TILE * L);  // [key][query]
  float* dst_s = pt_s + TILE * LDP;                          // [key][query]
  float* l_s = dst_s + TILE * LDP;
  float* m_s = l_s + TILE;
  float* di_s = m_s + TILE;
  int* segq_s = reinterpret_cast<int*>(di_s + TILE);
  int* segk_s = segq_s + TILE;

  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t stats = (static_cast<size_t>(b) * heads + h) * seq;
  const Strides sd{static_cast<long long>(seq) * heads * D,
                   static_cast<long long>(heads) * D, D};  // do, contiguous
  auto issue_do = [&](int q0) {  // dO and the statistics of query tile q0
    stage_tile<T, D>(do_s, dout, sd, b, q0, h);
    stage_stats(l_s, m_s, di_s, segq_s, l, m, di, seg, stats + q0, b, seq,
                q0);
    cp_async_commit();
  };
  auto issue_q = [&](int q0) {  // Q of query tile q0
    stage_tile<T, D>(q_s, q, st, b, q0, h);
    cp_async_commit();
  };
  // two groups: V with the first dO tile (dP), then K with the first Q
  // tile (S), so that dP runs while K and Q land
  stage_tile<T, D>(v_s, v, st, b, k0, h);
  issue_do(0);
  stage_tile<T, D>(k_s, k, st, b, k0, h);
  stage_seg(segk_s, seg, b, seq, k0);
  issue_q(0);

  float dk_acc[RI][DJ], dv_acc[RI][DJ];  // key rows ty + 16 i
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += TILE) {
    // dP = dO V^T, then S = Q K^T: query rows ty + 16 i, key columns
    // tx + 16 j
    float p[RI][RI], ds[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) p[i][j] = ds[i][j] = 0.f;
    cp_async_wait<1>();  // this thread's dO (and statistics) landed
    __syncthreads();     // ... and every other thread's
    flash::tile_abt16<T, D>(ds, do_s, v_s, tx, ty);
    cp_async_wait<0>();  // Q
    __syncthreads();
    flash::tile_abt16<T, D>(p, q_s, k_s, tx, ty);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const float inv_l = 1.f / l_s[r];
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        float s = p[i][j] * sm_scale;
        if (segq_s[r] != segk_s[c]) s += flash::MASK_VALUE;
        const float pv = expf(s - m_s[r]) * inv_l;
        const float dsv = (ds[i][j] - di_s[r]) * pv * sm_scale;
        pt_s[c * LDP + r] = flash::round_to<T>(pv);
        dst_s[c * LDP + r] = flash::round_to<T>(dsv);
      }
    }
    __syncthreads();  // pT and dsT complete; the statistics are free
    // dV += P^T dO, then dK += dS^T Q: key rows ty + 16 i, columns
    // DJ tx .. DJ tx + DJ - 1, queries in order
    flash::tile_pb16<T, D>(dv_acc, pt_s, do_s, tx, ty);
    __syncthreads();  // do_s free: the next dO lands during dK
    if (q0 + TILE < seq) issue_do(q0 + TILE);
    flash::tile_pb16<T, D>(dk_acc, dst_s, q_s, tx, ty);
    __syncthreads();  // q_s, pT and dsT free: the next Q lands during dP
    if (q0 + TILE < seq) issue_q(q0 + TILE);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const size_t row =
        ((static_cast<size_t>(b) * seq + k0 + ty + 16 * i) * heads + h) * D +
        DJ * tx;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[row + j] = from_f32<T>(dk_acc[i][j]);
      dv[row + j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
size_t dq_smem_bytes() {
  // q, do, k, v [64][ldr] of T; ds [64][LDP] f32; l, m, di [64] f32; the
  // segment ids of the query and key tiles
  return sizeof(T) * 4 * TILE * ldr<T, D>() +
         sizeof(float) * (TILE * LDP + 3 * TILE) + sizeof(int) * 2 * TILE;
}

template <typename T, int D>
__global__ void __launch_bounds__(DQ_THREADS, D <= 64 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ seg,
                    const float* __restrict__ l, const float* __restrict__ m,
                    const T* __restrict__ dout, const float* __restrict__ di,
                    T* __restrict__ dq, int heads, int seq, Strides st,
                    float sm_scale) {
  constexpr int DJ = D / 16;  // output columns per thread (contiguous)
  constexpr int L = ldr<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + TILE * L;
  T* k_s = do_s + TILE * L;
  T* v_s = k_s + TILE * L;
  float* ds_s = reinterpret_cast<float*>(v_s + TILE * L);  // [query][key]
  float* l_s = ds_s + TILE * LDP;
  float* m_s = l_s + TILE;
  float* di_s = m_s + TILE;
  int* segq_s = reinterpret_cast<int*>(di_s + TILE);
  int* segk_s = segq_s + TILE;

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t stats = (static_cast<size_t>(b) * heads + h) * seq;
  const Strides sd{static_cast<long long>(seq) * heads * D,
                   static_cast<long long>(heads) * D, D};  // do, contiguous
  auto issue_v = [&](int kt) {  // V of key tile kt
    stage_tile<T, D, DQ_THREADS>(v_s, v, st, b, kt, h);
    cp_async_commit();
  };
  auto issue_k = [&](int kt) {  // K and the segment ids of key tile kt
    stage_tile<T, D, DQ_THREADS>(k_s, k, st, b, kt, h);
    stage_seg(segk_s, seg, b, seq, kt);
    cp_async_commit();
  };
  // two groups: dO and the statistics with the first V tile (dP), then Q
  // with the first K tile (S), so that dP runs while Q and K land
  stage_tile<T, D, DQ_THREADS>(do_s, dout, sd, b, q0, h);
  stage_stats(l_s, m_s, di_s, segq_s, l, m, di, seg, stats + q0, b, seq, q0);
  issue_v(0);
  stage_tile<T, D, DQ_THREADS>(q_s, q, st, b, q0, h);
  issue_k(0);

  float dq_acc[DQ_ROWS][DJ];  // query rows ty + DQ_STEP i
#pragma unroll
  for (int i = 0; i < DQ_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += TILE) {
    // dP = dO V^T, then S = Q K^T: query rows ty + DQ_STEP i, key columns
    // tx + 16 j
    float p[DQ_ROWS][RI], ds[DQ_ROWS][RI];
#pragma unroll
    for (int i = 0; i < DQ_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) p[i][j] = ds[i][j] = 0.f;
    cp_async_wait<1>();  // this thread's V (and dO, statistics) landed
    __syncthreads();     // ... and every other thread's
    flash::tile_abt16<T, D, DQ_ROWS>(ds, do_s, v_s, tx, ty);
    cp_async_wait<0>();  // K (and Q)
    __syncthreads();     // ... everywhere; v_s is free
    if (k0 + TILE < seq) issue_v(k0 + TILE);
    flash::tile_abt16<T, D, DQ_ROWS>(p, q_s, k_s, tx, ty);
#pragma unroll
    for (int i = 0; i < DQ_ROWS; ++i) {
      const int r = ty + DQ_STEP * i;
      const float inv_l = 1.f / l_s[r];
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        float s = p[i][j] * sm_scale;
        if (segq_s[r] != segk_s[c]) s += flash::MASK_VALUE;
        const float pv = expf(s - m_s[r]) * inv_l;
        const float dsv = (ds[i][j] - di_s[r]) * pv * sm_scale;
        ds_s[r * LDP + c] = flash::round_to<T>(dsv);
      }
    }
    __syncthreads();  // dS complete
    // dQ += dS K: query rows ty + DQ_STEP i, columns DJ tx .. DJ tx + DJ
    // - 1, keys in order
    flash::tile_pb16<T, D, DQ_ROWS>(dq_acc, ds_s, k_s, tx, ty);
    __syncthreads();  // k_s, dS and the key segment ids free
    if (k0 + TILE < seq) issue_k(k0 + TILE);
  }

#pragma unroll
  for (int i = 0; i < DQ_ROWS; ++i) {
    const size_t row =
        ((static_cast<size_t>(b) * seq + q0 + ty + DQ_STEP * i) * heads + h) *
            D +
        DJ * tx;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[row + j] = from_f32<T>(dq_acc[i][j]);
  }
}

// The arguments of both entry points, as one struct for the dispatch.
struct BwdArgs {
  const void *q, *k, *v, *seg, *l, *m, *dout, *di;
  void *d0, *d1;  // dk, dv (dK/dV kernel) or dq (dQ kernel)
  int batch, heads, seq;
  Strides st;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int D, bool DKV>
int launch_bwd(const BwdArgs& a) {
  const dim3 grid(a.seq / TILE, a.heads, a.batch);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int* seg = static_cast<const int*>(a.seg);
  const float* l = static_cast<const float*>(a.l);
  const float* m = static_cast<const float*>(a.m);
  const T* dout = static_cast<const T*>(a.dout);
  const float* di = static_cast<const float*>(a.di);
  if constexpr (DKV) {
    const size_t smem = dkv_smem_bytes<T, D>();
    const int status = flash::allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
    if (status != 0) return status;
    flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
        q, k, v, seg, l, m, dout, di, static_cast<T*>(a.d0),
        static_cast<T*>(a.d1), a.heads, a.seq, a.st, a.sm_scale);
  } else {
    const size_t smem = dq_smem_bytes<T, D>();
    const int status = flash::allow_smem(flash_bwd_dq_kernel<T, D>, smem);
    if (status != 0) return status;
    flash_bwd_dq_kernel<T, D><<<grid, DQ_THREADS, smem, a.stream>>>(
        q, k, v, seg, l, m, dout, di, static_cast<T*>(a.d0), a.heads, a.seq,
        a.st, a.sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV, typename T>
int bwd_by_dim(int head_dim, const BwdArgs& a) {
  switch (head_dim) {
    case 16: return launch_bwd<T, 16, DKV>(a);
    case 32: return launch_bwd<T, 32, DKV>(a);
    case 64: return launch_bwd<T, 64, DKV>(a);
    case 128: return launch_bwd<T, 128, DKV>(a);
    default: return DANET_BAD_ARGUMENT;
  }
}

template <bool DKV>
int bwd(int head_dim, int dtype, const BwdArgs& a) {
  if (flash::bad_shape(a.batch, a.heads, a.seq) || a.seq / TILE > 65535)
    return DANET_BAD_ARGUMENT;
  if (dtype == 0) return bwd_by_dim<DKV, float>(head_dim, a);
  if (dtype == 1) return bwd_by_dim<DKV, __nv_bfloat16>(head_dim, a);
  return DANET_BAD_ARGUMENT;
}

// The 16-byte alignment both entry points need: every staged pointer
// (seg may be NULL) and the qkv strides in elements of the storage type.
bool misaligned(const BwdArgs& a, int dtype) {
  const void* staged[] = {a.q, a.k, a.v, a.l, a.m, a.dout, a.di};
  for (const void* p : staged)
    if (!flash::aligned16(p)) return true;
  return (a.seg != nullptr && !flash::aligned16(a.seg)) ||
         !flash::strides_aligned(a.st, dtype == 1 ? 2 : 4);
}

}  // namespace

// q, k, v as for danet_flash_attn (strided, storage type `dtype`, 16-byte
// aligned pointers and strides); seg int32 [B, T] or NULL; l, m, di
// float32 [B, H, T]; do, dk, dv contiguous [B, T, H, D] of the storage
// type; seg, l, m, di and do 16-byte aligned.  Launches on `stream`; no
// sync.
extern "C" int danet_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* seg,
    const void* l, const void* m, const void* dout, const void* di, void* dk,
    void* dv, int batch, int heads, int seq, int head_dim, int dtype,
    long long sb, long long st, long long sh, float sm_scale, void* stream) {
  const BwdArgs a{q, k, v, seg, l, m, dout, di, dk, dv, batch, heads, seq,
                  Strides{sb, st, sh}, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  if (misaligned(a, dtype)) return DANET_BAD_ARGUMENT;
  return bwd<true>(head_dim, dtype, a);
}

// As danet_flash_attn_bwd_dkv, with dq [B, T, H, D] the one output.
extern "C" int danet_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* seg,
    const void* l, const void* m, const void* dout, const void* di, void* dq,
    int batch, int heads, int seq, int head_dim, int dtype, long long sb,
    long long st, long long sh, float sm_scale, void* stream) {
  const BwdArgs a{q, k, v, seg, l, m, dout, di, dq, nullptr, batch, heads,
                  seq, Strides{sb, st, sh}, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  if (misaligned(a, dtype)) return DANET_BAD_ARGUMENT;
  return bwd<false>(head_dim, dtype, a);
}
