// Kernel 3 and its one-direction form: the backward of one LSTM layer, all
// its directions, the whole reverse time loop in one cooperative launch.
//
// Replaces danet_tpu/ops/pallas/lstm.py::_bwd_call (the backward of
// bilstm_scan_pallas with n_dirs=2 and of lstm_scan_pallas with n_dirs=1,
// _bwd_kernel and _cell_bwd_step).  For t = T-1 down to 0, per direction,
// in f32:
//
//   dh     = d_hs[t] + dh_carry
//   do     = dh * tanh(c_t) * o * (1 - o)
//   dc     = dc + dh * o * (1 - tanh(c_t)^2)
//   dcand  = dc * i * (1 - cand^2)   (dc * i for the identity candidate)
//   di     = dc * cand * i * (1 - i)
//   df     = dc * c_{t-1} * f * (1 - f)
//   dxp[t] = [dcand, di, df, do], rounded to the storage type
//   dc     = dc * f
//   dh_carry = dxp[t] @ Wh^T         (from the ROUNDED dxp[t], as JAX does)
//
// and after step 0: dc0 = dc, dh0 = dh_carry, rounded.  cand, i, f, o come
// from the residuals acts[t] and c_t from cs[t] that kernel 2 stored;
// c_{t-1} is c_prev[t] (c0, then cs[:-1]).  Shapes, with D = n_dirs (1
// or 2; grid.y, and a template parameter as in the forward): d_hs, cs,
// c_prev [T, D, B, H], acts and dxp [T, D, B, 4H], wh [D, H, 4H], dc0/dh0
// [D, B, H]; storage f32 or bf16.  dWh = sum_t h_{t-1}^T dxp[t] has no
// sequential dependency and is one bulk matmul outside the kernel, as in
// the JAX package.
//
// What bounds it on this card: as in the forward, the per-step dependency
// on the whole previous dact row, not FLOPs.  Each direction's hidden units
// are split over blocks, UNITS per block (38 blocks at H=300).  A block
// owns UNITS units for every batch row: it keeps those rows of Wh,
// [UNITS, 4H] (76.8 KB in f32 at H=300), resident in shared memory, and its
// dc and dh_carry in shared memory.  Each step it runs the cell backward of
// its units and writes its 4*UNITS gate columns of dxp[t]; after one
// grid-wide barrier it reads the whole rounded dxp[t] row of its direction
// back through L2 (ld.global.cg), staged in column chunks of KC (the full
// [B, 4H] row, 153.6 KB at B=32 in f32, would not fit beside Wh), and
// contracts it against its Wh rows.  Each thread holds a BT x UG register
// tile of that product over a KS-strided share of the columns, so every
// shared-memory read of the chunk or of Wh feeds 4 or 8 FMAs.  The reads
// of acts, cs, c_prev and d_hs run in reverse time by index; no reversed
// copy is made.  At H=600 with one direction (lstm-orig) the block's Wh
// rows are [16, 2400] (153.6 KB): 218 KB in all at B=32, which fits the
// 227 KB limit up to B=39.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int UNITS = 16;                      // hidden units per block
constexpr int UG = 4;                          // units per thread tile
constexpr int BG = 4;                          // batch-row groups per pass
constexpr int BT = 8;                          // batch rows per thread tile
constexpr int KS = 16;                         // contraction split
constexpr int THREADS = (UNITS / UG) * BG * KS;  // 256
constexpr int PASS = BG * BT;                  // batch rows per pass
constexpr int KC = 256;                        // dxp columns per staged chunk
constexpr int KCP = KC + 1;                    // padded row stride of a chunk

size_t smem_bytes(int batch, int hdim) {
  // w_s [4H][UNITS] + d_s [PASS][KCP] + part_s [KS][B][UNITS]
  // + dc_s [B][UNITS] + dh_s [B][UNITS]
  return sizeof(float) * (static_cast<size_t>(4) * hdim * UNITS +
                          static_cast<size_t>(PASS) * KCP +
                          static_cast<size_t>(KS) * batch * UNITS +
                          static_cast<size_t>(2) * batch * UNITS);
}

template <typename T, bool TANH, int NDIRS>
__global__ void __launch_bounds__(THREADS)
bilstm_scan_bwd_kernel(const T* __restrict__ d_hs, const T* __restrict__ acts,
                       const T* __restrict__ cs, const T* __restrict__ c_prev,
                       const T* __restrict__ wh, T* dxp, T* __restrict__ dc0,
                       T* __restrict__ dh0, int n_steps, int batch,
                       int hdim) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int g4 = 4 * hdim;
  float* w_s = smem;
  float* d_s = w_s + static_cast<size_t>(g4) * UNITS;
  float* part_s = d_s + static_cast<size_t>(PASS) * KCP;
  float* dc_s = part_s + static_cast<size_t>(KS) * batch * UNITS;
  float* dh_s = dc_s + static_cast<size_t>(batch) * UNITS;

  const int dir = blockIdx.y;
  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(batch) * hdim;
  const size_t bg4 = static_cast<size_t>(batch) * g4;

  // resident Wh rows: w_s[g][u] = wh[dir, u0 + u, g] (coalesced over g)
  const T* whd = wh + static_cast<size_t>(dir) * hdim * g4;
  for (int e = tid; e < UNITS * g4; e += THREADS) {
    const int u = e / g4, g = e % g4;
    w_s[g * UNITS + u] =
        (u0 + u < hdim) ? to_f32(whd[static_cast<size_t>(u0 + u) * g4 + g])
                        : 0.f;
  }
  for (int e = tid; e < batch * UNITS; e += THREADS) {
    dc_s[e] = 0.f;
    dh_s[e] = 0.f;
  }
  __syncthreads();

  // register tile of the dh_carry product: units ug*UG.., rows bg*BT..
  // (within a pass), columns ks, ks + KS, ... of each chunk
  const int ug = tid % (UNITS / UG);
  const int bg = (tid / (UNITS / UG)) % BG;
  const int ks = tid / ((UNITS / UG) * BG);

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t td = static_cast<size_t>(t) * NDIRS + dir;

    // 1. cell backward of this block's (batch row, unit) pairs
    for (int e = tid; e < batch * UNITS; e += THREADS) {
      const int b = e / UNITS, u = e % UNITS, unit = u0 + u;
      if (unit >= hdim) continue;
      const size_t hix = td * bh + static_cast<size_t>(b) * hdim + unit;
      const size_t gix = td * bg4 + static_cast<size_t>(b) * g4 + unit;
      const float cand = to_f32(acts[gix]);
      const float ig = to_f32(acts[gix + hdim]);
      const float fg = to_f32(acts[gix + 2 * hdim]);
      const float og = to_f32(acts[gix + 3 * hdim]);
      const float tanh_c = tanhf(to_f32(cs[hix]));
      const float dh = to_f32(d_hs[hix]) + dh_s[e];
      const float do_pre = dh * tanh_c * og * (1.f - og);
      const float dc = dc_s[e] + dh * og * (1.f - tanh_c * tanh_c);
      const float dcand = dc * ig;
      const float dcand_pre = TANH ? dcand * (1.f - cand * cand) : dcand;
      const float di_pre = dc * cand * ig * (1.f - ig);
      const float df_pre = dc * to_f32(c_prev[hix]) * fg * (1.f - fg);
      dc_s[e] = dc * fg;
      dxp[gix] = from_f32<T>(dcand_pre);
      dxp[gix + hdim] = from_f32<T>(di_pre);
      dxp[gix + 2 * hdim] = from_f32<T>(df_pre);
      dxp[gix + 3 * hdim] = from_f32<T>(do_pre);
    }
    grid.sync();  // dxp[t] complete (and visible) before any block reads it

    // 2. dh_carry[b, u] = sum_g dxp[t][b, g] * Wh[u0 + u, g]
    const T* dx_t = dxp + td * bg4;
    for (int p0 = 0; p0 < batch; p0 += PASS) {
      float acc[BT][UG];
#pragma unroll
      for (int i = 0; i < BT; ++i)
#pragma unroll
        for (int j = 0; j < UG; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < g4; k0 += KC) {
        const int kn = min(KC, g4 - k0);
        __syncthreads();  // the previous chunk is no longer read
        for (int e = tid; e < PASS * kn; e += THREADS) {
          const int r = e / kn, k = e % kn;
          d_s[r * KCP + k] =
              (p0 + r < batch)
                  ? load_cg(dx_t + static_cast<size_t>(p0 + r) * g4 + k0 + k)
                  : 0.f;
        }
        __syncthreads();
        for (int k = ks; k < kn; k += KS) {
          const float4 w =
              *reinterpret_cast<const float4*>(w_s + (k0 + k) * UNITS + ug * UG);
#pragma unroll
          for (int i = 0; i < BT; ++i) {
            const float d = d_s[(bg * BT + i) * KCP + k];
            acc[i][0] = fmaf(d, w.x, acc[i][0]);
            acc[i][1] = fmaf(d, w.y, acc[i][1]);
            acc[i][2] = fmaf(d, w.z, acc[i][2]);
            acc[i][3] = fmaf(d, w.w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BT; ++i) {
        const int b = p0 + bg * BT + i;
        if (b < batch)
#pragma unroll
          for (int j = 0; j < UG; ++j)
            part_s[(ks * batch + b) * UNITS + ug * UG + j] = acc[i][j];
      }
    }
    __syncthreads();
    for (int e = tid; e < batch * UNITS; e += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < KS; ++p) s += part_s[p * batch * UNITS + e];
      dh_s[e] = s;
    }
    __syncthreads();
  }

  for (int e = tid; e < batch * UNITS; e += THREADS) {
    const int b = e / UNITS, u = e % UNITS, unit = u0 + u;
    if (unit >= hdim) continue;
    const size_t ix = dir * bh + static_cast<size_t>(b) * hdim + unit;
    dc0[ix] = from_f32<T>(dc_s[e]);
    dh0[ix] = from_f32<T>(dh_s[e]);
  }
}

template <typename T, bool TANH, int NDIRS>
int launch(const void* d_hs, const void* acts, const void* cs,
           const void* c_prev, const void* wh, void* dxp, void* dc0,
           void* dh0, int n_steps, int batch, int hdim,
           cudaStream_t stream) {
  auto kernel = bilstm_scan_bwd_kernel<T, TANH, NDIRS>;
  const size_t smem = smem_bytes(batch, hdim);
  const dim3 grid((hdim + UNITS - 1) / UNITS, NDIRS);
  const int fit = cooperative_fit(kernel, grid, THREADS, smem);
  if (fit != 0) return fit;  // never degrade: the barrier would hang

  const T* d_hs_ = static_cast<const T*>(d_hs);
  const T* acts_ = static_cast<const T*>(acts);
  const T* cs_ = static_cast<const T*>(cs);
  const T* c_prev_ = static_cast<const T*>(c_prev);
  const T* wh_ = static_cast<const T*>(wh);
  T* dxp_ = static_cast<T*>(dxp);
  T* dc0_ = static_cast<T*>(dc0);
  T* dh0_ = static_cast<T*>(dh0);
  void* args[] = {&d_hs_, &acts_, &cs_,     &c_prev_, &wh_,  &dxp_,
                  &dc0_,  &dh0_,  &n_steps, &batch,   &hdim};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(THREADS), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TANH>
int launch_dirs(const void* d_hs, const void* acts, const void* cs,
                const void* c_prev, const void* wh, void* dxp, void* dc0,
                void* dh0, int n_steps, int batch, int hdim, int n_dirs,
                cudaStream_t stream) {
  return n_dirs == 1
             ? launch<T, TANH, 1>(d_hs, acts, cs, c_prev, wh, dxp, dc0, dh0,
                                  n_steps, batch, hdim, stream)
             : launch<T, TANH, 2>(d_hs, acts, cs, c_prev, wh, dxp, dc0, dh0,
                                  n_steps, batch, hdim, stream);
}

int dispatch(const void* d_hs, const void* acts, const void* cs,
             const void* c_prev, const void* wh, void* dxp, void* dc0,
             void* dh0, int n_steps, int batch, int hdim, int n_dirs,
             int dtype, int tanh_cand, void* stream) {
  if (n_steps <= 0 || batch <= 0 || hdim <= 0 || (dtype != 0 && dtype != 1)
      || (n_dirs != 1 && n_dirs != 2))
    return DANET_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tanh_cand ? launch_dirs<float, true>(d_hs, acts, cs, c_prev, wh,
                                                dxp, dc0, dh0, n_steps, batch,
                                                hdim, n_dirs, s)
                     : launch_dirs<float, false>(d_hs, acts, cs, c_prev, wh,
                                                 dxp, dc0, dh0, n_steps,
                                                 batch, hdim, n_dirs, s);
  return tanh_cand
             ? launch_dirs<__nv_bfloat16, true>(d_hs, acts, cs, c_prev, wh,
                                                dxp, dc0, dh0, n_steps, batch,
                                                hdim, n_dirs, s)
             : launch_dirs<__nv_bfloat16, false>(d_hs, acts, cs, c_prev, wh,
                                                 dxp, dc0, dh0, n_steps,
                                                 batch, hdim, n_dirs, s);
}

}  // namespace

// Kernel 3.  dtype: 0 = float32, 1 = bfloat16 (every tensor of the call).
extern "C" int danet_bilstm_scan_bwd(const void* d_hs, const void* acts,
                                     const void* cs, const void* c_prev,
                                     const void* wh, void* dxp, void* dc0,
                                     void* dh0, int n_steps, int batch,
                                     int hdim, int dtype, int tanh_cand,
                                     void* stream) {
  return dispatch(d_hs, acts, cs, c_prev, wh, dxp, dc0, dh0, n_steps, batch,
                  hdim, 2, dtype, tanh_cand, stream);
}

// Kernel 3 with one direction (the backward of lstm_scan_pallas): d_hs,
// cs, c_prev [T, B, H], acts [T, B, 4H], wh [H, 4H] -> dxp [T, B, 4H],
// dc0/dh0 [B, H].
extern "C" int danet_lstm_scan_bwd(const void* d_hs, const void* acts,
                                   const void* cs, const void* c_prev,
                                   const void* wh, void* dxp, void* dc0,
                                   void* dh0, int n_steps, int batch,
                                   int hdim, int dtype, int tanh_cand,
                                   void* stream) {
  return dispatch(d_hs, acts, cs, c_prev, wh, dxp, dc0, dh0, n_steps, batch,
                  hdim, 1, dtype, tanh_cand, stream);
}
