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
// the JAX package.  The reads of acts, cs, c_prev and d_hs run in reverse
// time by index; no reversed copy is made.
//
// What bounds it on this card: each step depends on the whole previous
// dxp row of its direction, so a step costs one grid-wide barrier, the cell
// backward, and the time each block takes to read that row back through
// L2 and contract it against its rows of Wh; FLOPs and device-memory bytes
// are far below these.  The row is [B, 4H]: 307 KB per block and step at
// H=600, B=32 in f32 (75 blocks: 23 MB of L2 reads per step), 154 KB at
// H=300 (D=2).  On an H100 at H=600, B=32, f32, 10.7 us per step split
// into about 3.4 us of barrier, cell backward and reduction, 4.1 us of
// FMAs and 3.7 us of staging, which overlap by only 0.5 us (each part
// timed with the other cut from the source: perf_probe.py scan-bwd --cut).
//
// Tiling.  Each direction's hidden units are split over blocks, UNITS = 8
// per block: 75 blocks at H=600 (D=1), 38 x 2 = 76 at H=300 (D=2), whose
// last block holds 4 live units (every load and store of a unit past H is
// masked).  A block keeps its Wh rows, [UNITS, 4H] (76.8 KB in f32 at
// H=600), resident in shared memory as two planes of 4 units, so that a
// warp's 16-byte reads of consecutive columns hit distinct banks.  256
// threads = 8 warps: warp (bg, kw) owns the BT = 8 batch rows bg * 8 .. of
// each pass of PASS = 32 rows, all 8 units, and half the columns (KW = 2
// contiguous shares, each starting 16-byte aligned), spread over its 32
// lanes, so that each shared-memory read of the row or of Wh feeds 8 FMAs
// and no other warp reads the rows it stages.  The lanes' 64 partial sums
// are reduced in registers by a 5-step shuffle reduce-scatter (31 + 31
// shuffles); the KW shares meet in red_s, added where the next step reads
// them.  (UNITS = 16, 38 blocks with D=2, was slower in an earlier,
// block-wide staging design.)
//
// Staging.  Each warp stages its own rows and columns of the row, in
// chunks of BT rows x KC = 256 columns, through its own ring of
// RING_BYTES = 16 KB: 2 chunk buffers in f32, 4 in bf16 (rows stay bf16 and
// are converted in the FMA loop).  cp.async.cg 16-byte copies fill the
// buffer the previous chunk freed while the warp contracts the current
// one; the warp waits for its own copies (cp.async.wait_group) and
// synchronises with __syncwarp only, never with the block.  Where 4H is
// not a multiple of 16 bytes' worth of elements (bf16 with odd H), the
// copies would be misaligned, and a chunk is copied with ld.global.cg
// loads instead, synchronously.  The residuals of step t-1 (acts x4, cs,
// c_prev, d_hs) do not depend on the recurrence: each thread loads those of
// its first MAXE (row, unit) pairs into registers right after step t's
// barrier, so that they arrive while step t contracts (pairs past
// MAXE x 256, B > 64, load in place).
//
// Shared memory: w_s [2][4H][4] f32, 8 rings of 16 KB, dc_s [B][UNITS] and
// red_s [KW][B][UNITS] f32: 96 bytes per batch row, so only the carries
// grow with B.  At H=600, D=1: 207.9 KB + 96 B per row, within the 227 KB
// opt-in up to B=256; at H=300, D=2: 169.5 KB + 96 B, up to B=656; at
// H=128, 144 KB + 96 B, up to B=885, and at H=256, 160 KB + 96 B, up to
// B=714; either dtype and direction count (danet_lstm_scan_bwd_max_rows;
// the wrapper splits a larger batch into launches of at most that many
// rows).  A
// launch that does not fit returns DANET_SMEM_TOO_LARGE or
// DANET_NOT_RESIDENT through cooperative_fit and never degrades.
//
// Memory ordering.  Every block writes its gate columns of dxp[t] with
// plain stores before grid.sync(), whose fence orders them (device scope)
// before any block passes the barrier.  A copy of the row is issued only
// after the barrier, in program order, and cp.async.cg reads through L2,
// the point of coherence, never through the SM's L1, where a line could be
// stale (a line of dxp[t+1] read in the previous step may hold the edge of
// dxp[t]): so it sees the row.  cp.async is a generic-proxy operation, so
// no proxy fence is needed, unlike a TMA bulk copy.  A lane's
// cp_async_wait and the __syncwarp after it make a chunk visible to every
// lane of the warp before any reads it, and the __syncwarp at the top of
// each chunk orders the lanes' reads of a buffer before its refill.  dxp[t]
// is not written again in the launch, and a ring is idle across the
// block barrier that ends each step and the grid.sync() that follows.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNITS = 8;        // hidden units per block (see header)
constexpr int BT = 8;           // batch rows per warp tile
constexpr int BG = 4;           // row tiles per pass
constexpr int KW = WARPS / BG;  // warps splitting the columns of a tile
constexpr int PASS = BG * BT;   // batch rows per pass
constexpr int KC = 256;         // row columns per staged chunk
constexpr int RING_BYTES = 16384;  // each warp's ring of chunk buffers
constexpr int MAXE = 2;         // (row, unit) pairs prefetched per thread

size_t smem_bytes(int batch, int hdim) {
  // w_s [2][4H][4] f32 + rings [WARPS][RING_BYTES] + dc_s [B][UNITS]
  // + red_s [KW][B][UNITS] f32
  return sizeof(float) * static_cast<size_t>(4) * hdim * UNITS +
         static_cast<size_t>(WARPS) * RING_BYTES +
         sizeof(float) * static_cast<size_t>(1 + KW) * batch * UNITS;
}

// one (row, unit) pair's residuals: cand, i, f, o, c_t, d_hs, c_{t-1}
template <typename T>
__device__ __forceinline__ void load_residuals(
    float (&r)[7], const T* __restrict__ d_hs, const T* __restrict__ acts,
    const T* __restrict__ cs, const T* __restrict__ c_prev, size_t hix,
    size_t gix, int hdim) {
  r[0] = to_f32(acts[gix]);
  r[1] = to_f32(acts[gix + hdim]);
  r[2] = to_f32(acts[gix + 2 * hdim]);
  r[3] = to_f32(acts[gix + 3 * hdim]);
  r[4] = to_f32(cs[hix]);
  r[5] = to_f32(d_hs[hix]);
  r[6] = to_f32(c_prev[hix]);
}

// the cell backward of one (row, unit) pair: updates dc, writes its four
// gate columns of dxp[t]
template <typename T, bool TANH>
__device__ __forceinline__ void cell_bwd(const float (&r)[7], float dh_carry,
                                         float& dc_s, T* dx, int hdim) {
  const float cand = r[0], ig = r[1], fg = r[2], og = r[3];
  const float tanh_c = tanhf(r[4]);
  const float dh = r[5] + dh_carry;
  const float do_pre = dh * tanh_c * og * (1.f - og);
  const float dc = dc_s + dh * og * (1.f - tanh_c * tanh_c);
  const float dcand = dc * ig;
  const float dcand_pre = TANH ? dcand * (1.f - cand * cand) : dcand;
  const float di_pre = dc * cand * ig * (1.f - ig);
  const float df_pre = dc * r[6] * fg * (1.f - fg);
  dc_s = dc * fg;
  dx[0] = from_f32<T>(dcand_pre);
  dx[hdim] = from_f32<T>(di_pre);
  dx[2 * hdim] = from_f32<T>(df_pre);
  dx[3 * hdim] = from_f32<T>(do_pre);
}

// One step of the reduce-scatter of v[0..N) over the lanes: lanes that
// differ in bit M exchange halves; each keeps the half its bit M selects,
// summed.  After N = 64 .. 4 (M = 16 .. 1) lane l holds the full sums of
// elements 2l and 2l + 1 in v[0], v[1].
template <int N, int M>
__device__ __forceinline__ void reduce_half(float* v, int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const float send = up ? v[e] : v[e + N / 2];
    const float keep = up ? v[e + N / 2] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// acc[i * UNITS + u] += d[i][k] * Wh[u][k0 + k] over the columns k = lane,
// lane + 32, ... of a chunk (FULL: all KC of them, fully unrolled), with
// the two planes w0, w1 of Wh from column k0
template <bool FULL, typename T>
__device__ __forceinline__ void fma_cols(float* acc, const T* d,
                                         const float* w0, const float* w1,
                                         int lane, int kn) {
#pragma unroll
  for (int m = 0; m < KC / 32; ++m) {
    const int k = lane + 32 * m;
    if (!FULL && k >= kn) break;
    const float4 a = *reinterpret_cast<const float4*>(w0 + k * 4);
    const float4 z = *reinterpret_cast<const float4*>(w1 + k * 4);
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const float v = to_f32(d[i * KC + k]);
      float* o = acc + i * UNITS;
      o[0] = fmaf(v, a.x, o[0]);
      o[1] = fmaf(v, a.y, o[1]);
      o[2] = fmaf(v, a.z, o[2]);
      o[3] = fmaf(v, a.w, o[3]);
      o[4] = fmaf(v, z.x, o[4]);
      o[5] = fmaf(v, z.y, o[5]);
      o[6] = fmaf(v, z.z, o[6]);
      o[7] = fmaf(v, z.w, o[7]);
    }
  }
}

template <typename T, bool TANH, int NDIRS>
__global__ void __launch_bounds__(THREADS)
bilstm_scan_bwd_kernel(const T* __restrict__ d_hs, const T* __restrict__ acts,
                       const T* __restrict__ cs, const T* __restrict__ c_prev,
                       const T* __restrict__ wh, T* dxp, T* __restrict__ dc0,
                       T* __restrict__ dh0, int n_steps, int batch,
                       int hdim) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  // chunk buffers in a warp's ring: 2 in f32, 4 in bf16
  constexpr int NBUF = RING_BYTES / (BT * KC * static_cast<int>(sizeof(T)));
  constexpr int VPR = KC / VEC;
  static_assert((VPR & (VPR - 1)) == 0, "KC / VEC must be a power of 2");
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int g4 = 4 * hdim;
  const int n_el = batch * UNITS;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  float* w_s = smem;
  char* rings =
      reinterpret_cast<char*>(w_s + static_cast<size_t>(g4) * UNITS);
  T* ring = reinterpret_cast<T*>(rings + warp * RING_BYTES);  // this warp's
  float* dc_s = reinterpret_cast<float*>(rings + WARPS * RING_BYTES);
  float* red_s = dc_s + n_el;  // dh_carry in KW parts, [KW][B][UNITS]

  const int dir = blockIdx.y;
  const int u0 = blockIdx.x * UNITS;
  const int bg = warp % BG, kw = warp / BG;
  const size_t bh = static_cast<size_t>(batch) * hdim;
  const size_t bg4 = static_cast<size_t>(batch) * g4;

  // resident Wh rows, planes of 4 units: w_s[(u / 4) * 4H * 4 + g * 4 +
  // u % 4] = wh[dir, u0 + u, g] (coalesced over g)
  const T* whd = wh + static_cast<size_t>(dir) * hdim * g4;
  for (int e = tid; e < UNITS * g4; e += THREADS) {
    const int u = e / g4, g = e % g4;
    w_s[(static_cast<size_t>(u / 4) * g4 + g) * 4 + u % 4] =
        (u0 + u < hdim) ? to_f32(whd[static_cast<size_t>(u0 + u) * g4 + g])
                        : 0.f;
  }
  for (int e = tid; e < n_el; e += THREADS) dc_s[e] = 0.f;
  for (int e = tid; e < KW * n_el; e += THREADS) red_s[e] = 0.f;

  // this warp's chunks of a step: in each pass with live rows in its tile
  // (rows p * PASS + bg * BT ..), its share of the columns, [c_beg, c_end)
  // (the KW shares start 16-byte aligned), in chunks of KC
  const bool vec_ok = g4 % VEC == 0;  // every row and share 16-byte aligned
  const int share = ((g4 + KW - 1) / KW + VEC - 1) / VEC * VEC;
  const int c_beg = min(g4, kw * share), c_end = min(g4, c_beg + share);
  const int per_pass = (c_end - c_beg + KC - 1) / KC;
  const int n_w = max(0, (batch - bg * BT + PASS - 1) / PASS) * per_pass;

  // the residuals of this thread's first MAXE (row, unit) pairs at step t
  float res[MAXE][7];
  auto prefetch = [&](int t) {
    const size_t td = static_cast<size_t>(t) * NDIRS + dir;
#pragma unroll
    for (int r = 0; r < MAXE; ++r) {
      const int e = tid + r * THREADS, b = e / UNITS, unit = u0 + e % UNITS;
      if (e < n_el && unit < hdim)
        load_residuals(res[r], d_hs, acts, cs, c_prev,
                       td * bh + static_cast<size_t>(b) * hdim + unit,
                       td * bg4 + static_cast<size_t>(b) * g4 + unit, hdim);
    }
  };
  prefetch(n_steps - 1);
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t td = static_cast<size_t>(t) * NDIRS + dir;

    // 1. cell backward of this block's (row, unit) pairs
#pragma unroll
    for (int r = 0; r < MAXE; ++r) {
      const int e = tid + r * THREADS, b = e / UNITS, unit = u0 + e % UNITS;
      if (e < n_el && unit < hdim) {
        float dh = 0.f;
#pragma unroll
        for (int p = 0; p < KW; ++p) dh += red_s[p * n_el + e];
        cell_bwd<T, TANH>(res[r], dh, dc_s[e],
                          dxp + td * bg4 + static_cast<size_t>(b) * g4 + unit,
                          hdim);
      }
    }
    for (int e = tid + MAXE * THREADS; e < n_el; e += THREADS) {
      const int b = e / UNITS, unit = u0 + e % UNITS;
      if (unit >= hdim) continue;
      const size_t hix = td * bh + static_cast<size_t>(b) * hdim + unit;
      const size_t gix = td * bg4 + static_cast<size_t>(b) * g4 + unit;
      float r[7];
      load_residuals(r, d_hs, acts, cs, c_prev, hix, gix, hdim);
      float dh = 0.f;
#pragma unroll
      for (int p = 0; p < KW; ++p) dh += red_s[p * n_el + e];
      cell_bwd<T, TANH>(r, dh, dc_s[e], dxp + gix, hdim);
    }
    grid.sync();  // dxp[t] complete (and visible) before any block reads it

    // 2. the residuals of step t-1 arrive while this step contracts
    if (t > 0) prefetch(t - 1);

    // 3. dh_carry[b, u] = sum_g dxp[t][b, g] * Wh[u0 + u, g]: each warp
    // stages and contracts its own rows and columns, chunk j = (pass
    // j / per_pass, columns c_beg + j % per_pass * KC ..)
    const T* dx_t = dxp + td * bg4;
    auto issue = [&](int j) {
      if (j >= n_w) return;
      const int r0 = j / per_pass * PASS + bg * BT;
      const int k0 = c_beg + j % per_pass * KC;
      const int rows = min(BT, batch - r0), kn = min(KC, c_end - k0);
      T* dst = ring + (j % NBUF) * BT * KC;
      const T* src = dx_t + static_cast<size_t>(r0) * g4 + k0;
      if (vec_ok) {
        // VPR 16-byte vectors per chunk row, a power of 2: no division
#pragma unroll
        for (int v = lane; v < BT * VPR; v += 32) {
          const int r = v / VPR, k = v % VPR * VEC;
          if (r < rows && k < kn)
            cp_async16(dst + r * KC + k, src + static_cast<size_t>(r) * g4 + k);
        }
      } else {
        for (int e = lane; e < rows * kn; e += 32) {
          const int r = e / kn, k = e % kn;
          dst[r * KC + k] =
              from_f32<T>(load_cg(src + static_cast<size_t>(r) * g4 + k));
        }
      }
    };
#pragma unroll
    for (int s = 0; s < NBUF - 1; ++s) {
      issue(s);
      cp_async_commit();
    }
    float acc[BT * UNITS];
    for (int j = 0; j < n_w; ++j) {
      cp_async_wait<NBUF - 2>();
      __syncwarp();  // chunk j landed; buffer (j - 1) % NBUF is free
      issue(j + NBUF - 1);
      cp_async_commit();

      const int jc = j % per_pass;
      const int r0 = j / per_pass * PASS + bg * BT;
      const int k0 = c_beg + jc * KC, kn = min(KC, c_end - k0);
      if (jc == 0) {
#pragma unroll
        for (int e = 0; e < BT * UNITS; ++e) acc[e] = 0.f;
      }
      // rows past B in a ragged tile hold stale values: their sums are
      // never stored
      const T* d = ring + (j % NBUF) * BT * KC;
      const float* w0 = w_s + static_cast<size_t>(k0) * 4;
      const float* w1 = w0 + static_cast<size_t>(g4) * 4;
      if (kn == KC)
        fma_cols<true>(acc, d, w0, w1, lane, kn);
      else
        fma_cols<false>(acc, d, w0, w1, lane, kn);
      if (jc == per_pass - 1) {
        // element (i, u) = i * UNITS + u; lane l ends with 2l and 2l + 1
        reduce_half<64, 16>(acc, lane);
        reduce_half<32, 8>(acc, lane);
        reduce_half<16, 4>(acc, lane);
        reduce_half<8, 2>(acc, lane);
        reduce_half<4, 1>(acc, lane);
        const int i = lane / 4, u = lane % 4 * 2;
        if (r0 + i < batch) {
          float* out = red_s + (static_cast<size_t>(kw) * batch + r0 + i) *
                                   UNITS + u;
          out[0] = acc[0];
          out[1] = acc[1];
        }
      }
    }
    __syncthreads();  // red_s complete before the next step reads it
  }

  for (int e = tid; e < n_el; e += THREADS) {
    const int b = e / UNITS, unit = u0 + e % UNITS;
    if (unit >= hdim) continue;
    float dh = 0.f;
#pragma unroll
    for (int p = 0; p < KW; ++p) dh += red_s[p * n_el + e];
    const size_t ix = dir * bh + static_cast<size_t>(b) * hdim + unit;
    dc0[ix] = from_f32<T>(dc_s[e]);
    dh0[ix] = from_f32<T>(dh);
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

// The row ceiling of one backward launch at H = hdim (either dtype and
// direction count): the largest batch whose shared memory fits the
// device's opt-in, written to *rows.
extern "C" int danet_lstm_scan_bwd_max_rows(int hdim, int* rows) {
  if (hdim <= 0 || rows == nullptr) return DANET_BAD_ARGUMENT;
  return max_rows_fitting([=](int b) { return smem_bytes(b, hdim); }, rows);
}
