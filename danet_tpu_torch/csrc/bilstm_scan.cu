// Kernel 2: the BiLSTM forward that also saves the residuals the backward
// (bilstm_scan_bwd.cu) replays, the whole time loop of one layer, both
// directions, in one cooperative launch.
//
// Replaces the forward of danet_tpu/ops/pallas/lstm.py (_fwd_call) with
// save=True and n_dirs=2: bilstm_scan_pallas under its custom VJP.  The
// lean forward (save=False, kernel B) and the saving forward with one
// direction (lstm_scan_pallas) are lstm_scan_lean.cu's.
//
//   act_t  = xp_t + h_{t-1} @ Wh           (f32 accumulate)
//   cand   = tanh(act[0:H]) or act[0:H]     (gate order cand|i|f|o)
//   i,f,o  = sigmoid(act[H:2H]), sigmoid(act[2H:3H]), sigmoid(act[3H:4H])
//   c_t    = i*cand + f*c_{t-1}             (f32 carry)
//   h_t    = o*tanh(c_t), rounded to the storage type before it feeds
//            the next step and is written to hs
//   cs[t] = c_t and acts[t] = [cand, i, f, o], each rounded to the
//          storage type (as the TPU kernel stores its residuals)
//
// Shapes, with D = 2 directions: xp [T, D, B, 4H], wh [D, H, 4H], c0/h0
// [D, B, H] -> hs, cs [T, D, B, H], acts [T, D, B, 4H].  Storage f32 or
// bf16, gate math and the cell carry f32.  Direction 1 sees the
// time-reversed input; the caller reverses in and out.
//
// What bounds it on this card: Wh of one direction is H x 4H (1.44 MB in
// f32 at H=300, 5.76 MB at H=600), far beyond one SM's 227 KB of shared
// memory, and each step depends on the whole h_{t-1}.  Design (the first
// one of the port, which lstm_scan_lean.cu replaced for the lean forward):
// each direction's hidden units are split over blocks, UNITS per block
// (grid.x blocks per direction, grid.y = D; D is also a template
// parameter, so that the direction stride is a constant in the index
// arithmetic: read at run time, it made the kernel 32 % slower at H=300).
// A block keeps its [H, 4*UNITS] column slice of Wh (all four gates of its
// units) in shared memory for the whole run and its units' cell state in
// shared memory.  Each step it reads the full h_{t-1} of its direction
// straight from hs[t-1] (written by the other blocks in the previous step;
// L2-resident, read with ld.global.cg so that no stale L1 line is used),
// computes its units' gates, writes its slice of h_t, c_t and the gates,
// and meets every other block, of both directions, at a grid-wide
// barrier.  So the per-step latency of that barrier and of the element-wise
// h_s staging through L2, not FLOPs or bytes, sets its speed.
//
// UNITS is 16 wherever its shared memory fits (H=300 up to B=68: 19
// blocks per direction), else 8.  An H that is not a multiple of UNITS
// leaves the last block units past H, which are masked (u0 + u < hdim).
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BT = 4;                 // batch rows per register tile

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// UNITS hidden units per block: COLS = 4 * UNITS gate columns, and the
// contraction over H split KSPLIT ways over the thread rows
template <int UNITS>
struct Tile {
  static constexpr int COLS = 4 * UNITS;
  static constexpr int KSPLIT = THREADS / COLS;
  static_assert(KSPLIT * COLS == THREADS, "UNITS must divide 64");
};

template <int UNITS>
size_t smem_bytes(int batch, int hdim) {
  constexpr int COLS = Tile<UNITS>::COLS, KSPLIT = Tile<UNITS>::KSPLIT;
  // w_s [H][COLS] + h_s [B][H] + part_s [KSPLIT][B][COLS] + c_s [B][UNITS]
  return sizeof(float) * (static_cast<size_t>(hdim) * COLS +
                          static_cast<size_t>(batch) * hdim +
                          static_cast<size_t>(KSPLIT) * batch * COLS +
                          static_cast<size_t>(batch) * UNITS);
}

template <typename T, bool TANH, int UNITS, int NDIRS>
__global__ void __launch_bounds__(THREADS)
bilstm_scan_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                   const T* __restrict__ c0, const T* __restrict__ h0,
                   T* hs, T* __restrict__ cs, T* __restrict__ acts,
                   int n_steps, int batch, int hdim) {
  constexpr int COLS = Tile<UNITS>::COLS, KSPLIT = Tile<UNITS>::KSPLIT;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* w_s = smem;
  float* h_s = w_s + static_cast<size_t>(hdim) * COLS;
  float* part_s = h_s + static_cast<size_t>(batch) * hdim;
  float* c_s = part_s + static_cast<size_t>(KSPLIT) * batch * COLS;

  const int dir = blockIdx.y;
  const int u0 = blockIdx.x * UNITS;
  const int g4 = 4 * hdim;
  const int tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(batch) * hdim;

  // resident Wh slice: w_s[k][g*UNITS + u] = wh[dir, k, g*H + u0 + u]
  const T* whd = wh + static_cast<size_t>(dir) * hdim * g4;
  for (int e = tid; e < hdim * COLS; e += THREADS) {
    const int k = e / COLS, j = e % COLS, g = j / UNITS, u = j % UNITS;
    w_s[e] = (u0 + u < hdim)
                 ? to_f32(whd[static_cast<size_t>(k) * g4 + g * hdim + u0 + u])
                 : 0.f;
  }
  for (int e = tid; e < batch * UNITS; e += THREADS) {
    const int b = e / UNITS, u = e % UNITS;
    c_s[e] = (u0 + u < hdim) ? to_f32(c0[dir * bh + b * hdim + u0 + u]) : 0.f;
  }

  const int col = tid % COLS;  // gate column g*UNITS + u of this block
  const int ks = tid / COLS;   // k = ks, ks + KSPLIT, ...
  for (int t = 0; t < n_steps; ++t) {
    const T* hprev =
        (t == 0) ? h0 + dir * bh
                 : hs + (static_cast<size_t>(t - 1) * NDIRS + dir) * bh;
    for (size_t e = tid; e < bh; e += THREADS) h_s[e] = load_cg(hprev + e);
    __syncthreads();

    // partial gate pre-activations over this thread's share of k
    for (int b0 = 0; b0 < batch; b0 += BT) {
      float acc[BT];
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) acc[bb] = 0.f;
      for (int k = ks; k < hdim; k += KSPLIT) {
        const float w = w_s[k * COLS + col];
#pragma unroll
        for (int bb = 0; bb < BT; ++bb)
          if (b0 + bb < batch)
            acc[bb] = fmaf(h_s[(b0 + bb) * hdim + k], w, acc[bb]);
      }
#pragma unroll
      for (int bb = 0; bb < BT; ++bb)
        if (b0 + bb < batch)
          part_s[(ks * batch + b0 + bb) * COLS + col] = acc[bb];
    }
    __syncthreads();

    // cell update for this block's (batch row, unit) pairs
    T* hs_t = hs + (static_cast<size_t>(t) * NDIRS + dir) * bh;
    const size_t x_off = (static_cast<size_t>(t) * NDIRS + dir) * batch * g4;
    const T* xp_t = xp + x_off;
    for (int e = tid; e < batch * UNITS; e += THREADS) {
      const int b = e / UNITS, u = e % UNITS, unit = u0 + u;
      if (unit >= hdim) continue;
      float a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = to_f32(xp_t[static_cast<size_t>(b) * g4 + g * hdim + unit]);
#pragma unroll
        for (int p = 0; p < KSPLIT; ++p)
          s += part_s[(p * batch + b) * COLS + g * UNITS + u];
        a[g] = s;
      }
      const float cand = TANH ? tanhf(a[0]) : a[0];
      const float ig = sigmoid(a[1]), fg = sigmoid(a[2]), og = sigmoid(a[3]);
      const float c = ig * cand + fg * c_s[e];
      c_s[e] = c;
      hs_t[static_cast<size_t>(b) * hdim + unit] = from_f32<T>(og * tanhf(c));
      cs[(static_cast<size_t>(t) * NDIRS + dir) * bh +
         static_cast<size_t>(b) * hdim + unit] = from_f32<T>(c);
      T* act_t = acts + x_off + static_cast<size_t>(b) * g4 + unit;
      act_t[0] = from_f32<T>(cand);
      act_t[hdim] = from_f32<T>(ig);
      act_t[2 * hdim] = from_f32<T>(fg);
      act_t[3 * hdim] = from_f32<T>(og);
    }
    grid.sync();  // h_t complete (and visible) before any block reads it
  }
}

template <typename T, bool TANH, int UNITS, int NDIRS>
int launch(const void* xp, const void* wh, const void* c0, const void* h0,
           void* hs, void* cs, void* acts, int n_steps, int batch, int hdim,
           cudaStream_t stream) {
  auto kernel = bilstm_scan_kernel<T, TANH, UNITS, NDIRS>;
  const size_t smem = smem_bytes<UNITS>(batch, hdim);
  const dim3 grid((hdim + UNITS - 1) / UNITS, NDIRS);
  const int fit = cooperative_fit(kernel, grid, THREADS, smem);
  if (fit != 0) return fit;  // never degrade: the barrier would hang

  const T* xp_ = static_cast<const T*>(xp);
  const T* wh_ = static_cast<const T*>(wh);
  const T* c0_ = static_cast<const T*>(c0);
  const T* h0_ = static_cast<const T*>(h0);
  T* hs_ = static_cast<T*>(hs);
  T* cs_ = static_cast<T*>(cs);
  T* acts_ = static_cast<T*>(acts);
  void* args[] = {&xp_, &wh_, &c0_,    &h0_,   &hs_,
                  &cs_, &acts_, &n_steps, &batch, &hdim};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(THREADS), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// UNITS = 16 where its shared memory fits the device, else 8 (see header)
template <typename T, bool TANH, int NDIRS>
int launch_units(const void* xp, const void* wh, const void* c0,
                 const void* h0, void* hs, void* cs, void* acts, int n_steps,
                 int batch, int hdim, cudaStream_t stream) {
  int optin = 0;
  const int err = smem_optin(&optin);
  if (err != 0) return err;
  if (smem_bytes<16>(batch, hdim) <= static_cast<size_t>(optin))
    return launch<T, TANH, 16, NDIRS>(xp, wh, c0, h0, hs, cs, acts,
                                      n_steps, batch, hdim, stream);
  return launch<T, TANH, 8, NDIRS>(xp, wh, c0, h0, hs, cs, acts, n_steps,
                                   batch, hdim, stream);
}

int dispatch(const void* xp, const void* wh, const void* c0, const void* h0,
             void* hs, void* cs, void* acts, int n_steps, int batch, int hdim,
             int dtype, int tanh_cand, void* stream) {
  if (n_steps <= 0 || batch <= 0 || hdim <= 0 || (dtype != 0 && dtype != 1))
    return DANET_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tanh_cand ? launch_units<float, true, 2>(
                           xp, wh, c0, h0, hs, cs, acts, n_steps, batch,
                           hdim, s)
                     : launch_units<float, false, 2>(
                           xp, wh, c0, h0, hs, cs, acts, n_steps, batch,
                           hdim, s);
  return tanh_cand ? launch_units<__nv_bfloat16, true, 2>(
                         xp, wh, c0, h0, hs, cs, acts, n_steps, batch, hdim,
                         s)
                   : launch_units<__nv_bfloat16, false, 2>(
                         xp, wh, c0, h0, hs, cs, acts, n_steps, batch, hdim,
                         s);
}

}  // namespace

// Kernel 2.  dtype: 0 = float32, 1 = bfloat16 (every tensor of the call).
// Writes hs, cs [T, 2, B, H] and acts [T, 2, B, 4H].
extern "C" int danet_bilstm_scan_train(const void* xp, const void* wh,
                                       const void* c0, const void* h0,
                                       void* hs, void* cs, void* acts,
                                       int n_steps, int batch, int hdim,
                                       int dtype, int tanh_cand,
                                       void* stream) {
  return dispatch(xp, wh, c0, h0, hs, cs, acts, n_steps, batch, hdim, dtype,
                  tanh_cand, stream);
}
