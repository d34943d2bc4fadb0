// Kernel 4f: the whole time loop of one GRU layer in one cooperative
// launch, lean (inference) and residual-saving (training) as one template.
//
// Replaces danet_tpu/ops/pallas/gru.py::_fwd_call (_fwd_kernel and
// _gru_step; gru_scan_pallas and the forward of its custom VJP).  Per step,
// with the f32 carry c and the storage type dt:
//
//   (r, u) = sigmoid(gx_t + dt(c) @ Wgh)           (f32 accumulate)
//   cand   = tanh(cx_t + dt(c * r) @ Wch)
//   c_t    = c * u + cand * (1 - u)                (f32 carry)
//   cs[t]  = dt(c_t);  SAVE: acts[t] = dt([r | u | cand])
//
// Shapes: gx [T, B, 2H] (r|u), cx [T, B, H], wgh [H, 2H], wch [H, H],
// c0 [B, H] -> cs [T, B, H], acts [T, B, 3H]; cr [B, H] is scratch.
// Storage f32 or bf16, gate math and the carry f32.  The product operands
// are rounded to the storage type as the TPU kernel rounds them: dt(c) is
// cs[t-1] itself (or c0), and dt(c * r) is what the scratch row holds.
//
// What bounds it on this card: as in the LSTM kernels, the dependency of
// each step on the whole previous row, not FLOPs or bytes -- and here each
// step holds two dependent products: no candidate product may start before
// c * r of every unit exists.  Design: the hidden units are split over
// blocks, UNITS = 8 per block (75 blocks at H=600, one wave on 132 SMs).
// A block keeps its columns of Wgh ([H, 2 * UNITS]: its r and u columns)
// and of Wch ([H, UNITS]) resident in shared memory (57.6 KB in f32 at
// H=600), and its units' f32 carry in shared memory.  Each step has two
// phases, each closed by a grid-wide barrier:
//   1. read the full dt(c_{t-1}) row from cs[t-1] (or c0) through L2,
//      compute r and u of the block's units, write dt(c * r) of its units
//      into the scratch row cr;
//   2. read the full cr row through L2, compute cand and c_t of its units,
//      write cs[t] (and acts[t]).
// Both row reads and products go through rowc::contract_row
// (row_contract.cuh): loads issued in batches, a register-tiled product.
#include <cooperative_groups.h>

#include "common.cuh"
#include "row_contract.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int UNITS = 8;  // hidden units per block
constexpr int THREADS = rowc::THREADS;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

size_t smem_bytes(int batch, int hdim) {
  // wg_s [H][2U] + wc_s [H][U] + d_s [PASS][KCP] + part_s + out_s [B][2U]
  // + c_s, r_s, u_s [B][U]
  return sizeof(float) *
         (static_cast<size_t>(hdim) * 3 * UNITS +
          static_cast<size_t>(rowc::PASS) * rowc::KCP +
          rowc::part_floats(batch) + static_cast<size_t>(batch) * 5 * UNITS);
}

template <typename T, bool SAVE>
__global__ void __launch_bounds__(THREADS)
gru_scan_kernel(const T* __restrict__ gx, const T* __restrict__ cx,
                const T* __restrict__ wgh, const T* __restrict__ wch,
                const T* __restrict__ c0, T* cs, T* __restrict__ acts, T* cr,
                int n_steps, int batch, int hdim) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* wg_s = smem;
  float* wc_s = wg_s + static_cast<size_t>(hdim) * 2 * UNITS;
  float* d_s = wc_s + static_cast<size_t>(hdim) * UNITS;
  float* part_s = d_s + static_cast<size_t>(rowc::PASS) * rowc::KCP;
  float* out_s = part_s + rowc::part_floats(batch);
  float* c_s = out_s + static_cast<size_t>(batch) * 2 * UNITS;
  float* r_s = c_s + static_cast<size_t>(batch) * UNITS;
  float* u_s = r_s + static_cast<size_t>(batch) * UNITS;

  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x;
  const int g2 = 2 * hdim;
  const size_t bh = static_cast<size_t>(batch) * hdim;

  // resident slices: wg_s[k][j] = Wgh[k, r col of unit j] (j < U) or
  // Wgh[k, u col of unit j - U]; wc_s[k][j] = Wch[k, u0 + j]
  for (int e = tid; e < hdim * 2 * UNITS; e += THREADS) {
    const int k = e / (2 * UNITS), j = e % (2 * UNITS);
    const int unit = u0 + j % UNITS;
    wg_s[e] = unit < hdim ? to_f32(wgh[static_cast<size_t>(k) * g2 +
                                       (j < UNITS ? 0 : hdim) + unit])
                          : 0.f;
  }
  for (int e = tid; e < hdim * UNITS; e += THREADS) {
    const int k = e / UNITS, unit = u0 + e % UNITS;
    wc_s[e] = unit < hdim ? to_f32(wch[static_cast<size_t>(k) * hdim + unit])
                          : 0.f;
  }
  for (int e = tid; e < batch * UNITS; e += THREADS) {
    const int b = e / UNITS, unit = u0 + e % UNITS;
    c_s[e] = unit < hdim ? to_f32(c0[static_cast<size_t>(b) * hdim + unit])
                         : 0.f;
  }
  // contract_row synchronises the block before it reads w_s

  for (int t = 0; t < n_steps; ++t) {
    // 1. gates of this block's units from dt(c_{t-1})
    const T* cprev = t == 0 ? c0 : cs + static_cast<size_t>(t - 1) * bh;
    rowc::contract_row<2 * UNITS>(cprev, hdim, batch, hdim, wg_s, d_s, part_s,
                                  out_s);
    const T* gx_t = gx + static_cast<size_t>(t) * batch * g2;
    for (int e = tid; e < batch * UNITS; e += THREADS) {
      const int b = e / UNITS, u = e % UNITS, unit = u0 + u;
      if (unit >= hdim) continue;
      const T* g = gx_t + static_cast<size_t>(b) * g2 + unit;
      const float r = sigmoid(to_f32(g[0]) + out_s[b * 2 * UNITS + u]);
      const float ug =
          sigmoid(to_f32(g[hdim]) + out_s[b * 2 * UNITS + UNITS + u]);
      r_s[e] = r;
      u_s[e] = ug;
      cr[static_cast<size_t>(b) * hdim + unit] = from_f32<T>(c_s[e] * r);
    }
    grid.sync();  // c * r of every unit complete (and visible)

    // 2. candidate and new state of this block's units from dt(c * r)
    rowc::contract_row<UNITS>(cr, hdim, batch, hdim, wc_s, d_s, part_s,
                              out_s);
    const size_t h_off = static_cast<size_t>(t) * bh;
    for (int e = tid; e < batch * UNITS; e += THREADS) {
      const int b = e / UNITS, u = e % UNITS, unit = u0 + u;
      if (unit >= hdim) continue;
      const size_t ix = static_cast<size_t>(b) * hdim + unit;
      const float cand = tanhf(to_f32(cx[h_off + ix]) + out_s[e]);
      const float ug = u_s[e];
      const float c = c_s[e] * ug + cand * (1.f - ug);
      c_s[e] = c;
      cs[h_off + ix] = from_f32<T>(c);
      if (SAVE) {
        T* a = acts + static_cast<size_t>(t) * batch * 3 * hdim +
               static_cast<size_t>(b) * 3 * hdim + unit;
        a[0] = from_f32<T>(r_s[e]);
        a[hdim] = from_f32<T>(ug);
        a[2 * hdim] = from_f32<T>(cand);
      }
    }
    grid.sync();  // c_t complete (and visible) before any block reads it
  }
}

template <typename T, bool SAVE>
int launch(const void* gx, const void* cx, const void* wgh, const void* wch,
           const void* c0, void* cs, void* acts, void* cr, int n_steps,
           int batch, int hdim, cudaStream_t stream) {
  auto kernel = gru_scan_kernel<T, SAVE>;
  const size_t smem = smem_bytes(batch, hdim);
  const dim3 grid((hdim + UNITS - 1) / UNITS);
  const int fit = cooperative_fit(kernel, grid, THREADS, smem);
  if (fit != 0) return fit;  // never degrade: the barrier would hang

  const T* gx_ = static_cast<const T*>(gx);
  const T* cx_ = static_cast<const T*>(cx);
  const T* wgh_ = static_cast<const T*>(wgh);
  const T* wch_ = static_cast<const T*>(wch);
  const T* c0_ = static_cast<const T*>(c0);
  T* cs_ = static_cast<T*>(cs);
  T* acts_ = static_cast<T*>(acts);
  T* cr_ = static_cast<T*>(cr);
  void* args[] = {&gx_, &cx_,  &wgh_,    &wch_,  &c0_, &cs_,
                  &acts_, &cr_, &n_steps, &batch, &hdim};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(THREADS), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool SAVE>
int dispatch(const void* gx, const void* cx, const void* wgh,
             const void* wch, const void* c0, void* cs, void* acts, void* cr,
             int n_steps, int batch, int hdim, int dtype, void* stream) {
  if (n_steps <= 0 || batch <= 0 || hdim <= 0 || (dtype != 0 && dtype != 1))
    return DANET_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, SAVE>(gx, cx, wgh, wch, c0, cs, acts, cr, n_steps,
                               batch, hdim, s);
  return launch<__nv_bfloat16, SAVE>(gx, cx, wgh, wch, c0, cs, acts, cr,
                                     n_steps, batch, hdim, s);
}

}  // namespace

// Kernel 4f, lean.  dtype: 0 = float32, 1 = bfloat16 (every tensor of the
// call).  cr [B, H] is scratch in the same dtype.
extern "C" int danet_gru_scan(const void* gx, const void* cx, const void* wgh,
                              const void* wch, const void* c0, void* cs,
                              void* cr, int n_steps, int batch, int hdim,
                              int dtype, void* stream) {
  return dispatch<false>(gx, cx, wgh, wch, c0, cs, nullptr, cr, n_steps,
                         batch, hdim, dtype, stream);
}

// Kernel 4f that also writes acts [T, B, 3H] = [r | u | cand].
extern "C" int danet_gru_scan_train(const void* gx, const void* cx,
                                    const void* wgh, const void* wch,
                                    const void* c0, void* cs, void* acts,
                                    void* cr, int n_steps, int batch,
                                    int hdim, int dtype, void* stream) {
  return dispatch<true>(gx, cx, wgh, wch, c0, cs, acts, cr, n_steps, batch,
                        hdim, dtype, stream);
}
