// Kernel 4b: the backward of one GRU layer, the whole reverse time loop in
// one cooperative launch.
//
// Replaces danet_tpu/ops/pallas/gru.py::_bwd_call (_bwd_kernel and
// _gru_bwd_step).  For t = T-1 down to 0, in f32, with the residuals
// [r | u | cand] = acts[t], c_prev = c_prev[t] and the storage type dt:
//
//   dc_total = d_cs[t] + dc
//   du_pre   = dc_total * (c_prev - cand) * u * (1 - u)
//   dcx[t]   = dt(dc_total * (1 - u) * (1 - cand^2))     (dcand_pre)
//   dcr      = dcx[t] @ Wch^T          (from the ROUNDED dcx[t], as JAX)
//   dr_pre   = dcr * c_prev * r * (1 - r)
//   dgx[t]   = dt([dr_pre | du_pre])
//   dc       = dc_total * u + dcr * r + dgx[t] @ Wgh^T   (rounded dgx[t])
//
// and after step 0: dc0 = dt(dc).  Shapes: d_cs, c_prev [T, B, H], acts
// [T, B, 3H], wgh [H, 2H], wch [H, H] -> dgx [T, B, 2H], dcx [T, B, H],
// dc0 [B, H]; storage f32 or bf16.  dWgh = sum_t c_prev^T dgx[t] and
// dWch = sum_t dt(c_prev * r)^T dcx[t] have no sequential dependency and
// are bulk matmuls outside the kernel, as in the JAX package.
//
// What bounds it on this card: the two dependent row products of each
// step, each behind a grid-wide barrier, not FLOPs.  Design: the hidden
// units are split over blocks, UNITS = 8 per block (75 blocks at H=600).  A
// block owns the dc carry of its units for every batch row (shared memory)
// and keeps its rows of Wch ([UNITS, H]) and of Wgh ([UNITS, 2H]) resident,
// stored transposed ([H][UNITS], [2H][UNITS]; 57.6 KB in f32 at H=600).
// Each step has three stages:
//   (a) the cell backward of its units; writes its columns of dcx[t] and
//       the du half of dgx[t]; barrier;
//   (b) reads the whole dcx[t] row through L2, dcr of its units; writes
//       the dr half of dgx[t]; barrier;
//   (c) reads the whole dgx[t] row through L2 and finishes dc of its
//       units, which stage (a) of step t-1 uses with no further barrier.
// The row reads and products go through rowc::contract_row
// (row_contract.cuh): loads issued in batches of 16 independent loads per
// thread, not a dependent chain (PERF.md found that chain to cost the LSTM
// backward most of its step), and a register-tiled product.
#include <cooperative_groups.h>

#include "common.cuh"
#include "row_contract.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int UNITS = 8;  // hidden units per block
constexpr int THREADS = rowc::THREADS;

size_t smem_bytes(int batch, int hdim) {
  // wc_s [H][U] + wg_s [2H][U] + d_s [PASS][KCP] + part_s + out_s, dc_s,
  // r_s, cp_s [B][U]
  return sizeof(float) *
         (static_cast<size_t>(hdim) * 3 * UNITS +
          static_cast<size_t>(rowc::PASS) * rowc::KCP +
          rowc::part_floats(batch) + static_cast<size_t>(batch) * 4 * UNITS);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gru_scan_bwd_kernel(const T* __restrict__ d_cs, const T* __restrict__ acts,
                    const T* __restrict__ c_prev, const T* __restrict__ wgh,
                    const T* __restrict__ wch, T* dgx, T* dcx,
                    T* __restrict__ dc0, int n_steps, int batch, int hdim) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* wc_s = smem;
  float* wg_s = wc_s + static_cast<size_t>(hdim) * UNITS;
  float* d_s = wg_s + static_cast<size_t>(hdim) * 2 * UNITS;
  float* part_s = d_s + static_cast<size_t>(rowc::PASS) * rowc::KCP;
  float* out_s = part_s + rowc::part_floats(batch);
  float* dc_s = out_s + static_cast<size_t>(batch) * UNITS;
  float* r_s = dc_s + static_cast<size_t>(batch) * UNITS;
  float* cp_s = r_s + static_cast<size_t>(batch) * UNITS;

  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x;
  const int g2 = 2 * hdim, g3 = 3 * hdim;
  const size_t bh = static_cast<size_t>(batch) * hdim;

  // resident rows, transposed: wc_s[j][u] = Wch[u0 + u, j],
  // wg_s[g][u] = Wgh[u0 + u, g] (reads coalesced over j and g)
  for (int e = tid; e < UNITS * hdim; e += THREADS) {
    const int u = e / hdim, j = e % hdim;
    wc_s[j * UNITS + u] =
        u0 + u < hdim ? to_f32(wch[static_cast<size_t>(u0 + u) * hdim + j])
                      : 0.f;
  }
  for (int e = tid; e < UNITS * g2; e += THREADS) {
    const int u = e / g2, g = e % g2;
    wg_s[g * UNITS + u] =
        u0 + u < hdim ? to_f32(wgh[static_cast<size_t>(u0 + u) * g2 + g])
                      : 0.f;
  }
  for (int e = tid; e < batch * UNITS; e += THREADS) dc_s[e] = 0.f;
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t h_off = static_cast<size_t>(t) * bh;
    T* dcx_t = dcx + h_off;
    T* dgx_t = dgx + static_cast<size_t>(t) * batch * g2;

    // (a) cell backward of this block's (batch row, unit) pairs
    for (int e = tid; e < batch * UNITS; e += THREADS) {
      const int b = e / UNITS, unit = u0 + e % UNITS;
      if (unit >= hdim) continue;
      const size_t ix = static_cast<size_t>(b) * hdim + unit;
      const T* a = acts + static_cast<size_t>(t) * batch * g3 +
                   static_cast<size_t>(b) * g3 + unit;
      const float r = to_f32(a[0]), ug = to_f32(a[hdim]);
      const float cand = to_f32(a[2 * hdim]);
      const float cp = to_f32(c_prev[h_off + ix]);
      const float dct = to_f32(d_cs[h_off + ix]) + dc_s[e];
      const float du_pre = dct * (cp - cand) * ug * (1.f - ug);
      const float dcand_pre = dct * (1.f - ug) * (1.f - cand * cand);
      dcx_t[ix] = from_f32<T>(dcand_pre);
      dgx_t[static_cast<size_t>(b) * g2 + hdim + unit] = from_f32<T>(du_pre);
      dc_s[e] = dct * ug;
      r_s[e] = r;
      cp_s[e] = cp;
    }
    grid.sync();  // dcx[t] complete (and visible)

    // (b) dcr = dcx[t] @ Wch^T for this block's units; the dr half of dgx
    rowc::contract_row<UNITS>(dcx_t, hdim, batch, hdim, wc_s, d_s, part_s,
                              out_s);
    for (int e = tid; e < batch * UNITS; e += THREADS) {
      const int b = e / UNITS, unit = u0 + e % UNITS;
      if (unit >= hdim) continue;
      const float dcr = out_s[e], r = r_s[e];
      dgx_t[static_cast<size_t>(b) * g2 + unit] =
          from_f32<T>(dcr * cp_s[e] * r * (1.f - r));
      dc_s[e] += dcr * r;
    }
    grid.sync();  // dgx[t] complete (and visible)

    // (c) dc += dgx[t] @ Wgh^T for this block's units
    rowc::contract_row<UNITS>(dgx_t, g2, batch, g2, wg_s, d_s, part_s,
                              out_s);
    for (int e = tid; e < batch * UNITS; e += THREADS) dc_s[e] += out_s[e];
    // stage (a) of step t-1 reads only this block's dc_s: a block barrier
    // is enough
    __syncthreads();
  }

  for (int e = tid; e < batch * UNITS; e += THREADS) {
    const int b = e / UNITS, unit = u0 + e % UNITS;
    if (unit < hdim)
      dc0[static_cast<size_t>(b) * hdim + unit] = from_f32<T>(dc_s[e]);
  }
}

template <typename T>
int launch(const void* d_cs, const void* acts, const void* c_prev,
           const void* wgh, const void* wch, void* dgx, void* dcx, void* dc0,
           int n_steps, int batch, int hdim, cudaStream_t stream) {
  auto kernel = gru_scan_bwd_kernel<T>;
  const size_t smem = smem_bytes(batch, hdim);
  const dim3 grid((hdim + UNITS - 1) / UNITS);
  const int fit = cooperative_fit(kernel, grid, THREADS, smem);
  if (fit != 0) return fit;  // never degrade: the barrier would hang

  const T* d_cs_ = static_cast<const T*>(d_cs);
  const T* acts_ = static_cast<const T*>(acts);
  const T* c_prev_ = static_cast<const T*>(c_prev);
  const T* wgh_ = static_cast<const T*>(wgh);
  const T* wch_ = static_cast<const T*>(wch);
  T* dgx_ = static_cast<T*>(dgx);
  T* dcx_ = static_cast<T*>(dcx);
  T* dc0_ = static_cast<T*>(dc0);
  void* args[] = {&d_cs_, &acts_, &c_prev_, &wgh_,  &wch_, &dgx_,
                  &dcx_,  &dc0_,  &n_steps, &batch, &hdim};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(THREADS), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel 4b.  dtype: 0 = float32, 1 = bfloat16 (every tensor of the call).
extern "C" int danet_gru_scan_bwd(const void* d_cs, const void* acts,
                                  const void* c_prev, const void* wgh,
                                  const void* wch, void* dgx, void* dcx,
                                  void* dc0, int n_steps, int batch, int hdim,
                                  int dtype, void* stream) {
  if (n_steps <= 0 || batch <= 0 || hdim <= 0 || (dtype != 0 && dtype != 1))
    return DANET_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(d_cs, acts, c_prev, wgh, wch, dgx, dcx, dc0, n_steps,
                         batch, hdim, s);
  return launch<__nv_bfloat16>(d_cs, acts, c_prev, wgh, wch, dgx, dcx, dc0,
                               n_steps, batch, hdim, s);
}
