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
// c0 [B, H] -> cs [T, B, H], acts [T, B, 3H]; xch [2, B, H] of 8-byte
// words is scratch for the exchange (below).  Storage f32 or bf16, gate
// math and the carry f32.  The product operands are rounded to the storage
// type as the TPU kernel rounds them: dt(c) and dt(c * r).
//
// What bounds it on this card: as in the LSTM kernels, the dependency of
// each step on the whole previous row, not FLOPs or bytes -- and here each
// step holds two dependent products: no candidate product may start before
// c * r of every unit exists.  So a step is two exchanges of a [B, H] row
// between all blocks, and the design spends one L2 round trip on each at
// B=1, two at larger B, and no grid barrier.
//
// Tiling.  The hidden units are split over blocks, UNITS = 8 per block (75
// blocks at H=600, 38 at H=300, whose last block has 4 live units: every
// load and store of a unit past H is masked).  A block keeps its columns
// of Wgh (its r and u columns, 16) and of Wch (8) resident in shared
// memory as planes of 4 columns ([plane][H][4] f32, 57.6 KB at H=600), and
// its units' f32 carry, r and u in shared memory.
//
// Exchange (helpers in exchange.cuh), two protocols chosen by the batch
// (the same in every block):
//   * B = 1 (a single request; TAGGED_MAX_B): tagged words.  Each phase
//     publishes its row as the value (float32 bits of dt(c_t) or
//     dt(c_t * r_t)) and the step t in one aligned 8-byte word, one
//     st.relaxed.gpu.b64 (single-copy atomic: value and tag arrive
//     together), into xch[0] (c) or xch[1] (c * r).  A reader polls each
//     word it needs with ld.relaxed.gpu.b64 (coherent at gpu scope, never a
//     stale L1 line), LOADS words in flight per thread, until it carries
//     tag t: the data's arrival is the synchronisation, one round trip.
//     cp.async is not used here: PTX does not make each 8-byte word of a
//     16-byte copy single-copy atomic.
//   * B > 1: the words double the bytes each SM must read (154 KB per
//     phase at B=32, f32), and the polls of many words wait longer than a
//     flag and a copy: on an H100 at H=600, tagged words win only at B=1
//     (perf_probe.py gru-fwd --set TAGGED_MAX_B=64 against =0, by batch;
//     PERF.md).  So the rows are plain values of the storage type -- the c row is cs[t-1] itself, the c * r
//     row xch's first B H values -- and each block publishes one flag per
//     row (xch[1] as int: [2][blocks]) after its values: block barrier,
//     then one thread __threadfence() and stores the step, as cooperative
//     groups' grid barrier does.  A reader's threads poll the flags
//     (ld.acquire.gpu), pass a block barrier, then copy the whole row with
//     16-byte cp.async.cg (through L2, all in flight at once; element loads
//     where the row is not 16-byte aligned).
// The block clears the tags (or flags) and passes one grid.sync() before
// step 0; c0 is read as it is.  Polling needs every block resident: the
// launch stays cooperative and cooperative_fit refuses a grid that does
// not fit.  A word or flag that does not arrive within 2^24 polls traps (a
// launch failure the caller sees) rather than hanging the card.
//
// Why one buffer per row is enough.  Block X overwrites its slot of the c
// row (or its flag) for step t+1 only after it has read the whole c * r
// row of step t+1; every block Y publishes its c * r values of step t+1
// only after its step t+1 has read the whole c row of step t (its loads
// returned before the product that the c * r values depend on).  So no
// block can still be reading step t's c row when any slot holds step t+1,
// and the same argument with the phases swapped covers the c * r row.  No
// reader ever sees a tag two steps ahead of the one it waits for.
//
// Product.  The staged row d_s [PASS][H] (storage type) times the block's
// C columns (16 in phase 1, 8 in phase 2): a thread holds a register tile
// of BT = 8 rows x 4 columns over a strided share of k; the lanes of a
// column group split k, and so do the KW warps on one row tile: 8 at
// B <= 8 (all warps on one row tile: 9 k per thread at H=600, C=16), 2 at
// B=32.  The partial sums of each residue class of k meet in red_s and
// are added in the order of the class, not by a shuffle tree: at B=32
// (KW=2) the classes, and so every rounding, are those of the earlier
// design (k mod 16, then mod 32), whose training step the port's card-
// vs-CPU gradient checks hold to 1e-4 of each tensor's peak; a shuffle
// tree's other roundings took one gru-v1 gradient to 1.01e-4 of its peak
// (the earlier design's worst was 0.92e-4).  The gate inputs gx_t and
// cx_t of each thread's first (row, unit) pair are loaded at the top of
// step t, before the first poll, so they arrive during the wait.  Batches
// beyond PASS = 32 rows take more passes of the same.
//
// Shared memory: 24 H floats of weights, 32 H values of the staged row (in
// the storage type), 33.3 KB of partial sums and 160 bytes per batch row:
// 167.7 KB at H=600 in f32 (129.3 KB in bf16) + 160 B per row, within the
// 227 KB opt-in up to B=404 (f32) or 644 (bf16) at H=600.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNITS = 8;       // hidden units per block
constexpr int CG = 4;          // product columns per thread (one plane)
constexpr int BT = 8;          // batch rows per thread tile
constexpr int PASS = 4 * BT;   // batch rows per pass
constexpr int LOADS = 8;       // independent polls in flight per thread
constexpr int TAGGED_MAX_B = 1;  // largest batch that exchanges tagged words
// red_s: KW LK residue classes x (8 / KW) BT rows x C = 128 / LK columns,
// WARPS BT 32 CG sums in every layout, + 1 float for each of <= 128 classes
constexpr int RED_FLOATS = WARPS * BT * 32 * CG + 128;

#include "exchange.cuh"

template <typename T>
size_t smem_bytes(int batch, int hdim) {
  // wg_s [4][H][4] + wc_s [2][H][4] f32, d_s [PASS][H] T, red_s f32,
  // out_s [B][2U] + c_s, r_s, u_s [B][U] f32
  return sizeof(float) * static_cast<size_t>(hdim) * 3 * UNITS +
         sizeof(T) * static_cast<size_t>(PASS) * hdim +
         sizeof(float) * (RED_FLOATS + static_cast<size_t>(batch) * 5 * UNITS);
}

// acc[i * CG + j] += d[i][k] * w[k][j] over k = k0, k0 + step, ... (FULL:
// all BT rows live)
template <bool FULL, typename T>
__device__ __forceinline__ void fma_rows(float (&acc)[BT * CG],
                                         const float* w, const T* d,
                                         int hdim, int k0, int step,
                                         int mine) {
  for (int k = k0; k < hdim; k += step) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + k * CG);
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      if (FULL || i < mine) {
        const float v = to_f32(d[i * hdim + k]);
        float* o = acc + i * CG;
        o[0] = fmaf(v, w4.x, o[0]);
        o[1] = fmaf(v, w4.y, o[1]);
        o[2] = fmaf(v, w4.z, o[2]);
        o[3] = fmaf(v, w4.w, o[3]);
      }
    }
  }
}

// The exchange of one row: where each step's values are read from.
template <typename T>
struct Row {
  const T* plain;                   // c0 at step 0, else nullptr
  const unsigned long long* words;  // tagged words [B][H] (B=1)
  const T* values;                  // values [B][H] (B > 1)
  const int* flags;                 // their flags, one per block
  int step;
};

// out[b][c] = sum_k row[b][k] * W[k][c] for the block's C columns, W as
// planes [C / 4][H][4] in w_s.  Every thread calls it; it synchronises the
// block, also on return.
template <int C, typename T>
__device__ void row_product(const Row<T>& row, int batch, int hdim,
                            const float* w_s, T* d_s, float* red_s,
                            float* out) {
  constexpr int LK = 32 / (C / CG);  // lanes of one column group: 8 or 16
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cg = lane / LK, kl = lane % LK;
  const float* w = w_s + static_cast<size_t>(cg) * hdim * CG;
  if (row.plain == nullptr && row.words == nullptr) {
    wait_flags(row.flags, row.step);
    __syncthreads();
  }
  for (int p0 = 0; p0 < batch; p0 += PASS) {
    const int rows = min(PASS, batch - p0);
    const size_t off = static_cast<size_t>(p0) * hdim;
    if (row.plain != nullptr)
      stage_values(d_s, row.plain + off, rows * hdim);
    else if (row.words != nullptr)
      stage_tagged(d_s, row.words + off, row.step, rows * hdim);
    else
      stage_values(d_s, row.values + off, rows * hdim);
    __syncthreads();
    // warps over the live row tiles (1, 2 or 4 of them), the rest of the
    // warps of a tile splitting k: KW = 8, 4 or 2.  Thread (kw, kl) sums
    // the residue class q = kw LK + kl of k modulo KW LK; red_s holds each
    // class's sums, [q][tiles x BT rows][C] (+ 1 float against bank
    // conflicts), and they are added in the order of q.
    const int tiles = (rows + BT - 1) / BT;
    const int kw_n = tiles == 1 ? WARPS : tiles == 2 ? WARPS / 2 : WARPS / 4;
    const int bg = warp / kw_n, kw = warp % kw_n;
    const int mine = min(BT, rows - bg * BT);  // the same in a whole warp
    const int ld = WARPS / kw_n * BT * C + 1;
    if (mine > 0) {
      float acc[BT * CG];
#pragma unroll
      for (int e = 0; e < BT * CG; ++e) acc[e] = 0.f;
      const T* d = d_s + static_cast<size_t>(bg) * BT * hdim;
      if (mine == BT)
        fma_rows<true>(acc, w, d, hdim, kw * LK + kl, kw_n * LK, mine);
      else
        fma_rows<false>(acc, w, d, hdim, kw * LK + kl, kw_n * LK, mine);
      float* dst = red_s + (kw * LK + kl) * ld + bg * BT * C + cg * CG;
#pragma unroll
      for (int i = 0; i < BT; ++i)
        if (i < mine)
#pragma unroll
          for (int j = 0; j < CG; ++j) dst[i * C + j] = acc[i * CG + j];
    }
    __syncthreads();  // red_s complete; d_s free for the next pass
    for (int e = tid; e < rows * C; e += THREADS) {
      float s = 0.f;
      for (int q = 0; q < kw_n * LK; ++q) s += red_s[q * ld + e];
      out[static_cast<size_t>(p0) * C + e] = s;
    }
    __syncthreads();  // out complete; red_s free
  }
}

template <typename T, bool SAVE>
__global__ void __launch_bounds__(THREADS)
gru_scan_kernel(const T* __restrict__ gx, const T* __restrict__ cx,
                const T* __restrict__ wgh, const T* __restrict__ wch,
                const T* __restrict__ c0, T* cs, T* __restrict__ acts,
                unsigned long long* xch, int n_steps, int batch, int hdim) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  float* wg_s = smem;                                          // [4][H][4]
  float* wc_s = wg_s + static_cast<size_t>(hdim) * 2 * UNITS;  // [2][H][4]
  T* d_s = reinterpret_cast<T*>(wc_s + static_cast<size_t>(hdim) * UNITS);
  float* red_s = reinterpret_cast<float*>(d_s + static_cast<size_t>(PASS) *
                                                    hdim);
  float* out_s = red_s + RED_FLOATS;                           // [B][2U]
  float* c_s = out_s + static_cast<size_t>(batch) * 2 * UNITS;
  float* r_s = c_s + static_cast<size_t>(batch) * UNITS;
  float* u_s = r_s + static_cast<size_t>(batch) * UNITS;

  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x;
  const int g2 = 2 * hdim;
  const int n_el = batch * UNITS;
  const size_t bh = static_cast<size_t>(batch) * hdim;
  const bool words = batch <= TAGGED_MAX_B;
  unsigned long long* xc = xch;       // words: dt(c_t), tag t
  unsigned long long* xr = xch + bh;  // words: dt(c_t * r_t), tag t
  T* xrv = reinterpret_cast<T*>(xch);  // values: dt(c_t * r_t)
  int* flag_c = reinterpret_cast<int*>(xch + bh);  // values: flags
  int* flag_r = flag_c + gridDim.x;

  if (words) {
    for (size_t e = static_cast<size_t>(blockIdx.x) * THREADS + tid;
         e < 2 * bh; e += static_cast<size_t>(gridDim.x) * THREADS)
      xch[e] = ~0ull;  // no step's tag
  } else if (tid == 0) {
    flag_c[blockIdx.x] = -1;
    flag_r[blockIdx.x] = -1;
  }
  // resident planes: column c of the block (r of unit c for c < U, u of
  // unit c - U after them) at wg_s[(c / 4 * H + k) * 4 + c % 4]
  for (int e = tid; e < hdim * 2 * UNITS; e += THREADS) {
    const int k = e / (2 * UNITS), c = e % (2 * UNITS);
    const int unit = u0 + c % UNITS;
    wg_s[(static_cast<size_t>(c / CG) * hdim + k) * CG + c % CG] =
        unit < hdim ? to_f32(wgh[static_cast<size_t>(k) * g2 +
                                 (c < UNITS ? 0 : hdim) + unit])
                    : 0.f;
  }
  for (int e = tid; e < hdim * UNITS; e += THREADS) {
    const int k = e / UNITS, c = e % UNITS, unit = u0 + c;
    wc_s[(static_cast<size_t>(c / CG) * hdim + k) * CG + c % CG] =
        unit < hdim ? to_f32(wch[static_cast<size_t>(k) * hdim + unit]) : 0.f;
  }
  for (int e = tid; e < n_el; e += THREADS) {
    const int b = e / UNITS, unit = u0 + e % UNITS;
    c_s[e] = unit < hdim ? to_f32(c0[static_cast<size_t>(b) * hdim + unit])
                         : 0.f;
  }
  grid.sync();  // tags and flags cleared everywhere; row_product syncs

  // this thread's first (row, unit) pair: e = tid
  const int b0 = tid / UNITS, unit0 = u0 + tid % UNITS;
  const bool own0 = tid < n_el && unit0 < hdim;
  for (int t = 0; t < n_steps; ++t) {
    // gate inputs of the first pair, in flight during the first poll
    float gr = 0.f, gu = 0.f, gc = 0.f;
    if (own0) {
      const T* g = gx + (static_cast<size_t>(t) * batch + b0) * g2 + unit0;
      gr = to_f32(g[0]);
      gu = to_f32(g[hdim]);
      gc = to_f32(cx[static_cast<size_t>(t) * bh +
                     static_cast<size_t>(b0) * hdim + unit0]);
    }

    // 1. r and u of this block's units from dt(c_{t-1}); publish dt(c * r)
    const Row<T> c_row{t == 0 ? c0 : nullptr, words ? xc : nullptr,
                       t == 0 ? nullptr : cs + (t - 1) * bh, flag_c, t - 1};
    row_product<2 * UNITS>(c_row, batch, hdim, wg_s, d_s, red_s, out_s);
    for (int e = tid; e < n_el; e += THREADS) {
      const int b = e / UNITS, u = e % UNITS, unit = u0 + u;
      if (unit >= hdim) continue;
      if (e != tid) {
        const T* g = gx + (static_cast<size_t>(t) * batch + b) * g2 + unit;
        gr = to_f32(g[0]);
        gu = to_f32(g[hdim]);
      }
      const float r = sigmoid(gr + out_s[b * 2 * UNITS + u]);
      const float ug = sigmoid(gu + out_s[b * 2 * UNITS + UNITS + u]);
      r_s[e] = r;
      u_s[e] = ug;
      const T cr = from_f32<T>(c_s[e] * r);
      const size_t ix = static_cast<size_t>(b) * hdim + unit;
      if (words)
        store_tagged(xr + ix, tagged(to_f32(cr), t));
      else
        xrv[ix] = cr;
    }
    if (!words) publish(flag_r, t);

    // 2. candidate and new state of this block's units from dt(c * r)
    const Row<T> r_row{nullptr, words ? xr : nullptr, xrv, flag_r, t};
    row_product<UNITS>(r_row, batch, hdim, wc_s, d_s, red_s, out_s);
    const size_t h_off = static_cast<size_t>(t) * bh;
    for (int e = tid; e < n_el; e += THREADS) {
      const int b = e / UNITS, u = e % UNITS, unit = u0 + u;
      if (unit >= hdim) continue;
      const size_t ix = static_cast<size_t>(b) * hdim + unit;
      if (e != tid) gc = to_f32(cx[h_off + ix]);
      const float cand = tanhf(gc + out_s[e]);
      const float ug = u_s[e];
      const float c = c_s[e] * ug + cand * (1.f - ug);
      c_s[e] = c;
      const T cd = from_f32<T>(c);
      cs[h_off + ix] = cd;
      if (words) store_tagged(xc + ix, tagged(to_f32(cd), t));
      if (SAVE) {
        T* a = acts + static_cast<size_t>(t) * batch * 3 * hdim +
               static_cast<size_t>(b) * 3 * hdim + unit;
        a[0] = from_f32<T>(r_s[e]);
        a[hdim] = from_f32<T>(ug);
        a[2 * hdim] = from_f32<T>(cand);
      }
    }
    if (!words) publish(flag_c, t);
  }
}

template <typename T, bool SAVE>
int launch(const void* gx, const void* cx, const void* wgh, const void* wch,
           const void* c0, void* cs, void* acts, void* xch, int n_steps,
           int batch, int hdim, cudaStream_t stream) {
  auto kernel = gru_scan_kernel<T, SAVE>;
  const size_t smem = smem_bytes<T>(batch, hdim);
  const dim3 grid((hdim + UNITS - 1) / UNITS);
  const int fit = cooperative_fit(kernel, grid, THREADS, smem);
  if (fit != 0) return fit;  // never degrade: the polls would hang

  const T* gx_ = static_cast<const T*>(gx);
  const T* cx_ = static_cast<const T*>(cx);
  const T* wgh_ = static_cast<const T*>(wgh);
  const T* wch_ = static_cast<const T*>(wch);
  const T* c0_ = static_cast<const T*>(c0);
  T* cs_ = static_cast<T*>(cs);
  T* acts_ = static_cast<T*>(acts);
  unsigned long long* xch_ = static_cast<unsigned long long*>(xch);
  void* args[] = {&gx_, &cx_,  &wgh_,    &wch_,  &c0_, &cs_,
                  &acts_, &xch_, &n_steps, &batch, &hdim};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(THREADS), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool SAVE>
int dispatch(const void* gx, const void* cx, const void* wgh,
             const void* wch, const void* c0, void* cs, void* acts,
             void* xch, int n_steps, int batch, int hdim, int dtype,
             void* stream) {
  if (n_steps <= 0 || batch <= 0 || hdim <= 0 || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<size_t>(xch) % 16 != 0)
    return DANET_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, SAVE>(gx, cx, wgh, wch, c0, cs, acts, xch, n_steps,
                               batch, hdim, s);
  return launch<__nv_bfloat16, SAVE>(gx, cx, wgh, wch, c0, cs, acts, xch,
                                     n_steps, batch, hdim, s);
}

}  // namespace

// Kernel 4f, lean.  dtype: 0 = float32, 1 = bfloat16 (every tensor of the
// call).  xch [2, B, H] of 8-byte words (16-byte aligned) is scratch.
extern "C" int danet_gru_scan(const void* gx, const void* cx, const void* wgh,
                              const void* wch, const void* c0, void* cs,
                              void* xch, int n_steps, int batch, int hdim,
                              int dtype, void* stream) {
  return dispatch<false>(gx, cx, wgh, wch, c0, cs, nullptr, xch, n_steps,
                         batch, hdim, dtype, stream);
}

// Kernel 4f that also writes acts [T, B, 3H] = [r | u | cand].
extern "C" int danet_gru_scan_train(const void* gx, const void* cx,
                                    const void* wgh, const void* wch,
                                    const void* c0, void* cs, void* acts,
                                    void* xch, int n_steps, int batch,
                                    int hdim, int dtype, void* stream) {
  return dispatch<true>(gx, cx, wgh, wch, c0, cs, acts, xch, n_steps, batch,
                        hdim, dtype, stream);
}
