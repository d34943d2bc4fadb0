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
// dc0 [B, H]; flags [2, H] int32 is scratch for the exchange (below).
// Storage f32 or bf16.  dWgh = sum_t c_prev^T dgx[t] and dWch = sum_t
// dt(c_prev * r)^T dcx[t] have no sequential dependency and are bulk
// matmuls outside the kernel, as in the JAX package.
//
// What bounds it on this card: as in the forward (gru_scan.cu), the two
// dependent row products of each step, each of which needs a row that
// every block wrote, not FLOPs or bytes.  So a step is two exchanges of a
// row between all blocks, and the design passes no grid barrier.
//
// Tiling.  The hidden units are split over blocks, UNITS = 8 per block (75
// blocks at H=600, 38 at H=300, whose last block has 4 live units: every
// load and store of a unit past H is masked).  A block owns the dc carry
// of its units for every batch row (shared memory) and keeps its rows of
// Wch and Wgh resident in shared memory, transposed, as planes of 4 units
// ([2][H][4] and [2][2H][4] f32, 57.6 KB at H=600).  Each step:
//   (a) the cell backward of its units: writes its columns of dcx[t] and
//       of the du half of dgx[t], and publishes flag 1;
//   (b) waits for every block's flag 1 and copies the whole dcx[t] row
//       into shared memory (the du half of dgx[t], published with it, is
//       copied beside it for (c), in flight during the product); dcr of
//       its units; writes the dr half of dgx[t]; publishes flag 2;
//   (c) waits for every flag 2, copies the dr half of dgx[t], and adds
//       dgx[t] @ Wgh^T to dc, which (a) of step t-1 uses in this block.
// The residuals of (a) for a thread's first (row, unit) pair are loaded
// before (c)'s wait of the step before, so they arrive during it.
//
// Exchange: flags (exchange.cuh), at every batch: the backward never
// serves, so B=1 is no latency-bound request and takes no tagged words.
// The rows are the outputs themselves, in the storage type (bf16 moves
// half the bytes), copied by 16-byte cp.async.cg into shared memory in the
// storage type.  flags[0] (phase 1) and flags[1] (phase 2) hold one int
// per block, the reverse step T-1-t it last published; the block clears
// them and passes one grid.sync() before the first step, none after.
//
// Why one flag per block and phase is enough, with no second buffer.
// dcx[t] and dgx[t] are written once, at step t, and never overwritten,
// so a value a reader copies after it has seen a flag at step t or later
// is final: a flag never runs ahead of values that could still change.
// A block can publish step t-1 before a slower one has read step t's row,
// and the slower one then sees a later step in the flag, which is enough.
// (Kernel B's words need two buffers because a word is overwritten by the
// next step; here nothing is.)
//
// Product.  The staged rows x_s [PASS][sld] (storage type) times the
// block's 8 columns: a thread holds a register tile of BT = 8 rows x 4
// columns over a strided share of k; the 16 lanes of a column group split
// k, and so do the KW warps on one row tile: 8 at B <= 8, 4 at B <= 16, 2
// at B=32.  Thread (kw, kl) sums the residue class q = 16 kw + kl of k
// modulo 16 KW in increasing k; the classes meet in red_s and are added in
// the order of q, and only then is the sum added to dc (after dc_total * u
// and dcr * r, in that order).  For the Wgh product k runs over [dr | du],
// 2H columns, dr first: a class continues from the dr half into the du
// half.  At B=32 (KW=2: k mod 32) that is every rounding of the earlier
// design (row_contract.cuh's 32-way k split), whose training step the
// card-vs-CPU gradient checks hold to 1e-4 of each tensor's peak; the
// outputs are bit for bit the same.  Batches beyond PASS = 32 rows take
// more passes of the same.
//
// Shared memory: 24 H floats of weights, two staged rows of min(B, 32) x
// sld values (sld = H rounded up to 16 bytes; the first buffer at least
// red_s's 33.3 KB, which it holds after the product) and 12 bytes per
// (batch row, unit): 214 KB at H=600, B=32 in f32 (137 KB in bf16), within
// the 227 KB opt-in up to B=221 (f32) or 1021 (bf16) at H=600.
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
constexpr int LOADS = 8;       // (exchange.cuh: the tagged words, unused)
constexpr int LK = 32 / (UNITS / CG);  // lanes of one column group: 16
// red_s: KW LK classes x (8 / KW) BT rows x UNITS columns, + 1 float per
// class (at most WARPS LK classes) against bank conflicts
constexpr int RED_FLOATS = WARPS * BT * UNITS * LK + WARPS * LK;

#include "exchange.cuh"

// Values in one staged row: H rounded up to 16 bytes of T.
template <typename T>
__host__ __device__ __forceinline__ int row_stride(int hdim) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  return (hdim + VEC - 1) / VEC * VEC;
}

// Bytes of the staged-row buffers: the first also holds red_s.
template <typename T>
__host__ __device__ __forceinline__ size_t buf_bytes(int batch, int hdim,
                                                     bool first) {
  const size_t rows = batch < PASS ? batch : PASS;
  const size_t row = rows * row_stride<T>(hdim) * sizeof(T);
  const size_t red = sizeof(float) * RED_FLOATS;
  return first && red > row ? red : row;
}

template <typename T>
size_t smem_bytes(int batch, int hdim) {
  // wc_s [2][H][4] + wg_s [2][2H][4] f32, x_s, y_s, dc_s, r_s, cp_s
  // [B][U] f32
  return sizeof(float) * static_cast<size_t>(hdim) * 3 * UNITS +
         buf_bytes<T>(batch, hdim, true) + buf_bytes<T>(batch, hdim, false) +
         sizeof(float) * static_cast<size_t>(batch) * 3 * UNITS;
}

// Warps splitting k over one row tile, for a pass of `rows` rows: 8, 4 or
// 2 (all 8 warps on one tile up to 8 rows).
__device__ __forceinline__ int k_warps(int rows) {
  const int tiles = (rows + BT - 1) / BT;
  return tiles == 1 ? WARPS : tiles == 2 ? WARPS / 2 : WARPS / 4;
}

// acc[i * CG + j] += d[i][k] * w[k][j] over k = k0, k0 + step, ... < n
// (FULL: all BT rows live)
template <bool FULL, typename T>
__device__ __forceinline__ void fma_rows(float (&acc)[BT * CG],
                                         const float* w, const T* d, int sld,
                                         int k0, int n, int step, int mine) {
  for (int k = k0; k < n; k += step) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + k * CG);
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      if (FULL || i < mine) {
        const float v = to_f32(d[i * sld + k]);
        float* o = acc + i * CG;
        o[0] = fmaf(v, w4.x, o[0]);
        o[1] = fmaf(v, w4.y, o[1]);
        o[2] = fmaf(v, w4.z, o[2]);
        o[3] = fmaf(v, w4.w, o[3]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void fma_live(float (&acc)[BT * CG],
                                         const float* w, const T* d, int sld,
                                         int k0, int n, int step, int mine) {
  if (mine == BT)
    fma_rows<true>(acc, w, d, sld, k0, n, step, mine);
  else
    fma_rows<false>(acc, w, d, sld, k0, n, step, mine);
}

// The class sums of one pass, [q][rows][UNITS] in red_s (row stride ld per
// class): the staged rows x_s [rows][sld] times the block's columns over
// k < H, the weights as planes [2][G][4] in w_s (G = H, or 2H for Wgh);
// with y_s, the Wgh product continues over y_s's columns as k = H ... 2H-1.
// Returns ld.  The caller passed a block barrier after the staging; the
// sums land in red_s, which aliases x_s, after a second one inside.
template <typename T>
__device__ int row_product(const T* x_s, const T* y_s, int sld,
                           const float* w_s, int rows, int hdim,
                           float* red_s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cg = lane / LK, kl = lane % LK;
  const int kw_n = k_warps(rows);
  const int bg = warp / kw_n, kw = warp % kw_n;
  const int mine = min(BT, rows - bg * BT);  // the same in a whole warp
  const int ld = WARPS / kw_n * BT * UNITS + 1;
  const int q = kw * LK + kl, nq = kw_n * LK;
  const int g = y_s == nullptr ? hdim : 2 * hdim;
  const float* w = w_s + static_cast<size_t>(cg) * g * CG;
  float acc[BT * CG];
#pragma unroll
  for (int e = 0; e < BT * CG; ++e) acc[e] = 0.f;
  const size_t off = static_cast<size_t>(bg) * BT * sld;
  if (mine > 0) {
    fma_live(acc, w, x_s + off, sld, q, hdim, nq, mine);
    // the second half's columns in the class of q: k' = q - H mod nq
    if (y_s != nullptr)
      fma_live(acc, w + static_cast<size_t>(hdim) * CG, y_s + off, sld,
               ((q - hdim) % nq + nq) % nq, hdim, nq, mine);
  }
  __syncthreads();  // every product read x_s: red_s may overwrite it
  if (mine > 0) {
    float* dst = red_s + q * ld + bg * BT * UNITS + cg * CG;
#pragma unroll
    for (int i = 0; i < BT; ++i)
      if (i < mine)
#pragma unroll
        for (int j = 0; j < CG; ++j) dst[i * UNITS + j] = acc[i * CG + j];
  }
  __syncthreads();  // red_s complete
  return ld;
}

// The sum of the classes of element e (row e / UNITS, unit e % UNITS) of a
// pass, in the order of the class.
__device__ __forceinline__ float class_sum(const float* red_s, int ld,
                                           int nq, int e) {
  float s = 0.f;
  for (int q = 0; q < nq; ++q) s += red_s[q * ld + e];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gru_scan_bwd_kernel(const T* __restrict__ d_cs, const T* __restrict__ acts,
                    const T* __restrict__ c_prev, const T* __restrict__ wgh,
                    const T* __restrict__ wch, T* dgx, T* dcx,
                    T* __restrict__ dc0, int* flags, int n_steps, int batch,
                    int hdim) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int sld = row_stride<T>(hdim);
  float* wc_s = smem;                                          // [2][H][4]
  float* wg_s = wc_s + static_cast<size_t>(hdim) * UNITS;      // [2][2H][4]
  T* x_s = reinterpret_cast<T*>(wg_s + static_cast<size_t>(hdim) * 2 * UNITS);
  float* red_s = reinterpret_cast<float*>(x_s);  // after each product
  T* y_s = reinterpret_cast<T*>(reinterpret_cast<char*>(x_s) +
                                buf_bytes<T>(batch, hdim, true));
  float* dc_s = reinterpret_cast<float*>(reinterpret_cast<char*>(y_s) +
                                         buf_bytes<T>(batch, hdim, false));
  float* r_s = dc_s + static_cast<size_t>(batch) * UNITS;
  float* cp_s = r_s + static_cast<size_t>(batch) * UNITS;

  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x;
  const int g2 = 2 * hdim, g3 = 3 * hdim;
  const int n_el = batch * UNITS;
  const size_t bh = static_cast<size_t>(batch) * hdim;
  int* flag_x = flags;                 // dcx[t] and du of dgx[t] stored
  int* flag_g = flags + gridDim.x;     // dr of dgx[t] stored

  if (tid == 0) {
    flag_x[blockIdx.x] = -1;
    flag_g[blockIdx.x] = -1;
  }
  // resident planes: column c of the block (unit u0 + c) at
  // wc_s[(c / 4 * H + k) * 4 + c % 4] = Wch[u0 + c][k], and likewise
  // wg_s with 2H for Wgh (reads coalesced over k)
  for (int e = tid; e < UNITS * hdim; e += THREADS) {
    const int c = e / hdim, k = e % hdim;
    wc_s[(static_cast<size_t>(c / CG) * hdim + k) * CG + c % CG] =
        u0 + c < hdim ? to_f32(wch[static_cast<size_t>(u0 + c) * hdim + k])
                      : 0.f;
  }
  for (int e = tid; e < UNITS * g2; e += THREADS) {
    const int c = e / g2, k = e % g2;
    wg_s[(static_cast<size_t>(c / CG) * g2 + k) * CG + c % CG] =
        u0 + c < hdim ? to_f32(wgh[static_cast<size_t>(u0 + c) * g2 + k])
                      : 0.f;
  }
  for (int e = tid; e < n_el; e += THREADS) dc_s[e] = 0.f;
  grid.sync();  // flags cleared everywhere; the cell reads only its dc_s

  // this thread's first (row, unit) pair: e = tid; its residuals of the
  // next step are loaded before the previous step's last wait
  const int b0 = tid / UNITS, unit0 = u0 + tid % UNITS;
  const bool own0 = tid < n_el && unit0 < hdim;
  float nr = 0.f, nu = 0.f, nc = 0.f, ncp = 0.f, nd = 0.f;
  auto residuals = [&](int t) {
    const size_t ix = static_cast<size_t>(t) * bh +
                      static_cast<size_t>(b0) * hdim + unit0;
    const T* a = acts + static_cast<size_t>(t) * batch * g3 +
                 static_cast<size_t>(b0) * g3 + unit0;
    nr = to_f32(a[0]);
    nu = to_f32(a[hdim]);
    nc = to_f32(a[2 * hdim]);
    ncp = to_f32(c_prev[ix]);
    nd = to_f32(d_cs[ix]);
  };
  if (own0) residuals(n_steps - 1);

  for (int t = n_steps - 1; t >= 0; --t) {
    const int step = n_steps - 1 - t;  // the flags' count
    const size_t h_off = static_cast<size_t>(t) * bh;
    T* dcx_t = dcx + h_off;
    T* dgx_t = dgx + static_cast<size_t>(t) * batch * g2;

    // (a) cell backward of this block's (batch row, unit) pairs
    for (int e = tid; e < n_el; e += THREADS) {
      const int b = e / UNITS, unit = u0 + e % UNITS;
      if (unit >= hdim) continue;
      const size_t ix = static_cast<size_t>(b) * hdim + unit;
      float r = nr, ug = nu, cand = nc, cp = ncp, dcs = nd;
      if (e != tid) {
        const T* a = acts + static_cast<size_t>(t) * batch * g3 +
                     static_cast<size_t>(b) * g3 + unit;
        r = to_f32(a[0]);
        ug = to_f32(a[hdim]);
        cand = to_f32(a[2 * hdim]);
        cp = to_f32(c_prev[h_off + ix]);
        dcs = to_f32(d_cs[h_off + ix]);
      }
      const float dct = dcs + dc_s[e];
      const float du_pre = dct * (cp - cand) * ug * (1.f - ug);
      const float dcand_pre = dct * (1.f - ug) * (1.f - cand * cand);
      dcx_t[ix] = from_f32<T>(dcand_pre);
      dgx_t[static_cast<size_t>(b) * g2 + hdim + unit] = from_f32<T>(du_pre);
      dc_s[e] = dct * ug;
      r_s[e] = r;
      cp_s[e] = cp;
    }
    publish(flag_x, step);

    // (b) dcr = dcx[t] @ Wch^T for this block's units; the dr half of dgx
    wait_flags(flag_x, step);
    __syncthreads();
    for (int p0 = 0; p0 < batch; p0 += PASS) {
      const int rows = min(PASS, batch - p0);
      copy_rows(x_s, sld, dcx_t + static_cast<size_t>(p0) * hdim, hdim,
                rows, hdim);
      if (p0 == 0) {  // the du half of the first pass, for (c)
        copy_rows(y_s, sld, dgx_t + hdim, g2, rows, hdim);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int ld = row_product<T>(x_s, nullptr, sld, wc_s, rows, hdim,
                                    red_s);
      const int nq = k_warps(rows) * LK;
      for (int e = tid; e < rows * UNITS; e += THREADS) {
        const int b = p0 + e / UNITS, unit = u0 + e % UNITS;
        if (unit >= hdim) continue;
        const int i = p0 * UNITS + e;
        const float dcr = class_sum(red_s, ld, nq, e), r = r_s[i];
        dgx_t[static_cast<size_t>(b) * g2 + unit] =
            from_f32<T>(dcr * cp_s[i] * r * (1.f - r));
        dc_s[i] += dcr * r;
      }
      __syncthreads();  // red_s read: x_s free for the next pass
    }
    publish(flag_g, step);

    // (c) dc += dgx[t] @ Wgh^T for this block's units
    if (own0 && t > 0) residuals(t - 1);  // in flight during the wait
    wait_flags(flag_g, step);
    __syncthreads();
    for (int p0 = 0; p0 < batch; p0 += PASS) {
      const int rows = min(PASS, batch - p0);
      const T* row = dgx_t + static_cast<size_t>(p0) * g2;
      copy_rows(x_s, sld, row, g2, rows, hdim);
      if (p0 > 0) copy_rows(y_s, sld, row + hdim, g2, rows, hdim);
      cp_async_wait<0>();
      __syncthreads();
      const int ld = row_product<T>(x_s, y_s, sld, wg_s, rows, hdim, red_s);
      const int nq = k_warps(rows) * LK;
      for (int e = tid; e < rows * UNITS; e += THREADS)
        dc_s[p0 * UNITS + e] += class_sum(red_s, ld, nq, e);
      // red_s read: x_s free; the cell of step t-1 reads only this
      // thread's dc_s
      __syncthreads();
    }
  }

  for (int e = tid; e < n_el; e += THREADS) {
    const int b = e / UNITS, unit = u0 + e % UNITS;
    if (unit < hdim)
      dc0[static_cast<size_t>(b) * hdim + unit] = from_f32<T>(dc_s[e]);
  }
}

template <typename T>
int launch(const void* d_cs, const void* acts, const void* c_prev,
           const void* wgh, const void* wch, void* dgx, void* dcx, void* dc0,
           void* flags, int n_steps, int batch, int hdim,
           cudaStream_t stream) {
  auto kernel = gru_scan_bwd_kernel<T>;
  const size_t smem = smem_bytes<T>(batch, hdim);
  const dim3 grid((hdim + UNITS - 1) / UNITS);
  const int fit = cooperative_fit(kernel, grid, THREADS, smem);
  if (fit != 0) return fit;  // never degrade: the polls would hang

  const T* d_cs_ = static_cast<const T*>(d_cs);
  const T* acts_ = static_cast<const T*>(acts);
  const T* c_prev_ = static_cast<const T*>(c_prev);
  const T* wgh_ = static_cast<const T*>(wgh);
  const T* wch_ = static_cast<const T*>(wch);
  T* dgx_ = static_cast<T*>(dgx);
  T* dcx_ = static_cast<T*>(dcx);
  T* dc0_ = static_cast<T*>(dc0);
  int* flags_ = static_cast<int*>(flags);
  void* args[] = {&d_cs_, &acts_, &c_prev_, &wgh_,    &wch_,  &dgx_,
                  &dcx_,  &dc0_,  &flags_,  &n_steps, &batch, &hdim};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(THREADS), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel 4b.  dtype: 0 = float32, 1 = bfloat16 (every tensor of the call).
// flags [2, H] int32 (4-byte aligned) is scratch.
extern "C" int danet_gru_scan_bwd(const void* d_cs, const void* acts,
                                  const void* c_prev, const void* wgh,
                                  const void* wch, void* dgx, void* dcx,
                                  void* dc0, void* flags, int n_steps,
                                  int batch, int hdim, int dtype,
                                  void* stream) {
  if (n_steps <= 0 || batch <= 0 || hdim <= 0 || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<size_t>(flags) % 4 != 0)
    return DANET_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(d_cs, acts, c_prev, wgh, wch, dgx, dcx, dc0, flags,
                         n_steps, batch, hdim, s);
  return launch<__nv_bfloat16>(d_cs, acts, c_prev, wgh, wch, dgx, dcx, dc0,
                               flags, n_steps, batch, hdim, s);
}
