// Kernel B and the saving forwards: the lean (inference) LSTM forward,
// the whole time loop of one layer, all its directions, in one cooperative
// launch; with SAVE, the forward that also saves the residuals of the
// backward (bilstm_scan_bwd.cu): kernel 2 with two directions, and its
// one-direction form.
//
// Replaces danet_tpu/ops/pallas/lstm.py::_fwd_call: with save=False,
// bilstm_scan_pallas (n_dirs=2) and lstm_scan_pallas (n_dirs=1); with
// SAVE, save=True (both under their custom VJPs).
//
//   act_t  = xp_t + h_{t-1} @ Wh           (f32 accumulate)
//   cand   = tanh(act[0:H]) or act[0:H]     (gate order cand|i|f|o)
//   i,f,o  = sigmoid(act[H:2H]), sigmoid(act[2H:3H]), sigmoid(act[3H:4H])
//   c_t    = i*cand + f*c_{t-1}             (f32 carry)
//   h_t    = o*tanh(c_t), rounded to the storage type before it feeds
//            the next step and is written to hs
//   SAVE:  cs[t] = c_t and acts[t] = [cand, i, f, o], each rounded to the
//          storage type (as the TPU kernel stores its residuals)
//
// Shapes, with D = n_dirs (1 or 2): xp [T, D, B, 4H], wh [D, H, 4H],
// c0/h0 [D, B, H] -> hs [T, D, B, H] (SAVE: and cs [T, D, B, H], acts
// [T, D, B, 4H]); with D = 1 that is exactly [T, B, 4H], [H, 4H], [B, H].
// xch [2, D, B, H] of 8-byte words is
// scratch for the exchange (below).  Storage f32 or bf16, gate math and
// the cell carry f32.  With D = 2, direction 1 sees the time-reversed
// input; the caller reverses in and out.  c0 and h0 are taken as given.
//
// What bounds it on this card: Wh of one direction (1.44 MB in f32 at
// H=300, 5.76 MB at H=600) must be spread over many SMs' shared memory,
// and each step depends on the whole h_{t-1} of its direction.  So a step
// is one exchange of a [B, H] row between all blocks of a direction and a
// chain of dependent work after it (the product, its reduction, the
// cell): latency, not FLOPs or bytes, sets the speed at serving batches.
// The design spends one L2 round trip on the exchange at B=1, passes no
// grid barrier (the two directions never wait on each other), and keeps
// the chain short: one block barrier per step at B=1 and no partial sums
// in shared memory (on an H100, perf_probe.py lstm-fwd --cut, B=1: the
// exchange about half of a step, the FMAs a fifth; PERF.md).
//
// Tiling.  The hidden units of a direction are split over blocks, UNITS =
// 8 per block, one per warp (grid.x = 38 at H=300, whose last block has 4
// live units, 75 at H=600; grid.y = D, also a template parameter, so that
// the direction stride is a constant in the index arithmetic).  A block
// keeps the 4 gate columns of each of its units (cand, i, f, o) resident
// in shared memory as one plane per unit ([unit][H][4] f32, the plane
// stride padded so that the two planes a quarter-warp reads fall on
// different banks).
//
// Exchange (exchange.cuh), two protocols chosen by the batch (the same in
// every block):
//   * B <= TAGGED_MAX_B (1: a single request): tagged words.  Each block
//     publishes its units' h_t as one word per (batch row, unit), dt(h_t)
//     and the step t, into xch[t % 2][dir]; a reader polls each word it
//     needs, LOADS words in flight per thread, until it carries tag t-1.
//   * B > TAGGED_MAX_B: the row is hs[t-1] itself, plain values that are
//     never overwritten.  Each block publishes one flag per direction
//     (xch as int: [D][blocks]) after its values; a reader's threads poll
//     the flags of their own direction and copy the row with cp.async.cg
//     (element loads where the row is not 16-byte aligned: bf16 with odd
//     H, and h0).
// The block clears the tags (or flags) and passes one grid.sync() before
// step 0, so that no tag of an earlier launch matches.
//
// Why two word buffers, by the parity of the step, suffice (and one does
// not).  Block X publishes h_{t+1} only after it has read all of h_t, and
// every block Y publishes h_t only after it has read all of h_{t-1} (its
// polls returned before the product that h_t depends on).  So when any
// slot of xch[(t+1) % 2] receives step t+1, no block still reads step
// t-1 there, and a reader waiting for tag t-1 never sees t+1.  With one
// buffer, X could overwrite its slot with h_{t+1} while a slower Y still
// polls that slot for h_t: an LSTM step has one exchange, where the GRU's
// two alternating rows (gru_scan.cu) serve each other as the second
// buffer.
//
// Product, by protocol.  Tagged words (scan_words): warp w multiplies the
// staged row by its unit's plane alone, lane (rg, kg) row rg over k = kg
// modulo 32 / RG (RG the batch rounded up to a power of two: at B=1 all
// 32 lanes split k, 10 k and 40 FMAs per lane at H=300, 19 and 75 at
// H=600); the lanes' sums meet in a shuffle butterfly and lane (rg, 0)
// adds the gate inputs and runs the cell, its c in a register.  So a step
// is a poll, one block barrier, the FMAs, five shuffles and the cell: no
// partial sums in shared memory.  Flags (scan_flags): a thread holds a
// register tile of up to RT rows x 4 columns (one unit's gates) over a
// strided share of k, RT = BT = 8 rows, or SAVE2_BT = 4 in the float32
// two-direction saving forward (kernel 2); the LK lanes of a unit split k,
// and so do the KW warps on one row tile (8 / KW tiles of a pass of 32
// rows: KW = 8 at B <= RT, 2 at B=32 with 8-row tiles, 1 with 4-row
// ones); the lanes' sums meet in a butterfly, the warps' in red_s, added
// in the order of the warp by the thread of each (row, unit) pair, which
// then runs the cell, its c in shared memory.  The tile's row count is a
// template constant (a predicate per row on a run-time count made the
// loop 2.5 times slower on an H100).  Both orders are fixed, so the
// result does not depend on timing.  SAVE, flags: no butterfly; each
// lane's residue class of k (modulo KW LK) lands in red_s on its own, and
// the thread of a (row, unit) pair adds the classes to the gate inputs in
// the order of the class.  At B=32 that is every rounding of the earlier
// saving design (the port's first, with a grid barrier per step): with
// one direction (H=600) KW=2, LK=4, the classes k mod 8 of its 8-way k
// split; with two (H=300) 4-row tiles, KW=1, the classes k mod 4 of its
// 4-way split, at the same 1,200 FMAs per thread as 8-row tiles with
// KW=2.  The card-vs-CPU gradient checks hold both float32 training steps
// to 1e-4 of each tensor's peak: hs, cs and acts are bit for bit the
// earlier design's.  In bfloat16 kernel 2 keeps 8-row tiles (k mod 8, other
// roundings than the earlier design's): on an H100 the 4-row tile took
// 1.30 ms at (T=128, B=32) against 0.86 ms for the 8-row one (0.88 and
// 0.80 ms in float32), and the bfloat16 training step is held to its
// losses at 1e-2, far above a reordered f32 sum.
// The gate inputs of each thread's first pair are loaded at the top of
// the step, before the poll, so they arrive during the wait.
// Batches beyond PASS = 32 rows take more passes of the same.
//
// Shared memory: 8 planes of 4 H floats (38.4 KB at H=300, 77.3 KB at
// H=600), the staged row in the storage type (two buffers of B H values
// for the words, one of min(B, 32) H for the flags), 8 KB of partial sums
// (SAVE: 33 KB) and 32 bytes per batch row: 88 KB at H=600, B=1 in f32,
// 163 KB at B=32 (SAVE: 188 KB), within the 227 KB opt-in up to B=1392
// (SAVE) at H=600 in f32; kernel 2 (H=300) 112 KB at B=32 in f32.  Row
// ceilings of the 227 KB, by danet_lstm_scan_max_rows: at H=128, 5968 rows
// (SAVE 5168) in f32 and 6224 (5424) in bf16; at H=256, 4944 (4144) in f32
// and 5456 (4656) in bf16.  The wrapper splits a larger batch into
// launches of at most that many rows (the rows are independent).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNITS = WARPS;     // hidden units per block: one per warp
constexpr int CG = 4;            // product columns per thread (one plane)
constexpr int BT = 8;            // batch rows per thread tile
constexpr int SAVE2_BT = 4;      // ... in the float32 two-direction saving
                                 // forward
constexpr int PASS = 32;         // batch rows per pass
constexpr int LOADS = 8;         // independent polls in flight per thread
constexpr int TAGGED_MAX_B = 1;  // largest batch that exchanges tagged words
constexpr int COLS = 4 * UNITS;  // gate columns of a block: 4 u + g
constexpr int LK = 32 / UNITS;   // lanes of one column group (plane)
// red_s: KW warps x (8 / KW) RT rows x COLS, at most WARPS BT COLS; with
// SAVE, KW LK classes x (8 / KW) RT rows x COLS + 8 floats per class
// (against bank conflicts), at most WARPS LK of the padding
constexpr int RED_FLOATS = WARPS * BT * COLS;
constexpr int SAVE_RED_FLOATS = LK * (WARPS * BT * COLS + 8 * WARPS);
static_assert(UNITS >= 1 && 32 % UNITS == 0, "UNITS must divide 32");
static_assert(TAGGED_MAX_B <= 32, "the words' row groups span one warp");
static_assert(SAVE2_BT <= BT && PASS % BT == 0 && PASS % SAVE2_BT == 0 &&
                  PASS / SAVE2_BT <= WARPS && PASS / BT <= WARPS,
              "a pass is at most one row tile per warp");

#include "exchange.cuh"

// Floats between two planes of w_s: 4 H, padded to 4 LK mod 32, so that
// the 8 / LK column groups of a quarter-warp's 16-byte reads fall on
// different banks.
__host__ __device__ __forceinline__ int plane_stride(int hdim) {
  return CG * hdim + ((CG * LK - CG * hdim % 32) % 32 + 32) % 32;
}

// Bytes of one staged row buffer, min(B, PASS) x H values, rounded up to
// 16 so that every buffer and red_s stay aligned.
template <typename T>
__host__ __device__ __forceinline__ size_t row_bytes(int batch, int hdim) {
  const size_t rows = batch < PASS ? batch : PASS;
  return (rows * hdim * sizeof(T) + 15) / 16 * 16;
}

template <bool SAVE>
__host__ __device__ __forceinline__ int red_floats() {
  return SAVE ? SAVE_RED_FLOATS : RED_FLOATS;
}

// Rows of a thread's register tile in the flags' product (RT above).
template <typename T, int NDIRS, bool SAVE>
__host__ __device__ constexpr int row_tile() {
  return NDIRS == 2 && SAVE && sizeof(T) == 4 ? SAVE2_BT : BT;
}

// Floats between two classes (SAVE) or warps of red_s, for KW warps on a
// row tile of RT rows.
template <bool SAVE, int RT>
__device__ __forceinline__ int red_stride(int kw_n) {
  return WARPS / kw_n * RT * COLS + (SAVE ? 8 : 0);
}

template <typename T, bool SAVE>
size_t smem_bytes(int batch, int hdim) {
  // w_s [UNITS][plane_stride] f32, d_s (two buffers for the words), red_s
  // f32, c_s [B][UNITS] f32
  return sizeof(float) * UNITS * static_cast<size_t>(plane_stride(hdim)) +
         (batch <= TAGGED_MAX_B ? 2 : 1) * row_bytes<T>(batch, hdim) +
         sizeof(float) * (red_floats<SAVE>() +
                          static_cast<size_t>(batch) * UNITS);
}

// Where the saving forward stores its residuals: cs [.., B, H] and acts
// [.., B, 4H] (row r of hs is row r of both); null in the lean one.
template <typename T>
struct Saved {
  T* cs;
  T* acts;
};

// The cell of one (row, unit) pair from its gate pre-activations a =
// [cand|i|f|o]: updates c, returns dt(h); SAVE: stores dt(c) and
// dt([cand, i, f, o]) of hs's row `row`.
template <typename T, bool TANH, bool SAVE>
__device__ __forceinline__ T cell(const float (&a)[4], float& c,
                                  const Saved<T>& saved, size_t row,
                                  int unit, int hdim) {
  const float cand = TANH ? tanhf(a[0]) : a[0];
  const float ig = sigmoid(a[1]), fg = sigmoid(a[2]), og = sigmoid(a[3]);
  c = ig * cand + fg * c;
  if (SAVE) {
    saved.cs[row * hdim + unit] = from_f32<T>(c);
    T* act = saved.acts + row * 4 * hdim + unit;
    act[0] = from_f32<T>(cand);
    act[hdim] = from_f32<T>(ig);
    act[2 * hdim] = from_f32<T>(fg);
    act[3 * hdim] = from_f32<T>(og);
  }
  return from_f32<T>(og * tanhf(c));
}

// The gate inputs xp[.., g H] of one (row, unit) pair, g = cand, i, f, o.
template <typename T>
__device__ __forceinline__ void gate_inputs(float (&a)[4], const T* x,
                                            int hdim) {
#pragma unroll
  for (int g = 0; g < 4; ++g) a[g] = to_f32(x[g * hdim]);
}

// acc[i * CG + j] += d[i][k] * w[k][j] for the ROWS live rows i over k =
// k0, k0 + step, ... (ROWS a constant: a predicate per row on a run-time
// count made the loop 2.5 times slower)
template <int ROWS, int RT, typename T>
__device__ __forceinline__ void fma_rows(float (&acc)[RT * CG],
                                         const float* w, const T* d,
                                         int hdim, int k0, int step) {
#pragma unroll 2
  for (int k = k0; k < hdim; k += step) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + k * CG);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float v = to_f32(d[i * hdim + k]);
      float* o = acc + i * CG;
      o[0] = fmaf(v, w4.x, o[0]);
      o[1] = fmaf(v, w4.y, o[1]);
      o[2] = fmaf(v, w4.z, o[2]);
      o[3] = fmaf(v, w4.w, o[3]);
    }
  }
}

// fma_rows for the `mine` live rows of a tile of RT, a constant in each
// case (the cases past RT never run).
template <int RT, typename T>
__device__ __forceinline__ void fma_live(int mine, float (&acc)[RT * CG],
                                         const float* w, const T* d,
                                         int hdim, int k0, int step) {
  constexpr int R5 = RT < 5 ? RT : 5, R6 = RT < 6 ? RT : 6;
  constexpr int R7 = RT < 7 ? RT : 7;
  switch (mine) {
    case 1: fma_rows<1, RT>(acc, w, d, hdim, k0, step); break;
    case 2: fma_rows<2, RT>(acc, w, d, hdim, k0, step); break;
    case 3: fma_rows<3, RT>(acc, w, d, hdim, k0, step); break;
    case 4: fma_rows<4, RT>(acc, w, d, hdim, k0, step); break;
    case 5: fma_rows<R5, RT>(acc, w, d, hdim, k0, step); break;
    case 6: fma_rows<R6, RT>(acc, w, d, hdim, k0, step); break;
    case 7: fma_rows<R7, RT>(acc, w, d, hdim, k0, step); break;
    default: fma_rows<RT, RT>(acc, w, d, hdim, k0, step);
  }
}

// Warps splitting k over one row tile of RT rows, for a pass of `rows`
// rows: 8, 4, 2 or (4-row tiles) 1 (all 8 warps on one tile up to RT
// rows).
template <int RT>
__device__ __forceinline__ int k_warps(int rows) {
  const int tiles = (rows + RT - 1) / RT;
  return tiles == 1                      ? WARPS
         : tiles == 2                    ? WARPS / 2
         : RT == BT || tiles <= 4        ? WARPS / 4
                                         : WARPS / 8;
}

// The partial products of the staged rows d_s [rows][H] with the block's
// COLS columns: warp (bg, kw) and lane (cg, kl) sum k = kw LK + kl modulo
// KW LK over row tile bg and plane (unit) cg; the LK lanes' sums meet in a
// butterfly, and each warp's land in red_s [kw][row][COLS].  SAVE: no
// butterfly, each lane's class sum lands in red_s [kw LK + kl][row][COLS].
template <bool SAVE, int RT, typename T>
__device__ __forceinline__ void row_product(const T* d_s, const float* w_s,
                                            float* red_s, int rows,
                                            int hdim) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cg = lane / LK, kl = lane % LK;
  const int kw_n = k_warps<RT>(rows);
  const int bg = warp / kw_n, kw = warp % kw_n;
  const int mine = min(RT, rows - bg * RT);  // the same in a whole warp
  if (mine <= 0) return;
  float acc[RT * CG];
#pragma unroll
  for (int e = 0; e < RT * CG; ++e) acc[e] = 0.f;
  const float* w = w_s + static_cast<size_t>(cg) * plane_stride(hdim);
  const T* d = d_s + static_cast<size_t>(bg) * RT * hdim;
  fma_live<RT>(mine, acc, w, d, hdim, kw * LK + kl, kw_n * LK);
  if (SAVE) {
    float* dst = red_s + static_cast<size_t>(kw * LK + kl) *
                             red_stride<true, RT>(kw_n) + bg * RT * COLS +
                 cg * CG;
#pragma unroll
    for (int i = 0; i < RT; ++i)
      if (i < mine)
        *reinterpret_cast<float4*>(dst + i * COLS) =
            make_float4(acc[i * CG], acc[i * CG + 1], acc[i * CG + 2],
                        acc[i * CG + 3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (i < mine)
#pragma unroll
      for (int j = 0; j < CG; ++j)
#pragma unroll
        for (int m = 1; m < LK; m *= 2)
          acc[i * CG + j] += __shfl_xor_sync(0xffffffffu, acc[i * CG + j], m);
  // every lane of the group holds the sums: lane kl stores rows kl mod LK
  float* dst = red_s + (static_cast<size_t>(kw) * (WARPS / kw_n) * RT +
                        bg * RT) * COLS + cg * CG;
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (i < mine && i % LK == kl)
      *reinterpret_cast<float4*>(dst + i * COLS) =
          make_float4(acc[i * CG], acc[i * CG + 1], acc[i * CG + 2],
                      acc[i * CG + 3]);
}

// The step loop of the tagged words (B <= TAGGED_MAX_B).  Warp w owns unit
// u0 + w, all four of its gates (plane w of w_s); lane (rg, kg) sums row
// rg over k = kg modulo KG (RG x KG = 32 lanes, RG the batch rounded up to
// a power of two), the KG lanes of a row meet in a butterfly, and lane
// (rg, 0) runs the cell of (rg, unit) with its c in a register.  d_s holds
// two row buffers, by the parity of t, so one block barrier per step
// suffices: a warp still multiplying step t reads the other buffer than
// the one step t+1 is staged into, and no thread stages step t+2 before
// every warp has passed step t+1's barrier.
template <typename T, bool TANH, int NDIRS, bool SAVE>
__device__ void scan_words(const T* __restrict__ xp, const T* __restrict__ c0,
                           const T* __restrict__ h0, T* hs,
                           const Saved<T>& saved, unsigned long long* xch,
                           const float* w_s, T* d_s, int n_steps, int batch,
                           int hdim) {
  const int dir = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, unit = blockIdx.x * UNITS + warp;
  const int g4 = 4 * hdim;
  const size_t bh = static_cast<size_t>(batch) * hdim;
  int rg_n = 1;
  while (rg_n < batch) rg_n *= 2;
  const int kg_n = 32 / rg_n, rg = lane / kg_n, kg = lane % kg_n;
  const bool live = rg < batch && unit < hdim;
  const bool owner = live && kg == 0;  // runs the cell of (rg, unit)
  float c = owner ? to_f32(c0[dir * bh + rg * hdim + unit]) : 0.f;
  const float* w = w_s + static_cast<size_t>(warp) * plane_stride(hdim);
  const size_t buf = row_bytes<T>(batch, hdim) / sizeof(T);
  for (int t = 0; t < n_steps; ++t) {
    const size_t row = (static_cast<size_t>(t) * NDIRS + dir) * batch + rg;
    // gate inputs, in flight during the poll
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (owner) gate_inputs(a, xp + row * g4 + unit, hdim);
    const unsigned long long* w_in =
        xch + (static_cast<size_t>((t + 1) % 2) * NDIRS + dir) * bh;
    T* d = d_s + (t % 2) * buf;
    if (t == 0)
      stage_values(d, h0 + dir * bh, batch * hdim);
    else
      stage_tagged(d, w_in, t - 1, batch * hdim);
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const T* dr = d + rg * hdim;
#pragma unroll 4
      for (int k = kg; k < hdim; k += kg_n) {
        const float4 w4 = *reinterpret_cast<const float4*>(w + k * CG);
        const float v = to_f32(dr[k]);
        acc[0] = fmaf(v, w4.x, acc[0]);
        acc[1] = fmaf(v, w4.y, acc[1]);
        acc[2] = fmaf(v, w4.z, acc[2]);
        acc[3] = fmaf(v, w4.w, acc[3]);
      }
    }
    for (int m = 1; m < kg_n; m *= 2)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], m);
    if (owner) {
#pragma unroll
      for (int g = 0; g < 4; ++g) a[g] += acc[g];
      const T h = cell<T, TANH, SAVE>(a, c, saved, row, unit, hdim);
      hs[row * hdim + unit] = h;
      store_tagged(xch + (static_cast<size_t>(t % 2) * NDIRS + dir) * bh +
                       rg * hdim + unit,
                   tagged(to_f32(h), t));
    }
  }
}

// The step loop of the flags (B > TAGGED_MAX_B): the row is hs[t-1]
// itself, staged PASS rows at a time and multiplied by row_product; the
// thread of each (row, unit) pair adds red_s over the warps (SAVE: over
// the classes), in their order, to the gate inputs and runs the cell, its
// c in c_s.
template <typename T, bool TANH, int NDIRS, bool SAVE>
__device__ void scan_flags(const T* __restrict__ xp, const T* __restrict__ h0,
                           T* hs, const Saved<T>& saved, int* flags,
                           const float* w_s, T* d_s, float* red_s, float* c_s,
                           int n_steps, int batch, int hdim) {
  constexpr int RT = row_tile<T, NDIRS, SAVE>();
  const int dir = blockIdx.y, tid = threadIdx.x, u0 = blockIdx.x * UNITS;
  const int g4 = 4 * hdim;
  const size_t bh = static_cast<size_t>(batch) * hdim;
  // this thread's first (row, unit) pair: e = tid of the first pass
  const int r0 = tid / UNITS, unit0 = u0 + tid % UNITS;
  const bool own0 = tid < min(batch, PASS) * UNITS && unit0 < hdim;
  for (int t = 0; t < n_steps; ++t) {
    const size_t row_t = (static_cast<size_t>(t) * NDIRS + dir) * batch;
    // gate inputs of the first pair, in flight during the first poll
    float x0[4] = {0.f, 0.f, 0.f, 0.f};
    if (own0) gate_inputs(x0, xp + (row_t + r0) * g4 + unit0, hdim);
    const T* h_in = t == 0 ? h0 + dir * bh : hs + (row_t - NDIRS * batch) *
                                                      hdim;
    if (t > 0) {
      wait_flags(flags, t - 1);
      __syncthreads();
    }
    for (int p0 = 0; p0 < batch; p0 += PASS) {
      const int rows = min(PASS, batch - p0);
      stage_values(d_s, h_in + static_cast<size_t>(p0) * hdim, rows * hdim);
      __syncthreads();
      row_product<SAVE, RT>(d_s, w_s, red_s, rows, hdim);
      __syncthreads();  // red_s complete; d_s free for the next pass
      const int kw_n = k_warps<RT>(rows);
      const int nq = SAVE ? kw_n * LK : kw_n;
      const int ld = red_stride<SAVE, RT>(kw_n);
      for (int e = tid; e < rows * UNITS; e += THREADS) {
        const int r = e / UNITS, u = e % UNITS, unit = u0 + u, b = p0 + r;
        if (unit >= hdim) continue;
        float a[4] = {x0[0], x0[1], x0[2], x0[3]};
        if (p0 > 0 || e != tid) gate_inputs(a, xp + (row_t + b) * g4 + unit,
                                            hdim);
        const float* part = red_s + r * COLS + u * CG;
        for (int q = 0; q < nq; ++q) {
          const float4 p = *reinterpret_cast<const float4*>(part + q * ld);
          a[0] += p.x;
          a[1] += p.y;
          a[2] += p.z;
          a[3] += p.w;
        }
        hs[(row_t + b) * hdim + unit] = cell<T, TANH, SAVE>(
            a, c_s[b * UNITS + u], saved, row_t + b, unit, hdim);
      }
    }
    publish(flags, t);
  }
}

template <typename T, bool TANH, int NDIRS, bool SAVE>
__global__ void __launch_bounds__(THREADS)
lstm_scan_lean_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                      const T* __restrict__ c0, const T* __restrict__ h0,
                      T* hs, T* __restrict__ cs, T* __restrict__ acts,
                      unsigned long long* xch, int n_steps, int batch,
                      int hdim) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const bool words = batch <= TAGGED_MAX_B;
  const int ps = plane_stride(hdim);
  float* w_s = smem;  // [UNITS][plane_stride]
  T* d_s = reinterpret_cast<T*>(w_s + UNITS * ps);
  float* red_s = reinterpret_cast<float*>(
      reinterpret_cast<char*>(d_s) + (words ? 2 : 1) *
                                         row_bytes<T>(batch, hdim));
  float* c_s = red_s + red_floats<SAVE>();  // [B][UNITS]
  const Saved<T> saved{cs, acts};

  const int dir = blockIdx.y;
  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x;
  const int g4 = 4 * hdim;
  const size_t bh = static_cast<size_t>(batch) * hdim;
  int* flags = reinterpret_cast<int*>(xch) + dir * gridDim.x;  // values

  if (words) {
    const size_t n = 2 * NDIRS * bh;
    for (size_t e = (static_cast<size_t>(blockIdx.y) * gridDim.x +
                     blockIdx.x) * THREADS + tid;
         e < n; e += static_cast<size_t>(gridDim.x) * NDIRS * THREADS)
      xch[e] = ~0ull;  // no step's tag
  } else if (tid == 0) {
    flags[blockIdx.x] = -1;
  }
  // resident planes, one per unit: gate g of unit u0 + u at
  // w_s[u * plane_stride + k * 4 + g]
  const T* whd = wh + static_cast<size_t>(dir) * hdim * g4;
  for (int e = tid; e < hdim * COLS; e += THREADS) {
    const int k = e / COLS, u = e % COLS % UNITS, g = e % COLS / UNITS;
    const int unit = u0 + u;
    w_s[u * ps + k * CG + g] =
        unit < hdim ? to_f32(whd[static_cast<size_t>(k) * g4 + g * hdim +
                                 unit])
                    : 0.f;
  }
  if (!words)
    for (int e = tid; e < batch * UNITS; e += THREADS) {
      const int b = e / UNITS, unit = u0 + e % UNITS;
      c_s[e] = unit < hdim ? to_f32(c0[dir * bh + b * hdim + unit]) : 0.f;
    }
  grid.sync();  // tags and flags cleared everywhere; the staging syncs

  if (words)
    scan_words<T, TANH, NDIRS, SAVE>(xp, c0, h0, hs, saved, xch, w_s, d_s,
                                     n_steps, batch, hdim);
  else
    scan_flags<T, TANH, NDIRS, SAVE>(xp, h0, hs, saved, flags, w_s, d_s,
                                     red_s, c_s, n_steps, batch, hdim);
}

template <typename T, bool TANH, int NDIRS, bool SAVE>
int launch(const void* xp, const void* wh, const void* c0, const void* h0,
           void* hs, void* cs, void* acts, void* xch, int n_steps,
           int batch, int hdim, cudaStream_t stream) {
  auto kernel = lstm_scan_lean_kernel<T, TANH, NDIRS, SAVE>;
  const size_t smem = smem_bytes<T, SAVE>(batch, hdim);
  const dim3 grid((hdim + UNITS - 1) / UNITS, NDIRS);
  const int fit = cooperative_fit(kernel, grid, THREADS, smem);
  if (fit != 0) return fit;  // never degrade: the polls would hang

  const T* xp_ = static_cast<const T*>(xp);
  const T* wh_ = static_cast<const T*>(wh);
  const T* c0_ = static_cast<const T*>(c0);
  const T* h0_ = static_cast<const T*>(h0);
  T* hs_ = static_cast<T*>(hs);
  T* cs_ = static_cast<T*>(cs);
  T* acts_ = static_cast<T*>(acts);
  unsigned long long* xch_ = static_cast<unsigned long long*>(xch);
  void* args[] = {&xp_,  &wh_,     &c0_,   &h0_,  &hs_, &cs_,
                  &acts_, &xch_, &n_steps, &batch, &hdim};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, dim3(THREADS), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// NDIRS directions, SAVE: also cs and acts (null in the lean forward)
template <int NDIRS, bool SAVE>
int dispatch(const void* xp, const void* wh, const void* c0, const void* h0,
             void* hs, void* cs, void* acts, void* xch, int n_steps,
             int batch, int hdim, int dtype, int tanh_cand, void* stream) {
  if (n_steps <= 0 || batch <= 0 || hdim <= 0 || (dtype != 0 && dtype != 1)
      || reinterpret_cast<size_t>(xch) % 8 != 0)
    return DANET_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tanh_cand ? launch<float, true, NDIRS, SAVE>(
                           xp, wh, c0, h0, hs, cs, acts, xch, n_steps, batch,
                           hdim, s)
                     : launch<float, false, NDIRS, SAVE>(
                           xp, wh, c0, h0, hs, cs, acts, xch, n_steps, batch,
                           hdim, s);
  return tanh_cand ? launch<__nv_bfloat16, true, NDIRS, SAVE>(
                         xp, wh, c0, h0, hs, cs, acts, xch, n_steps, batch,
                         hdim, s)
                   : launch<__nv_bfloat16, false, NDIRS, SAVE>(
                         xp, wh, c0, h0, hs, cs, acts, xch, n_steps, batch,
                         hdim, s);
}

}  // namespace

// Kernel B.  dtype: 0 = float32, 1 = bfloat16 (every tensor of the call).
// xch [2, 2, B, H] of 8-byte words is scratch.
extern "C" int danet_bilstm_scan(const void* xp, const void* wh,
                                 const void* c0, const void* h0, void* hs,
                                 void* xch, int n_steps, int batch, int hdim,
                                 int dtype, int tanh_cand, void* stream) {
  return dispatch<2, false>(xp, wh, c0, h0, hs, nullptr, nullptr, xch,
                            n_steps, batch, hdim, dtype, tanh_cand, stream);
}

// Kernel B with one direction (lstm_scan_pallas): xp [T, B, 4H],
// wh [H, 4H], c0/h0 [B, H] -> hs [T, B, H]; xch [2, 1, B, H].
extern "C" int danet_lstm_scan(const void* xp, const void* wh,
                               const void* c0, const void* h0, void* hs,
                               void* xch, int n_steps, int batch, int hdim,
                               int dtype, int tanh_cand, void* stream) {
  return dispatch<1, false>(xp, wh, c0, h0, hs, nullptr, nullptr, xch,
                            n_steps, batch, hdim, dtype, tanh_cand, stream);
}

// Kernel 2, the saving forward with two directions (bilstm_scan_pallas
// under its custom VJP): also cs [T, 2, B, H] and acts [T, 2, B, 4H] =
// [cand, i, f, o]; xch [2, 2, B, H].
extern "C" int danet_bilstm_scan_train(const void* xp, const void* wh,
                                       const void* c0, const void* h0,
                                       void* hs, void* cs, void* acts,
                                       void* xch, int n_steps, int batch,
                                       int hdim, int dtype, int tanh_cand,
                                       void* stream) {
  return dispatch<2, true>(xp, wh, c0, h0, hs, cs, acts, xch, n_steps,
                           batch, hdim, dtype, tanh_cand, stream);
}

// The saving forward with one direction (lstm_scan_pallas under its custom
// VJP): also cs [T, B, H] and acts [T, B, 4H] = [cand, i, f, o];
// xch [2, 1, B, H].
extern "C" int danet_lstm_scan_train(const void* xp, const void* wh,
                                     const void* c0, const void* h0,
                                     void* hs, void* cs, void* acts,
                                     void* xch, int n_steps, int batch,
                                     int hdim, int dtype, int tanh_cand,
                                     void* stream) {
  return dispatch<1, true>(xp, wh, c0, h0, hs, cs, acts, xch, n_steps,
                           batch, hdim, dtype, tanh_cand, stream);
}

// The row ceiling of one forward launch at H = hdim (the same for one and
// two directions): the largest batch whose shared memory fits the device's
// opt-in, written to *rows.  save: the saving forward.  The wrapper splits a
// larger batch into launches of at most that many rows.
extern "C" int danet_lstm_scan_max_rows(int save, int hdim, int dtype,
                                        int* rows) {
  if (hdim <= 0 || (dtype != 0 && dtype != 1) || rows == nullptr)
    return DANET_BAD_ARGUMENT;
  if (dtype == 0)
    return save ? max_rows_fitting(
                      [=](int b) { return smem_bytes<float, true>(b, hdim); },
                      rows)
                : max_rows_fitting(
                      [=](int b) { return smem_bytes<float, false>(b, hdim); },
                      rows);
  return save ? max_rows_fitting(
                    [=](int b) {
                      return smem_bytes<__nv_bfloat16, true>(b, hdim);
                    },
                    rows)
              : max_rows_fitting(
                    [=](int b) {
                      return smem_bytes<__nv_bfloat16, false>(b, hdim);
                    },
                    rows);
}
