// Kernel A: fused framing + windowed DFT (the STFT front of separate_wav).
//
// Replaces danet_tpu/ops/pallas/stft.py::_stft_pallas_padded.
//
//   out[b, t, c] = sum_n frame(b, t, n) * basis[n, c],   c < 2F
//   frame(b, t, n) = x[b, t*stride + n - fft/2]  (0 outside [0, L))
//
// With LOGMAG (kernel 6, the feature epilogue of stft_ri_pallas with
// logmag=True) each (re, im) column pair becomes (|Z|, log1p|Z|) in the
// same [F, 2] layout.  The basis columns are interleaved (2f = real, 2f+1 =
// imag, window and 1/sum(window) folded in), so each output row of 2F
// floats IS the ri layout [F, 2] and no stack pass follows; a thread owns
// whole (re, im) pairs, so the LOGMAG epilogue needs nothing from another
// thread.  scipy's boundary padding (fft/2 zeros each side) and end
// padding are folded into the copies: no padded or framed copy of the wave
// exists in device memory.
//
// What bounds it on this card: the request (10 s of 8 kHz audio, B=1) is
// [1251, 256] x [256, 258], 82.6 M FMAs: 2.5 us at the float32 FMA rate
// of 132 SMs, against 0.3 MB of wave in and 1.3 MB of spectrum out (0.5 us
// at the HBM rate; all of it L2-resident).  The math stays float32 on the
// FMAs (TF32 cannot meet the 2e-5 parity bar).  The earlier design, a
// plain shared-memory SGEMM of 100 blocks whose 16 contraction steps each
// waited a full L2 round trip for index-arithmetic loads, took 28 us of
// device time on an H100; this one takes 12 us (PERF.md), of which the
// products are about 8 and the copies about 2 (perf_probe.py stft --cut):
//
//   * Grid: one block per 24 or 32 frames x one column block of one wave.
//     The 2F columns are split into blocks of 64, and the Nyquist pair
//     that 2F = fft + 2 leaves over (258 = 4 x 64 + 2) is folded into the
//     last block (64, 64, 64 and 66 columns at fft 256), so no block is
//     mostly idle.  Of 32 and 24 frames, the launch takes the count that
//     puts the fewest frames on the busiest SM: 24 for the request (53 x
//     4 = 212 blocks, at most 2 per SM; 32 frames gave 160 blocks, 28 SMs
//     with two, 12-15 % slower), 32 at 4 x 4 s (256 blocks; 24 frames
//     gave 336, 56 % slower).  A remainder of more than 2 columns (an fft
//     that is not a multiple of 64) gets a block of its own.
//   * The wave: each of the block's frames, which overlap in one
//     contiguous span of the wave (2,240 samples at 32 frames of stride
//     64), is copied by one warp into a frame-major row of shared memory,
//     by 16-byte cp.async.ca where the frame lies inside the wave and
//     starts 16-byte aligned, else by 4-byte copies with zeros written
//     outside [0, L) (a wave row may start anywhere: B rows of an odd L).
//     The overlapping reads hit L1.  The row pitch is an odd number of
//     16-byte units, so the 16-byte reads of 8 frames hit 8 distinct bank
//     groups.  Frame-major rows work for any stride: the shared memory
//     does not grow with it.
//   * The basis: a kernel layout built once by the wrapper and cached
//     (ops/cuda/stft.py), [column block][fft (rounded up to 4)][68] f32,
//     16-byte aligned rows: the block's 64 columns, the folded pair, zero
//     padding.  The block issues its slice up front in chunks of 64 rows,
//     one cp.async group each (all four at fft 256: 68 KB), and the
//     contraction on chunk c starts as soon as chunk c has landed.  Where
//     the slice does not fit (fft above 512), chunks cycle through a ring
//     of up to 8 slots.
//   * Products: 4 warps of 8 frame lanes x 4 column quads, each thread 3
//     or 4 frames (8 apart) x 4 columns, reading 4 samples of a frame and
//     4 columns of a basis row per 16-byte shared load: 8 loads per 64
//     FMAs, each a single wavefront.  A fifth warp computes the folded
//     pair of the last column block, one frame per lane.  Where even one
//     ring slot and 24 frames do not fit (fft above about 2,200), the
//     block takes 8 frames.
//
// Each output sums n = 0 .. fft-1 in increasing order in one fmaf chain
// from 0, and the LOGMAG epilogue is sqrtf(re*re + im*im) and log1pf as
// before, so the outputs are bit for bit the earlier design's.
#include "common.cuh"

namespace {

constexpr int BN = 64;              // columns of a block's main tile
constexpr int BW = BN + 4;          // basis row: the tile, a pair, padding
constexpr int KC = 64;              // basis rows per cp.async group
constexpr int MAX_SLOTS = 8;        // chunks resident at once
constexpr int MAIN = 128;           // threads of the main tile
constexpr int THREADS = MAIN + 32;  // and one warp for the folded pair

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Row pitch (floats) of a frame in shared memory: at least fft4, an odd
// number of 16-byte units.
__host__ __device__ constexpr int frame_pitch(int fft4) {
  return fft4 / 4 % 2 ? fft4 : fft4 + 4;
}

// Column blocks of a 2F-column output: 64 each, a remainder of 2 folded
// into the last one (the layout ops/cuda/stft.py builds).
inline int col_blocks(int n_cols) {
  const int full = n_cols / BN;
  return full == 0 || n_cols % BN > 2 ? full + 1 : full;
}

// Wait until at most n (0 .. 7) of this thread's cp.async groups are in
// flight.
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Issue the copies of frames m0 .. m0 + BM - 1 of wave xb into a_s[BM][pitch]
// (samples n < fft4; zero outside the wave and at n >= fft), one warp per
// frame: 16-byte copies where the frame lies inside the wave and its first
// sample is 16-byte aligned, else 4-byte copies and zeros.
template <int BM>
__device__ __forceinline__ void stage_frames(float* a_s, const float* xb,
                                             int length, int m0, int fft,
                                             int fft4, int stride,
                                             int pitch) {
  const int lane = threadIdx.x % 32;
  for (int f = threadIdx.x / 32; f < BM; f += THREADS / 32) {
    const long long s0 = static_cast<long long>(m0 + f) * stride - fft / 2;
    float* dst = a_s + f * pitch;
    if (s0 >= 0 && s0 + fft4 <= length && fft == fft4 &&
        reinterpret_cast<size_t>(xb + s0) % 16 == 0) {
      for (int q = 4 * lane; q < fft4; q += 128)
        cp_async_ca<16>(dst + q, xb + s0 + q);
    } else {
      for (int n = lane; n < fft4; n += 32) {
        const long long s = s0 + n;
        if (n < fft && s >= 0 && s < length)
          cp_async_ca<4>(dst + n, xb + s);
        else
          dst[n] = 0.f;
      }
    }
  }
}

// The four floats of a 16-byte shared load, as an array.
__device__ __forceinline__ void load4(float (&out)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// acc[i][j] += sum over `rows` samples n (from a and b) of
// frame(ty + 8 i)[n] * basis[n][4 cq + j], n in increasing order: a is
// frame ty's row at the chunk's first sample, b the chunk's first basis
// row at column 4 cq.
template <int TM>
__device__ __forceinline__ void contract(float (&acc)[TM][4], const float* a,
                                         int pitch, const float* b,
                                         int rows) {
#pragma unroll 2
  for (int k = 0; k < rows; k += 4) {
    float av[TM][4], bv[4][4];  // [frame][sample], [sample][column]
#pragma unroll
    for (int i = 0; i < TM; ++i) load4(av[i], a + 8 * i * pitch + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) load4(bv[e], b + (k + e) * BW);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i][e], bv[e][j], acc[i][j]);
  }
}

// The folded pair: acc[j] += sum_n frame[n] * basis[n][BN + j], one frame.
__device__ __forceinline__ void contract_pair(float (&acc)[2], const float* a,
                                              const float* b, int rows) {
#pragma unroll 2
  for (int k = 0; k < rows; k += 4) {
    float av[4];
    load4(av, a + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 bv = *reinterpret_cast<const float2*>(b + (k + e) * BW);
      acc[0] = fmaf(av[e], bv.x, acc[0]);
      acc[1] = fmaf(av[e], bv.y, acc[1]);
    }
  }
}

// One (re, im) pair of an output row, or with LOGMAG (|Z|, log1p|Z|).
template <bool LOGMAG>
__device__ __forceinline__ void store_pair(float* dst, float re, float im) {
  if (LOGMAG) {
    const float mag = sqrtf(re * re + im * im);
    *reinterpret_cast<float2*>(dst) = make_float2(mag, log1pf(mag));
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(re, im);
  }
}

template <bool LOGMAG, int TM>
__global__ void __launch_bounds__(THREADS, 2)
stft_ri_kernel(const float* __restrict__ x, const float* __restrict__ basis,
               float* __restrict__ out, int length, int n_frames,
               int fft_size, int stride, int n_cols, int slots) {
  constexpr int BM = 8 * TM;  // frames per block
  extern __shared__ __align__(16) float smem[];
  const int fft4 = round4(fft_size), pitch = frame_pitch(fft4);
  const int n_chunks = (fft4 + KC - 1) / KC;
  float* a_s = smem;               // [BM][pitch]: frame m0 + f, sample n
  float* b_s = a_s + BM * pitch;   // [slots][KC][BW]: basis rows

  const int cb = blockIdx.x, m0 = blockIdx.y * BM, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* bk = basis + static_cast<size_t>(cb) * fft4 * BW;
  auto issue = [&](int c) {  // basis rows of chunk c into its slot
    const int r0 = c * KC, vecs = min(KC, fft4 - r0) * (BW / 4);
    float* dst = b_s + c % slots * KC * BW;
    const float* src = bk + static_cast<size_t>(r0) * BW;
    for (int e = tid; e < vecs; e += THREADS)
      cp_async16(dst + 4 * e, src + 4 * e);
    cp_async_commit();
  };
  // the frames land with the first chunk (one group), then one group per
  // chunk
  stage_frames<BM>(a_s, x + static_cast<size_t>(b) * length, length, m0,
                   fft_size, fft4, stride, pitch);
  for (int c = 0; c < min(slots, n_chunks); ++c) issue(c);

  // main tile: frames ty + 8 i, columns 4 cq .. 4 cq + 3 of the block
  const int ty = lane / 4, cq = warp * 4 + lane % 4;
  // the folded pair: the last block's columns BN, BN + 1, frame `lane`
  const bool pair = warp == MAIN / 32 && lane < BM &&
                    cb == static_cast<int>(gridDim.x) - 1 &&
                    n_cols - cb * BN > BN;
  float acc[TM][4], acc2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    wait_groups(min(n_chunks, c + slots) - c - 1);  // chunk c (and frames)
    __syncthreads();                                // ... everywhere
    const float* bc = b_s + c % slots * KC * BW;
    const int r0 = c * KC, rows = min(KC, fft4 - r0);
    if (warp < MAIN / 32)
      contract<TM>(acc, a_s + ty * pitch + r0, pitch, bc + 4 * cq, rows);
    else if (pair)
      contract_pair(acc2, a_s + lane * pitch + r0, bc + BN, rows);
    if (c + slots < n_chunks) {
      __syncthreads();  // the slot is free
      issue(c + slots);
    }
  }

  float* ob = out + static_cast<size_t>(b) * n_frames * n_cols;
  if (warp < MAIN / 32) {
    const int col = cb * BN + 4 * cq;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int frame = m0 + ty + 8 * i;
      if (frame >= n_frames) continue;
      float* row = ob + static_cast<size_t>(frame) * n_cols + col;
#pragma unroll
      for (int j = 0; j < 4; j += 2)  // n_cols is even: whole pairs
        if (col + j < n_cols) store_pair<LOGMAG>(row + j, acc[i][j],
                                                 acc[i][j + 1]);
    }
  } else if (pair && m0 + lane < n_frames) {
    store_pair<LOGMAG>(
        ob + static_cast<size_t>(m0 + lane) * n_cols + cb * BN + BN,
        acc2[0], acc2[1]);
  }
}

template <bool LOGMAG, int TM>
int launch(const float* x, const float* basis, float* out, int batch,
           int length, int n_frames, int fft_size, int stride, int n_cols,
           int slots, size_t smem, cudaStream_t stream) {
  const dim3 grid(col_blocks(n_cols), (n_frames + 8 * TM - 1) / (8 * TM),
                  batch);
  if (grid.y > 65535) return DANET_BAD_ARGUMENT;
  const cudaError_t err = cudaFuncSetAttribute(
      stft_ri_kernel<LOGMAG, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stft_ri_kernel<LOGMAG, TM><<<grid, THREADS, smem, stream>>>(
      x, basis, out, length, n_frames, fft_size, stride, n_cols, slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [batch, length] f32 (any 4-byte alignment); basis the kernel layout
// [col_blocks(n_cols)][fft_size rounded up to 4][68] f32, 16-byte aligned
// (ops/cuda/stft.py builds it from the interleaved re/im basis); out
// [batch, n_frames, n_cols] f32, 8-byte aligned: (re, im) per bin, or with
// `logmag` (|Z|, log1p|Z|).  Launches on `stream`; no sync.
extern "C" int danet_stft_ri(const void* x, const void* basis, void* out,
                             int batch, int length, int n_frames,
                             int fft_size, int stride, int n_cols,
                             int logmag, void* stream) {
  if (batch <= 0 || length <= 0 || n_frames <= 0 || fft_size <= 0 ||
      stride <= 0 || n_cols <= 0 || n_cols % 2 != 0 || batch > 65535 ||
      reinterpret_cast<size_t>(basis) % 16 != 0 ||
      reinterpret_cast<size_t>(out) % 8 != 0)
    return DANET_BAD_ARGUMENT;
  int device = 0, optin = 0, n_sm = 0;
  int status = smem_optin(&optin);
  if (status == 0) status = static_cast<int>(cudaGetDevice(&device));
  if (status == 0)
    status = static_cast<int>(cudaDeviceGetAttribute(
        &n_sm, cudaDevAttrMultiProcessorCount, device));
  if (status != 0) return status;
  // Frames per block 8 tm: of 32 and 24, the one that puts the fewest
  // frames on the busiest SM (blocks per SM rounded up, times frames),
  // 32 on a tie; 8 only where neither fits.
  const int fft4 = round4(fft_size), pitch = frame_pitch(fft4);
  const int n_chunks = (fft4 + KC - 1) / KC;
  const long long tiles = static_cast<long long>(col_blocks(n_cols)) * batch;
  int best_tm = 0, best_slots = 0;
  long long best_load = 0;
  for (const int tm : {4, 3, 1}) {
    int slots = min(n_chunks, MAX_SLOTS);
    while (slots >= 1 && sizeof(float) * (8 * tm * pitch +
                                          static_cast<size_t>(slots) * KC *
                                              BW) >
                             static_cast<size_t>(optin))
      --slots;
    if (slots < 1) continue;
    const long long blocks = tiles * ((n_frames + 8 * tm - 1) / (8 * tm));
    const long long load = (blocks + n_sm - 1) / n_sm * tm;
    if (best_tm == 0 || (best_tm != 1 && tm != 1 && load < best_load)) {
      best_tm = tm;
      best_slots = slots;
      best_load = load;
    }
  }
  if (best_tm == 0) return DANET_SMEM_TOO_LARGE;
  const size_t smem =
      sizeof(float) * (8 * best_tm * pitch +
                       static_cast<size_t>(best_slots) * KC * BW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(basis);
  float* of = static_cast<float*>(out);
#define DANET_STFT_LAUNCH(LOGMAG, TM)                                       \
  launch<LOGMAG, TM>(xf, bf, of, batch, length, n_frames, fft_size, stride, \
                     n_cols, best_slots, smem, s)
  switch (best_tm) {
    case 4: return logmag ? DANET_STFT_LAUNCH(true, 4)
                          : DANET_STFT_LAUNCH(false, 4);
    case 3: return logmag ? DANET_STFT_LAUNCH(true, 3)
                          : DANET_STFT_LAUNCH(false, 3);
    default: return logmag ? DANET_STFT_LAUNCH(true, 1)
                           : DANET_STFT_LAUNCH(false, 1);
  }
#undef DANET_STFT_LAUNCH
}
