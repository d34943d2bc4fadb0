// Kernel A: fused framing + windowed DFT (the STFT front of separate_wav).
//
// Replaces danet_tpu/ops/pallas/stft.py::_stft_pallas_padded.
//
//   out[b, t, c] = sum_n frame(b, t, n) * basis[n, c],   c < 2F
//   frame(b, t, n) = x[b, t*stride + n - fft/2]  (0 outside [0, L))
//
// With LOGMAG (kernel 6, the feature epilogue of stft_ri_pallas with
// logmag=True) each (re, im) column pair becomes (|Z|, log1p|Z|) in the
// same [F, 2] layout; a thread then owns adjacent column pairs instead of
// columns 16 apart, so that both halves of a bin are in its registers.
//
// The frame is read by index arithmetic from the UNPADDED wave, which folds
// scipy's boundary padding (fft/2 zeros each side) and end padding into the
// load, so no padded or framed copy exists in device memory.  The basis
// columns are interleaved (2f = real, 2f+1 = imag, window and 1/sum(window)
// folded in), so each output row of 2F floats IS the ri layout [F, 2] and
// no stack pass follows.
//
// What bounds it on this card: at 10 s of 8 kHz audio the product is
// [1251, 256] x [256, 258] per wave, ~165 MFLOP, against 0.3 MB of input
// and 1.3 MB of output per wave -- all of it L2-resident.  The math is f32
// FMA (no TF32, no bf16: the parity bar is 2e-5), so the f32 CUDA-core
// rate and the launch latency are the limits, not bytes.  Design: a classic
// shared-memory tiled SGEMM, one block per 64 frames x 64 columns of one
// wave, 256 threads with a 4x4 register tile each; the 256-deep
// contraction runs in 16-deep shared-memory steps.  The ragged column edge
// (258 = 4*64 + 2), the ragged frame edge and the wave's ends are masked.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // frames per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // contraction depth per shared-memory step
constexpr int TM = 4;    // frames per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

// The output column of a thread's j-th accumulator: columns 16 apart, or
// with LOGMAG the pairs 2 tx + {0, 1} and 32 + 2 tx + {0, 1}.
template <bool LOGMAG>
__device__ __forceinline__ int out_col(int n0, int tx, int j) {
  return LOGMAG ? n0 + 2 * tx + (j & 1) + 32 * (j >> 1)
                : n0 + tx + j * (BN / TN);
}

template <bool LOGMAG>
__global__ void __launch_bounds__(THREADS)
stft_ri_kernel(const float* __restrict__ x, const float* __restrict__ basis,
               float* __restrict__ out, int length, int n_frames,
               int fft_size, int stride, int n_cols) {
  __shared__ float a_s[BK][BM + 1];  // frames, transposed; +1 avoids conflicts
  __shared__ float b_s[BK][BN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column lane: cols n0 + tx + 16*j
  const int ty = tid / (BN / TN);  // frame lane: frames m0 + ty + 16*i
  const int half = fft_size / 2;
  const float* xb = x + static_cast<size_t>(b) * length;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < fft_size; k0 += BK) {
    // frames: consecutive threads read consecutive samples of one frame
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int kk = e % BK, mm = e / BK;
      const int frame = m0 + mm, n = k0 + kk;
      const long s = static_cast<long>(frame) * stride + n - half;
      float v = 0.f;
      if (frame < n_frames && n < fft_size && s >= 0 && s < length)
        v = xb[s];
      a_s[kk][mm] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int n = k0 + kk, col = n0 + nn;
      b_s[kk][nn] = (n < fft_size && col < n_cols)
                        ? basis[static_cast<size_t>(n) * n_cols + col]
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_s[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b_s[kk][out_col<LOGMAG>(0, tx, j)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int frame = m0 + ty + i * (BM / TM);
    if (frame >= n_frames) continue;
    float* row = out + (static_cast<size_t>(b) * n_frames + frame) * n_cols;
    if (LOGMAG) {
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        const int col = out_col<LOGMAG>(n0, tx, j);  // even; n_cols is even
        if (col >= n_cols) continue;
        const float mag = sqrtf(acc[i][j] * acc[i][j] +
                                acc[i][j + 1] * acc[i][j + 1]);
        row[col] = mag;
        row[col + 1] = log1pf(mag);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = out_col<LOGMAG>(n0, tx, j);
        if (col < n_cols) row[col] = acc[i][j];
      }
    }
  }
}

}  // namespace

// x [batch, length] f32, basis [fft_size, n_cols] f32 (interleaved re/im),
// out [batch, n_frames, n_cols] f32: (re, im) per bin, or with `logmag`
// (|Z|, log1p|Z|).  Launches on `stream`; no sync.
extern "C" int danet_stft_ri(const void* x, const void* basis, void* out,
                             int batch, int length, int n_frames,
                             int fft_size, int stride, int n_cols,
                             int logmag, void* stream) {
  if (batch <= 0 || length <= 0 || n_frames <= 0 || fft_size <= 0 ||
      stride <= 0 || n_cols <= 0 || n_cols % 2 != 0 || batch > 65535)
    return DANET_BAD_ARGUMENT;
  const dim3 grid((n_cols + BN - 1) / BN, (n_frames + BM - 1) / BM, batch);
  if (grid.y > 65535) return DANET_BAD_ARGUMENT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(basis);
  float* of = static_cast<float*>(out);
  if (logmag)
    stft_ri_kernel<true><<<grid, THREADS, 0, s>>>(
        xf, bf, of, length, n_frames, fft_size, stride, n_cols);
  else
    stft_ri_kernel<false><<<grid, THREADS, 0, s>>>(
        xf, bf, of, length, n_frames, fft_size, stride, n_cols);
  return static_cast<int>(cudaGetLastError());
}
