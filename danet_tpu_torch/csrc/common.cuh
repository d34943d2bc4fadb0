// Shared by the port's kernels: status codes of the C entry points, and
// the storage-type helpers of the BiLSTM scan kernels.
//
// Every entry point returns 0 on success, a cudaError_t value when the
// runtime refused or failed the launch (cudaGetLastError right after it),
// or one of the negative codes below for a request the kernel does not
// take.  danet_error_string() turns any of them into text.
#pragma once

#include <cuda_bf16.h>
#include <initializer_list>
#include <cuda_runtime.h>

enum DanetStatus : int {
  DANET_BAD_ARGUMENT = -1,
  DANET_NOT_RESIDENT = -2,   // cooperative grid does not fit on the card
  DANET_SMEM_TOO_LARGE = -3, // a block needs more shared memory than exists
};

// Storage type <-> float32 (the scans store f32 or bf16, compute in f32).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// L2-coherent loads of values other blocks wrote during this launch
// (ld.global.cg: never a stale L1 line).
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// Asynchronous 16-byte copies from device to shared memory through L2 only
// (cp.async.cg: like ld.global.cg, never an L1 line, so values other blocks
// wrote during this launch are read fresh).  Both addresses 16-byte
// aligned.  A thread's copies since its last commit form one group;
// cp_async_wait<N> returns once at most N of its groups are in flight.
__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}
// A copy of N = 4, 8 or 16 bytes through L1 (cp.async.ca), where the
// overlapping reads of one block hit; both addresses N-byte aligned; the
// same groups as above.
template <int N>
__device__ __forceinline__ void cp_async_ca(void* smem_dst,
                                            const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem_src), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The rows [*b0, *b1) of row group g of `groups` (grid.z of the LSTM
// scans): the batch's passes of `pass` rows, ceil(batch / pass) of them,
// split as evenly as whole passes allow (group g takes passes g P / G up
// to (g + 1) P / G), so that every group but the last is a whole number
// of passes and every pass holds the rows it holds in one group.  Every
// group is non-empty for groups <= P.
__host__ __device__ __forceinline__ void row_group(int batch, int pass,
                                                   int groups, int g,
                                                   int* b0, int* b1) {
  const long passes = (batch + pass - 1) / pass;
  *b0 = static_cast<int>(g * passes / groups) * pass;
  const int end = static_cast<int>((g + 1) * passes / groups) * pass;
  *b1 = end < batch ? end : batch;
}

// The rows each block's shared memory holds: ceil(P / G) passes, at most
// the batch (at least the rows of every group of row_group).
__host__ __device__ __forceinline__ int group_rows(int batch, int pass,
                                                  int groups) {
  const int passes = (batch + pass - 1) / pass;
  const int most = (passes + groups - 1) / groups * pass;
  return most < batch ? most : batch;
}

// The shared memory one block of the current device may opt in to.
inline int smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  return static_cast<int>(err);
}

// The row ceiling of a kernel whose shared memory, bytes(batch), grows with
// the batch: the largest batch that fits the device's opt-in, written to
// *rows (0 when not even one row fits).  Returns 0 or a cudaError_t.
template <typename Bytes>
inline int max_rows_fitting(Bytes bytes, int* rows) {
  int optin = 0;
  const int status = smem_optin(&optin);
  if (status != 0) return status;
  int lo = 0, hi = 1 << 24;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (bytes(mid) <= static_cast<size_t>(optin))
      lo = mid;
    else
      hi = mid - 1;
  }
  *rows = lo;
  return 0;
}

// The blocks of `kernel` (of `threads` threads and `smem` bytes of dynamic
// shared memory, its opt-in set to that) one SM holds at once, written to
// *blocks.  Returns 0 or a cudaError_t.
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel, int threads, size_t smem,
                         int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        threads, smem);
  return static_cast<int>(err);
}

// The fewest blocks per SM of `kernels` (each of `threads` threads and
// `smem` bytes of dynamic shared memory), written to *blocks; a smem above
// the device's opt-in returns DANET_SMEM_TOO_LARGE.
template <typename... Kernels>
inline int fewest_blocks_per_sm(int threads, size_t smem, int* blocks,
                                Kernels... kernels) {
  int optin = 0, fewest = 1 << 30, status = smem_optin(&optin);
  if (status != 0) return status;
  if (smem > static_cast<size_t>(optin)) return DANET_SMEM_TOO_LARGE;
  for (auto kernel : {reinterpret_cast<const void*>(kernels)...}) {
    int n = 0;
    status = blocks_per_sm(kernel, threads, smem, &n);
    if (status != 0) return status;
    fewest = n < fewest ? n : fewest;
  }
  *blocks = fewest;
  return 0;
}

// Launch checks of a cooperative kernel: the device's opt-in shared memory
// and whether every block of `grid` can be resident at once.  Returns 0,
// a cudaError_t, or DANET_SMEM_TOO_LARGE / DANET_NOT_RESIDENT (never
// degrade: a grid barrier over blocks that are not all resident hangs).
template <typename Kernel>
inline int cooperative_fit(Kernel kernel, dim3 grid, int threads,
                           size_t smem) {
  int device = 0, optin = 0, n_sm = 0, per_sm = 0;
  const int status = smem_optin(&optin);
  if (status != 0) return status;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return DANET_SMEM_TOO_LARGE;
  const int fit = blocks_per_sm(kernel, threads, smem, &per_sm);
  if (fit != 0) return fit;
  if (static_cast<long>(per_sm) * n_sm <
      static_cast<long>(grid.x) * grid.y * grid.z)
    return DANET_NOT_RESIDENT;
  return 0;
}
