// The exchange of rows between the blocks of one cooperative launch, shared
// by the scan kernels that pass no grid barrier in their time loop: the GRU
// forward and backward (gru_scan.cu, gru_scan_bwd.cu) and the LSTM forward
// (lstm_scan_lean.cu).  Each step, every block writes its units' slice of a
// row ([B, H] or wider) and then reads the whole row that all blocks wrote,
// through L2.  Two protocols:
//
//   * tagged words: each value travels with its step in one aligned 8-byte
//     word, stored with st.relaxed.gpu.b64 (single-copy atomic: value and
//     tag arrive together) and polled with ld.relaxed.gpu.b64 (coherent at
//     gpu scope, never a stale L1 line) until it carries the step's tag;
//     the data's arrival is the synchronisation, one L2 round trip;
//   * flags: the row is plain values of the storage type, and each block
//     publishes one flag after its values (block barrier, then one thread
//     __threadfence() and stores the step, as cooperative groups' grid
//     barrier does); a reader's threads poll the flags (ld.acquire.gpu),
//     pass a block barrier, then copy the row with 16-byte cp.async.cg
//     (through L2, all in flight at once; element loads where a row is not
//     16-byte aligned).
//
// A word or flag that does not arrive within SPIN_LIMIT polls traps (a
// launch failure the caller sees) rather than hanging the card.  Polling
// needs every block resident: the launches stay cooperative, and
// cooperative_fit refuses a grid that does not fit.
//
// A kernel file includes this header inside its anonymous namespace, after
// it defines THREADS (threads per block) and LOADS (polls in flight per
// thread), so that both stay constants of the file (perf_probe.py --set).
// The block between EMU-BEGIN and EMU-END is the only inline PTX of the
// protocol.

constexpr unsigned SPIN_LIMIT = 1u << 24;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// EMU-BEGIN
__device__ __forceinline__ void store_tagged(unsigned long long* p,
                                             unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}
__device__ __forceinline__ unsigned long long load_tagged(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}
__device__ __forceinline__ void store_flag(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int load_flag(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
// EMU-END

__device__ __forceinline__ unsigned long long tagged(float v, int t) {
  return static_cast<unsigned long long>(static_cast<unsigned>(t)) << 32 |
         __float_as_uint(v);
}

// n words of the exchange row `src` (tag `tag`) into d_s: thread tid polls
// words tid, tid + THREADS, ..., LOADS in flight before the first is
// waited for.
template <typename T>
__device__ __forceinline__ void stage_tagged(T* d_s,
                                             const unsigned long long* src,
                                             int tag, int n) {
  for (int e0 = threadIdx.x; e0 < n; e0 += THREADS * LOADS) {
    unsigned long long w[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int e = e0 + j * THREADS;
      if (e < n) w[j] = load_tagged(src + e);
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int e = e0 + j * THREADS;
      if (e >= n) continue;
      for (unsigned k = 0; static_cast<int>(w[j] >> 32) != tag; ++k) {
        if (k == SPIN_LIMIT) __trap();
        w[j] = load_tagged(src + e);
      }
      d_s[e] = from_f32<T>(__uint_as_float(static_cast<unsigned>(w[j])));
    }
  }
}

// n values of a row the launch wrote (or an initial state) into d_s,
// through L2: 16-byte cp.async.cg copies where `src` is 16-byte aligned,
// all in flight before the wait, else element loads.
template <typename T>
__device__ __forceinline__ void stage_values(T* d_s, const T* src, int n) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  int e0 = 0;
  if (reinterpret_cast<size_t>(src) % 16 == 0) {
    e0 = n / VEC * VEC;
    for (int c = threadIdx.x * VEC; c < e0; c += THREADS * VEC)
      cp_async16(d_s + c, src + c);
    cp_async_commit();
  }
  for (int e = e0 + threadIdx.x; e < n; e += THREADS)
    d_s[e] = from_f32<T>(load_cg(src + e));
  cp_async_wait<0>();
}

// `rows` rows of `width` values, row r at src + r * ld, into d_s [rows][sld]
// (sld a multiple of 16 bytes), through L2: warp w copies rows w, w +
// WARPS, ... by 16-byte cp.async.cg where its row is 16-byte aligned, else
// by element loads.  The copies form one cp.async group of the calling
// thread (committed, possibly empty); the caller waits for it
// (cp_async_wait) and then passes a block barrier.
template <typename T>
__device__ __forceinline__ void copy_rows(T* d_s, int sld, const T* src,
                                          size_t ld, int rows, int width) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < rows; r += THREADS / 32) {
    const T* s = src + r * ld;
    T* d = d_s + static_cast<size_t>(r) * sld;
    int e0 = 0;
    if (reinterpret_cast<size_t>(s) % 16 == 0) {
      e0 = width / VEC * VEC;
      for (int c = lane * VEC; c < e0; c += 32 * VEC) cp_async16(d + c, s + c);
    }
    for (int e = e0 + lane; e < width; e += 32)
      d[e] = from_f32<T>(load_cg(s + e));
  }
  cp_async_commit();
}

// Every flag of `flags` (one per block) at step t or later; the caller's
// block barrier then orders the row's reads after the flags' acquire.
__device__ __forceinline__ void wait_flags(const int* flags, int t) {
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += THREADS)
    for (unsigned k = 0; load_flag(flags + j) < t; ++k)
      if (k == SPIN_LIMIT) __trap();
}

// This block's values of a row are stored: publish step t in its flag.
__device__ __forceinline__ void publish(int* flags, int t) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    store_flag(flags + blockIdx.x, t);
  }
}
