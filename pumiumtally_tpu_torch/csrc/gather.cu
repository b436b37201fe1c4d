// Random row gather on Hopper: out[i, :] = tbl[idx[i], :].
//
// Replaces the TPU kernels of scripts/probe_pallas_gather.py::run
// (pl.pallas_call over k_take, k_onehot and k_loop), which asked how a
// VMEM-resident table could be gathered inside a Pallas kernel. The plain
// PyTorch version is tbl[idx] (pumiumtally_tpu_torch/ops/gather.py).
//
// What bounds it: memory. The gather moves bytes and computes nothing; the
// least it must move is each distinct row once, the output and the
// indices, over 3.35 TB/s. At the walk's shape (an 80 MB float32 geo20
// table, 16.9M uniform indices, 1.355 GB of output) the card does not get
// near that: a random 80 B row at a 16 B-aligned offset spans three 32 B
// sectors (96 B), the L2 keeps only 16-32 MB of randomly read rows, and
// the output stream and the rows that miss share the DRAM. Measured on an
// H100 80GB HBM3 at 700 W (PERF.md): the output written alone takes 0.48
// ms, the rows read alone 0.59 ms, and the gather about their sum.
//
// Design: one 16 B piece of an output row a load where the row's bytes
// and both pointers allow it (an 80 B float32 row is 5 pieces, a 160 B
// float64 row 10), else 8 or 4 B; neighbouring threads take neighbouring
// pieces, so a warp's loads of one row and its stores are coalesced.
//  * Each thread loads two pieces, a block's width apart, before it stores
//    either: two independent row loads in flight a thread at full
//    occupancy (20 registers). More a thread (4, or a warp's 32 rows with
//    the next tile's indices prefetched) held fewer warps resident and
//    ran no faster.
//  * The output and the indices are streamed (st.global.cs, ld.global.cs):
//    each is touched once, so they are first out of L2, which keeps more
//    of the table there while it fits (4-19% faster at 8-32 MB tables).
//    Per-access L2 policies (createpolicy evict_last on the rows,
//    evict_first on the stores) and an access-policy window over the
//    table gained nothing or lost (the window tripled the time), so the
//    kernel sets no cache policy and touches no stream or device L2
//    setting.
//  * A piece's row and column come from one 32-bit division while the
//    piece count fits 31 bits (every shape of the port: 169M pieces at the
//    float64 walk shape); the element offsets are 64-bit, so an output
//    past 2^31 bytes is addressed exactly. Pieces move as integer words:
//    float64 geo20 codes keep their bits.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr size_t DYNAMIC_SMEM = 0;  // a launch's dynamic shared memory
constexpr int PER_THREAD = 2;  // pieces a thread loads before it stores
constexpr long long BLOCK_PIECES = (long long)BLOCK * PER_THREAD;

__device__ __forceinline__ long long load_index(const int32_t* p) {
  return __ldcs(p);
}
__device__ __forceinline__ long long load_index(const int64_t* p) {
  return __ldcs((const long long*)p);
}

// Piece t of the flat output (T: unsigned, or unsigned long long past
// 2^31 pieces) is piece t % pieces of row idx[t / pieces].
template <typename V, typename I, typename T>
__global__ void __launch_bounds__(BLOCK)
gather_kernel(const V* __restrict__ tbl, const I* __restrict__ idx,
              T total, int pieces, V* __restrict__ out) {
  const T first = (T)blockIdx.x * (T)BLOCK_PIECES + threadIdx.x;
  T row[PER_THREAD];
  long long src[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const T t = first + (T)(j * BLOCK);
    row[j] = t / (T)pieces;
    src[j] = t < total ? load_index(idx + row[j]) * pieces +
                             (long long)(t - row[j] * (T)pieces)
                       : 0;
  }
  V v[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    if (first + (T)(j * BLOCK) < total) v[j] = __ldg(tbl + src[j]);
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const T t = first + (T)(j * BLOCK);
    if (t < total) __stcs(out + t, v[j]);
  }
}

template <typename V, typename I>
int launch_pieces(const void* tbl, const void* idx, long long n,
                  int row_bytes, void* out, cudaStream_t s) {
  const int pieces = row_bytes / (int)sizeof(V);
  const long long total = n * pieces;
  const long long blocks = (total + BLOCK_PIECES - 1) / BLOCK_PIECES;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (total < (1LL << 31))
    gather_kernel<V, I, unsigned>
        <<<(unsigned)blocks, BLOCK, DYNAMIC_SMEM, s>>>(
            (const V*)tbl, (const I*)idx, (unsigned)total, pieces, (V*)out);
  else
    gather_kernel<V, I, unsigned long long>
        <<<(unsigned)blocks, BLOCK, DYNAMIC_SMEM, s>>>(
            (const V*)tbl, (const I*)idx, (unsigned long long)total, pieces,
            (V*)out);
  return (int)cudaGetLastError();
}

template <typename I>
int launch(const void* tbl, const void* idx, long long n, int row_bytes,
           int piece, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (piece <= 0 || row_bytes <= 0 || row_bytes % piece)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (piece == 16)
    return launch_pieces<uint4, I>(tbl, idx, n, row_bytes, out, s);
  if (piece == 8)
    return launch_pieces<uint2, I>(tbl, idx, n, row_bytes, out, s);
  if (piece == 4)
    return launch_pieces<unsigned int, I>(tbl, idx, n, row_bytes, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points: pumi_gather_i32 / pumi_gather_i64 by index type. A row
// is copied in pieces of `piece` bytes (16, 8 or 4): the row's bytes must
// be a multiple of it and both pointers aligned to it. Returns the
// cudaError_t of the launch.
extern "C" int pumi_gather_i32(const void* tbl, const void* idx, long long n,
                               int row_bytes, int piece, void* out,
                               void* stream) {
  return launch<int32_t>(tbl, idx, n, row_bytes, piece, out, stream);
}

extern "C" int pumi_gather_i64(const void* tbl, const void* idx, long long n,
                               int row_bytes, int piece, void* out,
                               void* stream) {
  return launch<int64_t>(tbl, idx, n, row_bytes, piece, out, stream);
}

// pumi_gather_smem gives the dynamic shared memory bytes a gather launch
// passes (none), for the resource contracts.
extern "C" long long pumi_gather_smem(void) {
  return (long long)DYNAMIC_SMEM;
}
