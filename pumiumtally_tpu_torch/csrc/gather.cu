// Random row gather on Hopper: out[i, :] = tbl[idx[i], :].
//
// Replaces the TPU kernels of scripts/probe_pallas_gather.py::run
// (pl.pallas_call over k_take, k_onehot and k_loop), which asked how a
// VMEM-resident table could be gathered inside a Pallas kernel. The plain
// PyTorch version is tbl[idx] (pumiumtally_tpu_torch/ops/gather.py).
//
// Design: one thread per piece of an output row, a piece being 16 B where
// the row's bytes and both pointers allow it (an 80 B float32 geo20 row is
// 5 pieces, so neighbouring threads read one row's neighbouring pieces and
// write neighbouring output addresses), else 8 or 4 B. The gather moves
// bytes and computes nothing, so what bounds it is memory: the distinct
// rows read, the output written and the indices read, over 3.35 TB/s. Rows that miss the
// 50 MB L2 are read in 32 B sectors, so a random 80 B row costs up to
// 96 B of DRAM traffic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V, typename I>
__global__ void gather_kernel(const V* __restrict__ tbl,
                              const I* __restrict__ idx, long long n,
                              int pieces, V* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * pieces) return;
  const long long row = t / pieces;
  const int k = (int)(t - row * pieces);
  out[t] = __ldg(tbl + (long long)idx[row] * pieces + k);
}

template <typename V, typename I>
void launch_pieces(const void* tbl, const void* idx, long long n,
                   int row_bytes, void* out, cudaStream_t s) {
  const int block = 256;
  const int pieces = row_bytes / (int)sizeof(V);
  const long long total = n * pieces;
  gather_kernel<V, I><<<(unsigned)((total + block - 1) / block), block, 0,
                        s>>>((const V*)tbl, (const I*)idx, n, pieces,
                             (V*)out);
}

template <typename I>
int launch(const void* tbl, const void* idx, long long n, int row_bytes,
           int piece, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (piece == 16)
    launch_pieces<uint4, I>(tbl, idx, n, row_bytes, out, s);
  else if (piece == 8)
    launch_pieces<unsigned long long, I>(tbl, idx, n, row_bytes, out, s);
  else if (piece == 4)
    launch_pieces<unsigned int, I>(tbl, idx, n, row_bytes, out, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
