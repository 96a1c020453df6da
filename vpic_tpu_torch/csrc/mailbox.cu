// mailbox.cu -- per-block column copies to dynamic offsets, written by hand
// for Hopper (sm_90a).
//
// Replaces: scripts/residency_proto.py::_mailbox_kernel (each grid block
// DMA-copies its (16, 128) column slice from HBM to HBM at a scalar-prefetched,
// 128-aligned column offset: the residency design's neighbour-mailbox write).
// Its plain PyTorch twin is vpic_tpu_torch/ops/compact.py::mailbox_ref.
//
// One CUDA block per mailbox block: block b reads its offset offs[b] and
// copies columns [b W, b W + W) of every row of pk to columns
// [offs[b], offs[b] + W) of out, 16 bytes per thread and load.  The caller
// gives 4-float aligned widths, row strides and base pointers (the entry
// point refuses others); a block whose offset is not a multiple of 4, or
// would put a column outside out, writes nothing (the TPU's DMA takes
// 128-aligned offsets and would fault outside).  Offsets that overlap give
// an undefined result, as on the TPU.  TMA bulk copies are left for later.
//
// What bounds it on the H100: bytes, R W 4 read and R W 4 written per block,
// 2 x 786 KB at the prototype's 96 blocks of (16, 128): ~0.5 us at 3.35 TB/s,
// far below one launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void mailbox_kernel(const float* __restrict__ pk,
                               const int* __restrict__ offs,
                               float* __restrict__ out, int rows,
                               long long in_cols, long long out_cols,
                               int width) {
  const long long off = offs[blockIdx.x];
  // uniform over the block
  if (off < 0 || off + width > out_cols || (off & 3) != 0) return;
  const long long src0 = (long long)blockIdx.x * width;
  const int w4 = width >> 2;
  const int n = rows * w4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / w4;
    const int c = 4 * (i - r * w4);
    const float4 v =
        *reinterpret_cast<const float4*>(pk + r * in_cols + src0 + c);
    *reinterpret_cast<float4*>(out + r * out_cols + off + c) = v;
  }
}

}  // namespace

// pk is (rows, in_cols) float32 with in_cols >= nblocks * width, offs is
// (nblocks,) int32, out is (rows, out_cols) float32; width, in_cols and
// out_cols multiples of 4 and pk, out 16-byte aligned; threads per block
// from the caller.  Returns a cudaError_t code, 0 on success.
extern "C" int mailbox(const float* pk, const int* offs, float* out, int rows,
                       long long in_cols, long long out_cols, int width,
                       int nblocks, int threads, void* stream) {
  if (nblocks <= 0) return 0;
  if (rows <= 0 || width <= 0 || (long long)nblocks * width > in_cols ||
      ((width | in_cols | out_cols) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(pk) | reinterpret_cast<uintptr_t>(out)) &
       15) != 0)
    return (int)cudaErrorMisalignedAddress;
  mailbox_kernel<<<nblocks, threads, 0, (cudaStream_t)stream>>>(
      pk, offs, out, rows, in_cols, out_cols, width);
  return (int)cudaGetLastError();
}

extern "C" const char* mailbox_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
