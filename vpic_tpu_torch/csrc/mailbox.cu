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
// [offs[b], offs[b] + W) of out, one 16-byte load and store a thread and row:
// 32 threads span a row, so a thread's row and column are a shift and a mask
// of its index, no division; the caller gives 16 rows' worth (512 threads).
// Columns of out that no block covers are not touched, so the caller's out
// keeps them.  The caller gives 4-float aligned row strides and 16-byte
// aligned base pointers (the entry point refuses others); a block whose
// offset is not a multiple of 4, or would put a column outside out, writes
// nothing (the TPU's DMA takes 128-aligned offsets and would fault outside).
// Offsets that overlap give an undefined result, as on the TPU.
//
// The TPU's DMA has a direct counterpart here, the bulk async copy
// (cp.async.bulk) through shared memory, issued by one elected thread per
// block with an mbarrier: it took 0.0017-0.0022 ms on the device against
// this form's 0.0014 (H100, PERF.md), so this form stayed.
//
// What bounds it on the H100: bytes, R W 4 read and R W 4 written per block,
// 2 x 786 KB at the prototype's 96 blocks of (16, 128): ~0.5 us at 3.35 TB/s,
// below one launch; the loads' latency sets its time.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WIDTH = 128;               // columns a block (the prototype's)

__global__ void mailbox_kernel(const float* __restrict__ pk,
                               const int* __restrict__ offs,
                               float* __restrict__ out, int rows,
                               long long in_cols, long long out_cols) {
  const long long off = offs[blockIdx.x];
  // uniform over the block
  if (off < 0 || off + WIDTH > out_cols || (off & 3) != 0) return;
  const int c = 4 * (threadIdx.x & 31);
  const float* src = pk + (long long)blockIdx.x * WIDTH + c;
  float* dst = out + off + c;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5)
    *reinterpret_cast<float4*>(dst + r * out_cols) =
        *reinterpret_cast<const float4*>(src + r * in_cols);
}

}  // namespace

// pk is (rows, in_cols) float32 with in_cols >= nblocks * 128, offs is
// (nblocks,) int32, out is (rows, out_cols) float32; in_cols and out_cols
// multiples of 4, pk and out 16-byte aligned; threads per block from the
// caller, a multiple of 32.  Returns a cudaError_t code, 0 on success.
extern "C" int mailbox(const float* pk, const int* offs, float* out, int rows,
                       long long in_cols, long long out_cols, int nblocks,
                       int threads, void* stream) {
  if (nblocks <= 0 || rows == 0) return 0;
  if (rows < 0 || (long long)nblocks * WIDTH > in_cols ||
      ((in_cols | out_cols) & 3) != 0 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(pk) | reinterpret_cast<uintptr_t>(out)) &
       15) != 0)
    return (int)cudaErrorMisalignedAddress;
  mailbox_kernel<<<nblocks, threads, 0, (cudaStream_t)stream>>>(
      pk, offs, out, rows, in_cols, out_cols);
  return (int)cudaGetLastError();
}

extern "C" const char* mailbox_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
