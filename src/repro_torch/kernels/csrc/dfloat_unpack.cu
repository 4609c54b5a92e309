// Dfloat bitstream decode for Hopper (sm_90a): packed (C, W) uint32 rows ->
// (C, D) f32, bit-exact vs dfloat.unpack_db.
//
// Replaces repro/kernels/dfloat_unpack.py :: dfloat_unpack_pallas (_kernel).
//
// The TPU kernel unrolls the layout's static shifts over a (TILE_C, W) block
// in VMEM.  Here one thread decodes one (row, feature) from a per-feature
// table (word, bit offset, width, n_exp, n_man, bias) staged in shared
// memory, so one compiled kernel serves every layout.  Consecutive threads
// take consecutive features of a row, so the word reads and the f32 writes
// are coalesced.  The decode is a few integer operations per 4 bytes written:
// the kernel is bound by the bytes it reads and writes.
#include "naszip_common.cuh"

namespace {

__global__ void dfloat_unpack_kernel(const uint32_t* __restrict__ packed, long long n_rows,
                                     int words, int dim, const int4* __restrict__ table,
                                     float* __restrict__ out) {
  extern __shared__ int4 tab[];
  for (int f = threadIdx.x; f < dim; f += blockDim.x) tab[f] = table[f];
  __syncthreads();
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (g >= n_rows * dim) return;
  const long long r = g / dim;
  const int f = static_cast<int>(g - r * dim);
  out[g] = naszip::decode_feature(packed + r * words, tab[f]);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// packed holds n_rows rows at a pitch of ``words`` words; table and out are
// device pointers of contiguous tensors.
// Returns the cudaError_t of the launch (0 on success).
int naszip_dfloat_unpack(const void* packed, long long n_rows, int words, int dim,
                         const void* table, void* out, void* stream) {
  const long long n_total = n_rows * dim;
  if (n_total == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n_total + kThreads - 1) / kThreads));
  const size_t smem = static_cast<size_t>(dim) * sizeof(int4);
  dfloat_unpack_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), n_rows, words, dim,
      static_cast<const int4*>(table), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* naszip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
