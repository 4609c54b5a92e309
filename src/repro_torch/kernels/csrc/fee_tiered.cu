// Tiered Dfloat FEE early-exit kernel for Hopper (sm_90a), batched over
// queries with the row gather fused by id.
//
//   naszip_fee_tiered  replaces repro/kernels/fee_distance.py ::
//                      fee_distance_tiered_pallas (_tiered_kernel)
//
// The row is split at a feature boundary into a resident coarse tier (C, Wc)
// and a residual tier (C, Wr), each its own burst-aligned bitstream.  The TPU
// kernel streams the coarse blocks and DMAs the residual word spans only for
// tiles with a live lane.  Here one thread scores one lane, as
// fee_packed_kernel does: feature f < Dc decodes from the coarse row with the
// coarse table, every other feature from the residual row with the residual
// table (both tables in shared memory).  A lane reads the residual row only
// for segments it reaches, so exited and dead lanes never touch xr: the
// survivor-fetch contract.  One kernel takes every split, 0 and S included
// (an empty tier's table is never read; the TPU kernel falls back to the
// packed kernels there only because a Pallas kernel cannot take an empty
// tier).
//
// Bound on this card: bytes (each live segment's coarse or residual words).
// split_config keeps every feature's format and the accumulate/exit code is
// naszip::fee_lane, so outputs are bit-identical to fee_distance_packed over
// the parent layout's rows at every split.
#include "naszip_common.cuh"

namespace {

struct TieredRow {
  const uint32_t* coarse;
  const uint32_t* resid;
  const int4* table;  // (D,): coarse entries, then residual entries
  int dc;             // coarse features
  __device__ __forceinline__ float load1(int f) const {
    return naszip::decode_feature(f < dc ? coarse : resid, table[f]);
  }
};

__global__ void fee_tiered_kernel(const uint32_t* __restrict__ xc,
                                  const uint32_t* __restrict__ xr, long long n_rows, int wc,
                                  int wr, int dc, int dim, const int4* __restrict__ tc,
                                  const int4* __restrict__ tr, const int* __restrict__ ids,
                                  const uint8_t* __restrict__ alive,
                                  const float* __restrict__ q, const float* __restrict__ thr,
                                  naszip::FeeArgs a, long long n_total, int lanes,
                                  float* __restrict__ dist, uint8_t* __restrict__ rejected,
                                  int* __restrict__ segs_used) {
  extern __shared__ int4 tab[];
  for (int f = threadIdx.x; f < dim; f += blockDim.x) tab[f] = f < dc ? tc[f] : tr[f - dc];
  __syncthreads();
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (g >= n_total) return;
  const long long qi = g / lanes;
  int id;
  if (naszip::lane_live(ids, alive, g, n_rows, &id)) {
    const TieredRow row{xc + id * static_cast<long long>(wc), xr + id * static_cast<long long>(wr),
                        tab, dc};
    naszip::fee_lane<false>(row, q + qi * dim, __ldg(thr + qi), a, dist + g, rejected + g,
                            segs_used + g);
  } else {
    naszip::dead_lane(dist + g, rejected + g, segs_used + g);
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// All pointers are device pointers of contiguous tensors, except the tier
// rows, at a pitch of wc and wr words; alive may be null, and so may an empty
// tier's rows and table.  Returns the cudaError_t of the
// launch (0 on success).
int naszip_fee_tiered(const void* xc, const void* xr, long long n_rows, int wc, int wr, int dc,
                      int dim, const void* tc, const void* tr, const void* ids,
                      const void* alive, const void* q, const void* thr, const void* alpha,
                      const void* beta, const void* margin, long long n_q, int lanes, int seg,
                      int ip, void* dist, void* rejected, void* segs_used, void* stream) {
  const long long n_total = n_q * lanes;
  if (n_total == 0) return 0;
  const naszip::FeeArgs a{static_cast<const float*>(alpha), static_cast<const float*>(beta),
                          static_cast<const float*>(margin), dim / seg, seg, ip};
  const dim3 grid(static_cast<unsigned>((n_total + kThreads - 1) / kThreads));
  const size_t smem = static_cast<size_t>(dim) * sizeof(int4);
  fee_tiered_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xc), static_cast<const uint32_t*>(xr), n_rows, wc, wr, dc,
      dim, static_cast<const int4*>(tc), static_cast<const int4*>(tr),
      static_cast<const int*>(ids), static_cast<const uint8_t*>(alive),
      static_cast<const float*>(q), static_cast<const float*>(thr), a, n_total, lanes,
      static_cast<float*>(dist), static_cast<uint8_t*>(rejected),
      static_cast<int*>(segs_used));
  return static_cast<int>(cudaGetLastError());
}

const char* naszip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
