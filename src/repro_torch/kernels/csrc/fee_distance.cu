// FEE early-exit distance kernels for Hopper (sm_90a), batched over queries
// with the row gather fused by id.
//
//   naszip_fee_distance_f32     replaces repro/kernels/fee_distance.py ::
//                               fee_distance_pallas (_kernel)
//   naszip_fee_distance_packed  replaces repro/kernels/fee_distance.py ::
//                               fee_distance_packed_pallas, skip_dma=False
//                               (_packed_kernel, _decode_block)
//
// One thread scores one lane (query q, candidate id).  The TPU kernels walk
// the segment axis as a sequential grid dimension with the accumulator in
// scratch; here that axis is a loop inside the thread (naszip::fee_lane),
// and the row is read from device memory segment by segment only while the
// lane is alive, so exited lanes stop moving bytes.  The work is a gather of
// 64 B (f32) or ~32 B (packed) per live segment with ~3 flops per byte, far
// below the card's balance point: the kernels are bound by the bytes the live
// segments move, and the design's only job is to move no others.
#include "naszip_common.cuh"

namespace {

struct F32Row {
  const float* p;
  __device__ __forceinline__ float load1(int f) const { return __ldg(p + f); }
  __device__ __forceinline__ float4 load4(int f) const {
    return __ldg(reinterpret_cast<const float4*>(p + f));
  }
};

// Packed rows are read one field at a time (fields are not word-aligned, so
// there is no wider load to take).
struct PackedRow {
  const uint32_t* p;
  const int4* table;  // per-feature decode table, in shared memory
  __device__ __forceinline__ float load1(int f) const {
    return naszip::decode_feature(p, table[f]);
  }
};

template <bool VEC>
__global__ void fee_f32_kernel(const float* __restrict__ db, long long n_rows, int dim,
                               const int* __restrict__ ids, const uint8_t* __restrict__ alive,
                               const float* __restrict__ q, const float* __restrict__ thr,
                               naszip::FeeArgs a, long long n_total, int lanes,
                               float* __restrict__ dist, uint8_t* __restrict__ rejected,
                               int* __restrict__ segs_used) {
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (g >= n_total) return;
  const long long qi = g / lanes;
  int id;
  if (naszip::lane_live(ids, alive, g, n_rows, &id)) {
    naszip::fee_lane<VEC>(F32Row{db + id * static_cast<long long>(dim)}, q + qi * dim,
                          __ldg(thr + qi), a, dist + g, rejected + g, segs_used + g);
  } else {
    naszip::dead_lane(dist + g, rejected + g, segs_used + g);
  }
}

__global__ void fee_packed_kernel(const uint32_t* __restrict__ xp, long long n_rows,
                                  int words, int dim, const int4* __restrict__ table,
                                  const int* __restrict__ ids,
                                  const uint8_t* __restrict__ alive,
                                  const float* __restrict__ q, const float* __restrict__ thr,
                                  naszip::FeeArgs a, long long n_total, int lanes,
                                  float* __restrict__ dist, uint8_t* __restrict__ rejected,
                                  int* __restrict__ segs_used) {
  extern __shared__ int4 tab[];
  for (int f = threadIdx.x; f < dim; f += blockDim.x) tab[f] = table[f];
  __syncthreads();
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (g >= n_total) return;
  const long long qi = g / lanes;
  int id;
  if (naszip::lane_live(ids, alive, g, n_rows, &id)) {
    naszip::fee_lane<false>(PackedRow{xp + id * static_cast<long long>(words), tab},
                            q + qi * dim, __ldg(thr + qi), a, dist + g, rejected + g,
                            segs_used + g);
  } else {
    naszip::dead_lane(dist + g, rejected + g, segs_used + g);
  }
}

constexpr int kThreads = 256;

// The f32 kernel reads rows and queries as float4 where it can: that needs
// seg % 4 == 0 and 16-byte aligned rows of a dim % 4 == 0 matrix.  Both
// variants add the same values in the same order.
bool vec_ok(int seg, int dim, const void* base) {
  return seg % 4 == 0 && dim % 4 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

naszip::FeeArgs fee_args(const void* alpha, const void* beta, const void* margin, int dim,
                         int seg, int ip) {
  return naszip::FeeArgs{static_cast<const float*>(alpha), static_cast<const float*>(beta),
                         static_cast<const float*>(margin), dim / seg, seg, ip};
}

}  // namespace

extern "C" {

// All pointers are device pointers of contiguous tensors; alive may be null.
// Returns the cudaError_t of the launch (0 on success).
int naszip_fee_distance_f32(const void* db, long long n_rows, int dim, const void* ids,
                            const void* alive, const void* q, const void* thr,
                            const void* alpha, const void* beta, const void* margin,
                            long long n_q, int lanes, int seg, int ip, void* dist,
                            void* rejected, void* segs_used, void* stream) {
  const long long n_total = n_q * lanes;
  if (n_total == 0) return 0;
  const naszip::FeeArgs a = fee_args(alpha, beta, margin, dim, seg, ip);
  const dim3 grid(static_cast<unsigned>((n_total + kThreads - 1) / kThreads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* db_f = static_cast<const float*>(db);
  const int* ids_i = static_cast<const int*>(ids);
  const uint8_t* alive_b = static_cast<const uint8_t*>(alive);
  const float* q_f = static_cast<const float*>(q);
  const float* thr_f = static_cast<const float*>(thr);
  float* dist_f = static_cast<float*>(dist);
  uint8_t* rej_b = static_cast<uint8_t*>(rejected);
  int* segs_i = static_cast<int*>(segs_used);
  if (vec_ok(seg, dim, db) && vec_ok(seg, dim, q)) {
    fee_f32_kernel<true><<<grid, kThreads, 0, s>>>(db_f, n_rows, dim, ids_i, alive_b, q_f,
                                                   thr_f, a, n_total, lanes, dist_f, rej_b,
                                                   segs_i);
  } else {
    fee_f32_kernel<false><<<grid, kThreads, 0, s>>>(db_f, n_rows, dim, ids_i, alive_b, q_f,
                                                    thr_f, a, n_total, lanes, dist_f, rej_b,
                                                    segs_i);
  }
  return static_cast<int>(cudaGetLastError());
}

int naszip_fee_distance_packed(const void* xp, long long n_rows, int words, int dim,
                               const void* table, const void* ids, const void* alive,
                               const void* q, const void* thr, const void* alpha,
                               const void* beta, const void* margin, long long n_q,
                               int lanes, int seg, int ip, void* dist, void* rejected,
                               void* segs_used, void* stream) {
  const long long n_total = n_q * lanes;
  if (n_total == 0) return 0;
  const naszip::FeeArgs a = fee_args(alpha, beta, margin, dim, seg, ip);
  const dim3 grid(static_cast<unsigned>((n_total + kThreads - 1) / kThreads));
  const size_t smem = static_cast<size_t>(dim) * sizeof(int4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xp_w = static_cast<const uint32_t*>(xp);
  const int4* tab = static_cast<const int4*>(table);
  const int* ids_i = static_cast<const int*>(ids);
  const uint8_t* alive_b = static_cast<const uint8_t*>(alive);
  const float* q_f = static_cast<const float*>(q);
  const float* thr_f = static_cast<const float*>(thr);
  float* dist_f = static_cast<float*>(dist);
  uint8_t* rej_b = static_cast<uint8_t*>(rejected);
  int* segs_i = static_cast<int*>(segs_used);
  fee_packed_kernel<<<grid, kThreads, smem, s>>>(xp_w, n_rows, words, dim, tab, ids_i, alive_b,
                                                 q_f, thr_f, a, n_total, lanes, dist_f, rej_b,
                                                 segs_i);
  return static_cast<int>(cudaGetLastError());
}

const char* naszip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
