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
// segments move, and by the instructions that move and decode them (a lane's
// loads are independent gathers from a random row).  The f32 kernel reads a
// segment as float4s; the packed kernel reads a block's covering bursts once,
// 16 B each (two loads for a 16-feature block of 16-bit fields), into
// registers and decodes its fields from there (naszip::seg_part_bursts), at
// compile-time positions where the block's fields share one format: the
// decode's instructions, not the bytes, then set most of the time, and a
// field costs a shift, a mask and a multiply-add.
#include "naszip_common.cuh"

namespace {

struct F32Row {
  const float* p;
  __device__ __forceinline__ float load1(int f) const { return __ldg(p + f); }
  __device__ __forceinline__ float4 load4(int f) const {
    return __ldg(reinterpret_cast<const float4*>(p + f));
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

template <int NB, bool VEC, bool IP>
__global__ void fee_packed_kernel(const uint32_t* __restrict__ xp, long long n_rows,
                                  int words, long long pitch, int dim,
                                  const int4* __restrict__ table,
                                  const int4* __restrict__ blocks,
                                  const int* __restrict__ ids,
                                  const uint8_t* __restrict__ alive,
                                  const float* __restrict__ q, const float* __restrict__ thr,
                                  naszip::FeeArgs a, long long n_total, int lanes,
                                  float* __restrict__ dist, uint8_t* __restrict__ rejected,
                                  int* __restrict__ segs_used) {
  extern __shared__ int4 tab[];  // (D,) burst table, then (S,) block descriptors
  int4* blk = tab + dim;
  for (int f = threadIdx.x; f < dim; f += blockDim.x) tab[f] = table[f];
  for (int s = threadIdx.x; s < a.n_segs; s += blockDim.x) blk[s] = blocks[s];
  __syncthreads();
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (g >= n_total) return;
  const long long qi = g / lanes;
  int id;
  if (naszip::lane_live(ids, alive, g, n_rows, &id)) {
    const naszip::BurstRow<NB, VEC> row{xp + id * pitch, words};
    const float* qr = q + qi * dim;
    naszip::fee_lane_parts(
        [&](int s) {
          const int4 d = blk[s];
          uint32_t w[4 * NB + 1];
          row.load(d, w);
          return naszip::seg_part_bursts<NB, IP>(w, d, tab, qr, s * a.seg, a.seg);
        },
        __ldg(thr + qi), a, dist + g, rejected + g, segs_used + g);
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

// The fee_packed_kernel built for NB staged bursts: 16 B or 4 B reads, and
// the metric.
template <int NB>
auto pick(bool vec, bool ip) {
  if (ip) return vec ? &fee_packed_kernel<NB, true, true> : &fee_packed_kernel<NB, false, true>;
  return vec ? &fee_packed_kernel<NB, true, false> : &fee_packed_kernel<NB, false, false>;
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

// The packed rows are (n_rows, words) uint32 at a pitch of ``pitch`` words;
// table is the (dim, 4) burst table and blocks the (S, 4) block descriptors
// of kernels/fee_distance.py::block_bursts; nb (2, 4, 8 or 16) is the
// staging size, at least every block's burst count.
int naszip_fee_distance_packed(const void* xp, long long n_rows, int words, long long pitch,
                               int dim, const void* table, const void* blocks, int nb,
                               const void* ids, const void* alive, const void* q,
                               const void* thr, const void* alpha, const void* beta,
                               const void* margin, long long n_q, int lanes, int seg, int ip,
                               void* dist, void* rejected, void* segs_used, void* stream) {
  const long long n_total = n_q * lanes;
  if (n_total == 0) return 0;
  const naszip::FeeArgs a = fee_args(alpha, beta, margin, dim, seg, ip);
  const bool vec = naszip::burst_loads(xp, pitch, words);
  decltype(&fee_packed_kernel<2, true, true>) kernel;
  switch (nb) {
    case 2: kernel = pick<2>(vec, ip); break;
    case 4: kernel = pick<4>(vec, ip); break;
    case 8: kernel = pick<8>(vec, ip); break;
    case 16: kernel = pick<16>(vec, ip); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(dim) * sizeof(int4) +
                      static_cast<size_t>(a.n_segs) * sizeof(int4);
  const cudaError_t err = naszip::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_total + kThreads - 1) / kThreads));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xp), n_rows, words, pitch, dim,
      static_cast<const int4*>(table), static_cast<const int4*>(blocks),
      static_cast<const int*>(ids), static_cast<const uint8_t*>(alive),
      static_cast<const float*>(q), static_cast<const float*>(thr), a, n_total, lanes,
      static_cast<float*>(dist), static_cast<uint8_t*>(rejected), static_cast<int*>(segs_used));
  return static_cast<int>(cudaGetLastError());
}

const char* naszip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
