// Skip-DMA FEE early-exit kernels for Hopper (sm_90a), batched over queries
// with the row gather fused by id.
//
//   naszip_fee_skipdma_f32     replaces repro/kernels/fee_distance.py ::
//                              fee_distance_skipdma_pallas (_skipdma_kernel)
//   naszip_fee_skipdma_packed  replaces repro/kernels/fee_distance.py ::
//                              fee_distance_packed_pallas, skip_dma=True
//                              (_packed_skipdma_kernel, _block_positions)
//
// The TPU kernels keep the rows in HBM and copy each (tile, segment) block
// into a VMEM landing buffer with make_async_copy, only while the tile still
// has a live lane.  Here one warp scores 32 lanes and walks the segments
// together while __any of its lanes is live (the tile gate; each lane is also
// gated on its own).  At each segment the warp's threads start cp.async
// copies of the live lanes' segment (seg floats, or the word span [w0, w1) of
// the block's packed fields) into the warp's landing buffer in shared memory,
// neighbouring threads on neighbouring chunks of one row, so a 64 B f32
// segment is one coalesced request.  After cp.async.wait_all and __syncwarp
// each live lane sums its segment from shared memory and takes the shared
// exit step (naszip::fee_step).  Nothing is copied for a lane after it exits,
// nor for a warp whose lanes have all exited, and no copy is speculative:
// segment s+1 is not fetched before segment s has decided the exit.
//
// Bound on this card: bytes (a 64 B or ~32 B gather per live segment for ~3
// flops per feature).  The design moves exactly the live segments' bytes, in
// fewer memory transactions than one thread per lane, at the price of a
// warp-wide copy/wait step per segment.  Outputs are bit-identical to
// fee_distance.cu's kernels: the same seg_part order and fee_step.
#include "naszip_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One lane's landed f32 segment: features [f0, f0 + seg) at buf.
struct LandedF32 {
  const float* buf;
  int f0;
  __device__ __forceinline__ float load1(int f) const { return buf[f - f0]; }
};

// One lane's landed word span: words [w0, w1) of its packed row at buf.
struct LandedPacked {
  const uint32_t* buf;
  int w0;
  const int4* table;
  __device__ __forceinline__ float load1(int f) const {
    const uint32_t* b = buf;
    const int o = w0;
    return naszip::decode_field([b, o](int i) { return b[i - o]; }, table[f]);
  }
};

// Copies of f32 segments: 16 B chunks when VEC (seg % 4 == 0, 16 B aligned
// rows of a dim % 4 == 0 matrix), 4 B otherwise.
template <bool VEC>
struct StageF32 {
  const float* db;
  int dim;
  int seg;
  float* buf;  // this warp's 32 x seg floats
  __device__ __forceinline__ void stage(int s, unsigned live, int id, int lane) const {
    const int per = VEC ? seg / 4 : seg;  // chunks per row
    for (int c = lane; c < 32 * per; c += 32) {  // every thread: per iterations
      const int j = c / per, k = c - j * per;
      const int rid = __shfl_sync(kFull, id, j);
      if ((live >> j) & 1u) {
        const float* src = db + static_cast<long long>(rid) * dim + s * seg;
        if constexpr (VEC) {
          cp_async16(buf + j * seg + 4 * k, src + 4 * k);
        } else {
          cp_async4(buf + j * seg + k, src + k);
        }
      }
    }
  }
  __device__ __forceinline__ LandedF32 row(int lane, int s) const {
    return LandedF32{buf + lane * seg, s * seg};
  }
};

// Copies of packed word spans, 4 B each (spans are not 16 B aligned).
struct StagePacked {
  const uint32_t* xp;
  int words;
  const int2* spans;  // (S,) [w0, w1) per FEE block, in shared memory
  const int4* table;  // (D,) decode table, in shared memory
  int max_span;
  uint32_t* buf;      // this warp's 32 x max_span words
  __device__ __forceinline__ void stage(int s, unsigned live, int id, int lane) const {
    const int2 sp = spans[s];
    const int n = sp.y - sp.x;
    for (int c = lane; c < 32 * n; c += 32) {
      const int j = c / n, k = c - j * n;
      const int rid = __shfl_sync(kFull, id, j);
      if ((live >> j) & 1u) {
        cp_async4(buf + j * max_span + k, xp + static_cast<long long>(rid) * words + sp.x + k);
      }
    }
  }
  __device__ __forceinline__ LandedPacked row(int lane, int s) const {
    return LandedPacked{buf + lane * max_span, spans[s].x, table};
  }
};

// The warp's walk over the segments.  Every thread of the warp runs the loop
// (the shuffles and copies need all 32), lanes past the batch as dead lanes.
template <class Stage>
__device__ __forceinline__ void fee_warp(const Stage& st, const int* ids, const uint8_t* alive,
                                         long long n_rows, int dim, const float* q,
                                         const float* thr, const naszip::FeeArgs& a,
                                         long long n_total, int lanes, float* dist,
                                         uint8_t* rejected, int* segs_used) {
  const int lane = threadIdx.x & 31;
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  int id = 0;
  const bool scored = g < n_total && naszip::lane_live(ids, alive, g, n_rows, &id);
  const long long qi = scored ? g / lanes : 0;
  const float t = scored ? __ldg(thr + qi) : 0.0f;
  bool live = scored, exited = false;
  float acc = 0.0f;
  int used = 0;
  for (int s = 0; s < a.n_segs; ++s) {
    const unsigned mask = __ballot_sync(kFull, live);
    if (mask == 0u) break;  // every lane of the warp has exited: no more copies
    st.stage(s, mask, id, lane);
    cp_async_wait_all();
    __syncwarp();
    if (live) {
      exited = naszip::fee_step(naszip::seg_part<false>(st.row(lane, s), q + qi * dim,
                                                        s * a.seg, a),
                                s, t, a, &acc);
      ++used;
      live = !exited;
    }
    __syncwarp();  // the buffer is refilled at the next segment
  }
  if (g >= n_total) return;
  if (scored) {
    dist[g] = acc;
    rejected[g] = exited;
    segs_used[g] = used;
  } else {
    naszip::dead_lane(dist + g, rejected + g, segs_used + g);
  }
}

template <bool VEC>
__global__ void fee_skipdma_f32_kernel(const float* __restrict__ db, long long n_rows, int dim,
                                       const int* __restrict__ ids,
                                       const uint8_t* __restrict__ alive,
                                       const float* __restrict__ q,
                                       const float* __restrict__ thr, naszip::FeeArgs a,
                                       long long n_total, int lanes, float* __restrict__ dist,
                                       uint8_t* __restrict__ rejected,
                                       int* __restrict__ segs_used) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * 32 * a.seg;
  fee_warp(StageF32<VEC>{db, dim, a.seg, buf}, ids, alive, n_rows, dim, q, thr, a, n_total,
           lanes, dist, rejected, segs_used);
}

__global__ void fee_skipdma_packed_kernel(const uint32_t* __restrict__ xp, long long n_rows,
                                          int words, int dim, const int4* __restrict__ table,
                                          const int2* __restrict__ spans, int max_span,
                                          const int* __restrict__ ids,
                                          const uint8_t* __restrict__ alive,
                                          const float* __restrict__ q,
                                          const float* __restrict__ thr, naszip::FeeArgs a,
                                          long long n_total, int lanes,
                                          float* __restrict__ dist,
                                          uint8_t* __restrict__ rejected,
                                          int* __restrict__ segs_used) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* tab = reinterpret_cast<int4*>(smem);
  int2* sp = reinterpret_cast<int2*>(tab + dim);
  uint32_t* bufs = reinterpret_cast<uint32_t*>(sp + ((a.n_segs + 1) & ~1));  // 16 B aligned
  for (int f = threadIdx.x; f < dim; f += blockDim.x) tab[f] = table[f];
  for (int s = threadIdx.x; s < a.n_segs; s += blockDim.x) sp[s] = spans[s];
  __syncthreads();
  uint32_t* buf = bufs + (threadIdx.x >> 5) * 32 * max_span;
  fee_warp(StagePacked{xp, words, sp, tab, max_span, buf}, ids, alive, n_rows, dim, q, thr, a,
           n_total, lanes, dist, rejected, segs_used);
}

naszip::FeeArgs fee_args(const void* alpha, const void* beta, const void* margin, int dim,
                         int seg, int ip) {
  return naszip::FeeArgs{static_cast<const float*>(alpha), static_cast<const float*>(beta),
                         static_cast<const float*>(margin), dim / seg, seg, ip};
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// All pointers are device pointers of contiguous tensors; alive may be null.
// ``warps`` warps per block; the caller sizes them to the shared memory.
// Returns the cudaError_t of the launch (0 on success).
int naszip_fee_skipdma_f32(const void* db, long long n_rows, int dim, const void* ids,
                           const void* alive, const void* q, const void* thr, const void* alpha,
                           const void* beta, const void* margin, long long n_q, int lanes,
                           int seg, int ip, int warps, void* dist, void* rejected,
                           void* segs_used, void* stream) {
  const long long n_total = n_q * lanes;
  if (n_total == 0) return 0;
  const naszip::FeeArgs a = fee_args(alpha, beta, margin, dim, seg, ip);
  const int threads = warps * 32;
  const dim3 grid(static_cast<unsigned>((n_total + threads - 1) / threads));
  const size_t smem = static_cast<size_t>(warps) * 32 * seg * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = seg % 4 == 0 && dim % 4 == 0 && reinterpret_cast<uintptr_t>(db) % 16 == 0;
  auto kernel = vec ? &fee_skipdma_f32_kernel<true> : &fee_skipdma_f32_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const float*>(db), n_rows, dim, static_cast<const int*>(ids),
      static_cast<const uint8_t*>(alive), static_cast<const float*>(q),
      static_cast<const float*>(thr), a, n_total, lanes, static_cast<float*>(dist),
      static_cast<uint8_t*>(rejected), static_cast<int*>(segs_used));
  return static_cast<int>(cudaGetLastError());
}

// spans: (S, 2) int32 device tensor of each FEE block's word span [w0, w1);
// max_span = max(w1 - w0).
int naszip_fee_skipdma_packed(const void* xp, long long n_rows, int words, int dim,
                              const void* table, const void* spans, int max_span,
                              const void* ids, const void* alive, const void* q,
                              const void* thr, const void* alpha, const void* beta,
                              const void* margin, long long n_q, int lanes, int seg, int ip,
                              int warps, void* dist, void* rejected, void* segs_used,
                              void* stream) {
  const long long n_total = n_q * lanes;
  if (n_total == 0) return 0;
  const naszip::FeeArgs a = fee_args(alpha, beta, margin, dim, seg, ip);
  const int threads = warps * 32;
  const dim3 grid(static_cast<unsigned>((n_total + threads - 1) / threads));
  const size_t smem = static_cast<size_t>(dim) * sizeof(int4) +
                      static_cast<size_t>((a.n_segs + 1) & ~1) * sizeof(int2) +
                      static_cast<size_t>(warps) * 32 * max_span * sizeof(uint32_t);
  const cudaError_t err = allow_smem(fee_skipdma_packed_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fee_skipdma_packed_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xp), n_rows, words, dim, static_cast<const int4*>(table),
      static_cast<const int2*>(spans), max_span, static_cast<const int*>(ids),
      static_cast<const uint8_t*>(alive), static_cast<const float*>(q),
      static_cast<const float*>(thr), a, n_total, lanes, static_cast<float*>(dist),
      static_cast<uint8_t*>(rejected), static_cast<int*>(segs_used));
  return static_cast<int>(cudaGetLastError());
}

const char* naszip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
