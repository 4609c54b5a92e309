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
// has a live lane.  Here a warp stands in for the tile gate: __ballot_sync
// over its live lanes, and cp.async copies of the live lanes' blocks into
// shared memory, neighbouring threads on neighbouring chunks of one row.
// Nothing is copied for a lane after it exits, nor for a tile whose lanes
// have all exited, and no copy is speculative: segment s+1 of a tile is not
// fetched before segment s has decided the tile's exits.
//
// f32 (fee_warp, StageF32): one warp scores 32 lanes and walks the segments
// together while any of its lanes is live; at each segment its threads copy
// the live lanes' segments (16 B chunks, or 4 B when seg % 4 != 0 or the rows
// are not 16 B aligned) into the warp's buffer, wait (cp.async.wait_all,
// __syncwarp), and each live lane sums its segment from shared memory.
//
// packed (fee_skipdma_packed_kernel): one warp owns two 32-lane tiles, A and
// B, each thread one lane of each.  A block's fields lie in its covering bursts
// [b0, b1) (16 B aligned units of the row, kernels/fee_distance.py::
// block_bursts), copied with 16 B cp.async.cg into a per-lane slot of an odd
// number of 16 B chunks, so a warp's 16 B shared loads of its slots are free
// of bank conflicts; each lane reads its slot once and decodes from registers
// (naszip::seg_part_bursts).  The two tiles' copies overlap the other tile's
// decode: A(s) and B(s) are committed as two cp.async groups, A decodes once
// its group lands (cp.async.wait_group 1) while B's copy is in flight, then
// A(s+1) is committed for A's surviving lanes and B decodes while it flies.
//
// Bound on this card: bytes (a 64 B or ~32 B gather per live segment for ~3
// flops per feature).  The designs move exactly the live segments' bytes (for
// packed rows, the covering bursts of the live blocks).  Outputs are
// bit-identical to fee_distance.cu's kernels: the same summation order and
// fee_step.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One lane's landed f32 segment: features [f0, f0 + seg) at buf.
struct LandedF32 {
  const float* buf;
  int f0;
  __device__ __forceinline__ float load1(int f) const { return buf[f - f0]; }
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

// One lane of a packed skip-DMA tile, carried by one thread.
struct TileLane {
  long long g, qi;
  int id, used;
  float thr, acc;
  bool scored, live, exited;
};

__device__ __forceinline__ TileLane tile_lane(long long g, const int* ids, const uint8_t* alive,
                                              long long n_rows, const float* thr,
                                              long long n_total, int lanes) {
  TileLane l{g, 0, 0, 0, 0.0f, 0.0f, false, false, false};
  l.scored = g < n_total && naszip::lane_live(ids, alive, g, n_rows, &l.id);
  l.live = l.scored;
  if (l.scored) {
    l.qi = g / lanes;
    l.thr = __ldg(thr + l.qi);
  }
  return l;
}

// Copies of a 32-lane tile's covering bursts of the block with descriptor
// d = (b0, nb | W << 8, ...) into the tile's slots (lane j's at
// slots + j * SLOT), for the lanes in `live` only: 16 B
// cp.async.cg when VEC (16 B aligned row base, a pitch and W that are
// multiples of 4 words), else the same words 4 B at a time, clipped to the
// row's W words.  Neighbouring threads take neighbouring chunks of one row.
// Every thread of the warp calls it (the shuffles need all 32).
template <bool VEC, int SLOT>
__device__ __forceinline__ void stage_bursts(const uint32_t* xp, long long pitch, int words,
                                             int4 d, unsigned live, int id, int lane,
                                             uint4* slots) {
  const int nb = d.y & 0xFF, per = VEC ? nb : min(4 * nb, words - 4 * d.x);  // copies per lane
  for (int c = lane; c < 32 * per; c += 32) {  // every thread: per iterations
    const int j = c / per, k = c - j * per;
    const int rid = __shfl_sync(kFull, id, j);
    if ((live >> j) & 1u) {
      const uint32_t* src = xp + rid * pitch + 4 * d.x;
      if constexpr (VEC) {
        cp_async16(slots + j * SLOT + k, src + 4 * k);
      } else {
        cp_async4(reinterpret_cast<uint32_t*>(slots + j * SLOT) + k, src + k);
      }
    }
  }
}

// A live lane reads its slot's bursts of the block with descriptor d with
// 16 B shared loads, decodes and scores segment s, and takes the exit step.
template <int NB, bool IP>
__device__ __forceinline__ void score_slot(TileLane& l, const uint4* slot, int4 d,
                                           const int4* tab, const float* q, int dim, int s,
                                           const naszip::FeeArgs& a) {
  if (!l.live) return;
  uint32_t w[4 * NB + 1];
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < (d.y & 0xFF)) v = slot[c];
    w[4 * c] = v.x;
    w[4 * c + 1] = v.y;
    w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  }
  w[4 * NB] = 0u;
  l.exited = naszip::fee_step(
      naszip::seg_part_bursts<NB, IP>(w, d, tab, q + l.qi * dim, s * a.seg, a.seg), s, l.thr,
      a, &l.acc);
  ++l.used;
  l.live = !l.exited;
}

__device__ __forceinline__ void write_lane(const TileLane& l, long long n_total, float* dist,
                                           uint8_t* rejected, int* segs_used) {
  if (l.g >= n_total) return;
  if (l.scored) {
    dist[l.g] = l.acc;
    rejected[l.g] = l.exited;
    segs_used[l.g] = l.used;
  } else {
    naszip::dead_lane(dist + l.g, rejected + l.g, segs_used + l.g);
  }
}

// The packed warp loop: tiles A (lanes g0 .. g0+31) and B (g0+32 .. g0+63).
// Commit order A(0), B(0), then per segment: wait for A(s), decode A, commit
// A(s+1) for A's live lanes; wait for B(s), decode B, commit B(s+1).  Each
// wait_group 1 leaves only the other tile's latest copy in flight.
template <int NB, bool VEC, bool IP>
__global__ void fee_skipdma_packed_kernel(const uint32_t* __restrict__ xp, long long n_rows,
                                          int words, long long pitch, int dim,
                                          const int4* __restrict__ table,
                                          const int4* __restrict__ blocks,
                                          const int* __restrict__ ids,
                                          const uint8_t* __restrict__ alive,
                                          const float* __restrict__ q,
                                          const float* __restrict__ thr, naszip::FeeArgs a,
                                          long long n_total, int lanes,
                                          float* __restrict__ dist,
                                          uint8_t* __restrict__ rejected,
                                          int* __restrict__ segs_used) {
  constexpr int SLOT = NB + 1;  // 16 B chunks per lane slot: odd, so no bank conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  int4* tab = reinterpret_cast<int4*>(smem);  // (D,) burst table
  int4* blk = tab + dim;                      // (S,) block descriptors
  uint4* bufs = reinterpret_cast<uint4*>(blk + a.n_segs);
  for (int f = threadIdx.x; f < dim; f += blockDim.x) tab[f] = table[f];
  for (int s = threadIdx.x; s < a.n_segs; s += blockDim.x) blk[s] = blocks[s];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* slots_a = bufs + warp * 2 * 32 * SLOT;
  uint4* slots_b = slots_a + 32 * SLOT;
  const long long g0 = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * 64;
  TileLane la = tile_lane(g0 + lane, ids, alive, n_rows, thr, n_total, lanes);
  TileLane lb = tile_lane(g0 + 32 + lane, ids, alive, n_rows, thr, n_total, lanes);
  auto stage = [&](int s, unsigned live, int id, uint4* slots) {
    stage_bursts<VEC, SLOT>(xp, pitch, words, blk[s], live, id, lane, slots);
  };
  unsigned ma = __ballot_sync(kFull, la.live), mb = __ballot_sync(kFull, lb.live);
  if (ma) stage(0, ma, la.id, slots_a);
  cp_async_commit();
  if (mb) stage(0, mb, lb.id, slots_b);
  cp_async_commit();
  for (int s = 0; s < a.n_segs && (ma | mb); ++s) {
    const int4 d = blk[s];
    const bool more = s + 1 < a.n_segs;
    cp_async_wait_group<1>();  // A(s) has landed; B(s) may be in flight
    __syncwarp();
    score_slot<NB, IP>(la, slots_a + lane * SLOT, d, tab, q, dim, s, a);
    __syncwarp();  // A's slots are read: A(s+1) may overwrite them
    ma = __ballot_sync(kFull, la.live);
    if (more && ma) stage(s + 1, ma, la.id, slots_a);
    cp_async_commit();
    cp_async_wait_group<1>();  // B(s) has landed; A(s+1) may be in flight
    __syncwarp();
    score_slot<NB, IP>(lb, slots_b + lane * SLOT, d, tab, q, dim, s, a);
    __syncwarp();
    mb = __ballot_sync(kFull, lb.live);
    if (more && mb) stage(s + 1, mb, lb.id, slots_b);
    cp_async_commit();
  }
  cp_async_wait_all();
  write_lane(la, n_total, dist, rejected, segs_used);
  write_lane(lb, n_total, dist, rejected, segs_used);
}

naszip::FeeArgs fee_args(const void* alpha, const void* beta, const void* margin, int dim,
                         int seg, int ip) {
  return naszip::FeeArgs{static_cast<const float*>(alpha), static_cast<const float*>(beta),
                         static_cast<const float*>(margin), dim / seg, seg, ip};
}

// The fee_skipdma_packed_kernel built for NB staged bursts: 16 B or 4 B
// copies, and the metric.
template <int NB>
auto pick(bool vec, bool ip) {
  if (ip) {
    return vec ? &fee_skipdma_packed_kernel<NB, true, true>
               : &fee_skipdma_packed_kernel<NB, false, true>;
  }
  return vec ? &fee_skipdma_packed_kernel<NB, true, false>
             : &fee_skipdma_packed_kernel<NB, false, false>;
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
  const cudaError_t err = naszip::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const float*>(db), n_rows, dim, static_cast<const int*>(ids),
      static_cast<const uint8_t*>(alive), static_cast<const float*>(q),
      static_cast<const float*>(thr), a, n_total, lanes, static_cast<float*>(dist),
      static_cast<uint8_t*>(rejected), static_cast<int*>(segs_used));
  return static_cast<int>(cudaGetLastError());
}

// The packed rows are (n_rows, words) uint32 at a pitch of ``pitch`` words;
// table is the (dim, 4) burst table and blocks the (S, 4) block descriptors
// of kernels/fee_distance.py::block_bursts; nb (2, 4, 8 or 16) is the
// staging size, at least every block's burst count.  ``warps`` warps
// per block, each scoring two tiles of 32 lanes; the caller sizes them to the
// shared memory.
int naszip_fee_skipdma_packed(const void* xp, long long n_rows, int words, long long pitch,
                              int dim, const void* table, const void* blocks, int nb,
                              const void* ids, const void* alive, const void* q,
                              const void* thr, const void* alpha, const void* beta,
                              const void* margin, long long n_q, int lanes, int seg, int ip,
                              int warps, void* dist, void* rejected, void* segs_used,
                              void* stream) {
  const long long n_total = n_q * lanes;
  if (n_total == 0) return 0;
  const naszip::FeeArgs a = fee_args(alpha, beta, margin, dim, seg, ip);
  const bool vec = naszip::burst_loads(xp, pitch, words);
  decltype(&fee_skipdma_packed_kernel<2, true, true>) kernel;
  switch (nb) {
    case 2: kernel = pick<2>(vec, ip); break;
    case 4: kernel = pick<4>(vec, ip); break;
    case 8: kernel = pick<8>(vec, ip); break;
    case 16: kernel = pick<16>(vec, ip); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = warps * 32;
  const long long per_block = 64LL * warps;  // two tiles per warp
  const dim3 grid(static_cast<unsigned>((n_total + per_block - 1) / per_block));
  const size_t smem = static_cast<size_t>(dim) * sizeof(int4) +
                      static_cast<size_t>(a.n_segs) * sizeof(int4) +
                      static_cast<size_t>(warps) * 2 * 32 * (nb + 1) * sizeof(uint4);
  const cudaError_t err = naszip::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
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
