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
// Both kernels run one warp loop (skip_warp): a warp owns two 32-lane tiles,
// A and B, each thread one lane of each, and the two tiles' copies overlap
// the other tile's scoring.  A(0) and B(0) are committed as two cp.async
// groups; per segment, A scores once its group lands (cp.async.wait_group 1)
// while B's copy is in flight, then A(s+1) is committed for A's surviving
// lanes and B scores while it flies.  Each lane's copy lands in a slot of
// its tile whose stride is odd in the unit the lane reads it by, so a warp's
// shared loads of its slots are free of bank conflicts.  A policy stages
// and scores a tile:
//
// f32 (F32Tiles): a live lane's seg floats, copied in 16 B chunks into a
// slot of an odd number of 16 B chunks and read back as float4s (seg % 4 ==
// 0 and 16 B aligned rows of a dim % 4 == 0 matrix), else in 4 B words into
// a slot of an odd number of words, read one float at a time; the query as
// float4s where its slice is 16 B aligned.
//
// packed (PackedTiles): a block's fields lie in its covering bursts [b0, b1)
// (16 B aligned units of the row, kernels/fee_distance.py::block_bursts),
// copied with 16 B cp.async.cg into a slot of NB + 1 16 B chunks (4 B copies
// where the rows are not 16 B aligned); each lane reads its slot once with
// 16 B shared loads and decodes from registers (naszip::seg_part_bursts).
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

// f32 rows: lane j's copy of segment s lands at tile + j * slot (words).
// Every thread of the warp calls stage() (the shuffles need all 32).  A
// segment needs no descriptor (segment() is s).
template <bool VEC, bool IP>
struct F32Tiles {
  const float* db;
  const float* q;
  int dim, seg;
  int slot;  // words per lane slot: 4 x an odd count when VEC, else odd
  int per;   // copies per lane: seg / 4 when VEC, else seg
  // Copy c = lane + 32 i of a stage is chunk k = c % per of lane j = c / per;
  // (j0, k0) at i = 0, stepped by (dj, dk) = (32 / per, 32 % per) with a
  // carry, so no copy divides.
  int j0, k0, dj, dk;
  __device__ __forceinline__ int segment(int s) const { return s; }
  __device__ __forceinline__ void stage(int s, unsigned live, int id, int,
                                        uint32_t* tile) const {
    int j = j0, k = k0;
    for (int i = 0; i < per; ++i) {  // every thread: per copies
      const int rid = __shfl_sync(kFull, id, j);
      if ((live >> j) & 1u) {
        const float* src = db + static_cast<long long>(rid) * dim + s * seg;
        if constexpr (VEC) {
          cp_async16(tile + j * slot + 4 * k, src + 4 * k);
        } else {
          cp_async4(tile + j * slot + k, src + k);
        }
      }
      j += dj;
      k += dk;
      if (k >= per) {
        k -= per;
        ++j;
      }
    }
  }
  // Segment s's partial score from the lane's landed slot, summed in
  // feature order as fee_distance's seg_part does.
  __device__ __forceinline__ float part(const uint32_t* lane_slot, int, int s,
                                        long long qi) const {
    const float* x = reinterpret_cast<const float*>(lane_slot);
    const float* qs = q + qi * dim + s * seg;
    float sum = 0.0f;
    if constexpr (VEC) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      if ((reinterpret_cast<uintptr_t>(qs) & 15) == 0) {
        const float4* q4 = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
        for (int k = 0; k < seg / 4; ++k) {
          const float4 v = x4[k], y = __ldg(q4 + k);
          sum = naszip::fee_term_ip<IP>(v.x, y.x, sum);
          sum = naszip::fee_term_ip<IP>(v.y, y.y, sum);
          sum = naszip::fee_term_ip<IP>(v.z, y.z, sum);
          sum = naszip::fee_term_ip<IP>(v.w, y.w, sum);
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < seg / 4; ++k) {
          const float4 v = x4[k];
          sum = naszip::fee_term_ip<IP>(v.x, __ldg(qs + 4 * k), sum);
          sum = naszip::fee_term_ip<IP>(v.y, __ldg(qs + 4 * k + 1), sum);
          sum = naszip::fee_term_ip<IP>(v.z, __ldg(qs + 4 * k + 2), sum);
          sum = naszip::fee_term_ip<IP>(v.w, __ldg(qs + 4 * k + 3), sum);
        }
      }
    } else {
      for (int f = 0; f < seg; ++f) sum = naszip::fee_term_ip<IP>(x[f], __ldg(qs + f), sum);
    }
    return IP ? -sum : sum;
  }
};

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

// Packed rows: lane j's covering bursts of segment s land in NB + 1 16 B
// chunks (an odd count) at tile + j * slot.  segment() is the block's
// descriptor.
template <int NB, bool VEC, bool IP>
struct PackedTiles {
  static constexpr int slot = 4 * (NB + 1);  // words per lane slot
  const uint32_t* xp;
  long long pitch;
  int words;
  const int4* tab;  // (D,) burst table in shared memory
  const int4* blk;  // (S,) block descriptors in shared memory
  const float* q;
  int dim, seg;
  __device__ __forceinline__ int4 segment(int s) const { return blk[s]; }
  __device__ __forceinline__ void stage(int s, unsigned live, int id, int lane,
                                        uint32_t* tile) const {
    stage_bursts<VEC, NB + 1>(xp, pitch, words, blk[s], live, id, lane,
                              reinterpret_cast<uint4*>(tile));
  }
  // The lane reads its slot's bursts with 16 B shared loads and decodes
  // segment s, with descriptor d, from registers.
  __device__ __forceinline__ float part(const uint32_t* lane_slot, int4 d, int s,
                                        long long qi) const {
    const uint4* chunks = reinterpret_cast<const uint4*>(lane_slot);
    uint32_t w[4 * NB + 1];
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < (d.y & 0xFF)) v = chunks[c];
      w[4 * c] = v.x;
      w[4 * c + 1] = v.y;
      w[4 * c + 2] = v.z;
      w[4 * c + 3] = v.w;
    }
    w[4 * NB] = 0u;
    return naszip::seg_part_bursts<NB, IP>(w, d, tab, q + qi * dim, s * seg, seg);
  }
};

// One lane of a skip-DMA tile, carried by one thread.
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

// The warp loop of both kernels: tiles A (lanes g0 .. g0+31) and B
// (g0+32 .. g0+63), their slots at `tiles` + the warp's 2 x 32 slots.
// Commit order A(0), B(0), then per segment: wait for A(s), score A, commit
// A(s+1) for A's live lanes; wait for B(s), score B, commit B(s+1).  Each
// wait_group 1 leaves only the other tile's latest copy in flight.  Every
// thread runs the loop (the shuffles and copies need all 32); lanes past
// the batch are dead lanes.  The segment's descriptor is read once, before
// the waits.
template <class Tiles>
__device__ __forceinline__ void skip_warp(const Tiles& t, uint32_t* tiles, const int* ids,
                                          const uint8_t* alive, long long n_rows,
                                          const float* thr, const naszip::FeeArgs& a,
                                          long long n_total, int lanes, float* dist,
                                          uint8_t* rejected, int* segs_used) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* tile_a = tiles + warp * 2 * 32 * t.slot;
  uint32_t* tile_b = tile_a + 32 * t.slot;
  const long long g0 = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * 64;
  TileLane la = tile_lane(g0 + lane, ids, alive, n_rows, thr, n_total, lanes);
  TileLane lb = tile_lane(g0 + 32 + lane, ids, alive, n_rows, thr, n_total, lanes);
  auto score = [&](TileLane& l, const uint32_t* tile, auto sd, int s) {
    if (!l.live) return;
    l.exited = naszip::fee_step(t.part(tile + lane * t.slot, sd, s, l.qi), s, l.thr, a,
                                &l.acc);
    ++l.used;
    l.live = !l.exited;
  };
  unsigned ma = __ballot_sync(kFull, la.live), mb = __ballot_sync(kFull, lb.live);
  if (ma) t.stage(0, ma, la.id, lane, tile_a);
  cp_async_commit();
  if (mb) t.stage(0, mb, lb.id, lane, tile_b);
  cp_async_commit();
  for (int s = 0; s < a.n_segs && (ma | mb); ++s) {
    const bool more = s + 1 < a.n_segs;
    const auto sd = t.segment(s);
    cp_async_wait_group<1>();  // A(s) has landed; B(s) may be in flight
    __syncwarp();
    score(la, tile_a, sd, s);
    __syncwarp();  // A's slots are read: A(s+1) may overwrite them
    ma = __ballot_sync(kFull, la.live);
    if (more && ma) t.stage(s + 1, ma, la.id, lane, tile_a);
    cp_async_commit();
    cp_async_wait_group<1>();  // B(s) has landed; A(s+1) may be in flight
    __syncwarp();
    score(lb, tile_b, sd, s);
    __syncwarp();
    mb = __ballot_sync(kFull, lb.live);
    if (more && mb) t.stage(s + 1, mb, lb.id, lane, tile_b);
    cp_async_commit();
  }
  cp_async_wait_all();
  write_lane(la, n_total, dist, rejected, segs_used);
  write_lane(lb, n_total, dist, rejected, segs_used);
}

template <bool VEC, bool IP>
__global__ void fee_skipdma_f32_kernel(const float* __restrict__ db, long long n_rows, int dim,
                                       int slot, const int* __restrict__ ids,
                                       const uint8_t* __restrict__ alive,
                                       const float* __restrict__ q,
                                       const float* __restrict__ thr, naszip::FeeArgs a,
                                       long long n_total, int lanes, float* __restrict__ dist,
                                       uint8_t* __restrict__ rejected,
                                       int* __restrict__ segs_used) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int per = VEC ? a.seg / 4 : a.seg, lane = threadIdx.x & 31;
  skip_warp(F32Tiles<VEC, IP>{db, q, dim, a.seg, slot, per, lane / per, lane % per, 32 / per,
                              32 % per},
            reinterpret_cast<uint32_t*>(smem), ids, alive, n_rows, thr, a, n_total, lanes, dist,
            rejected, segs_used);
}

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
  extern __shared__ __align__(16) unsigned char smem[];
  int4* tab = reinterpret_cast<int4*>(smem);  // (D,) burst table
  int4* blk = tab + dim;                      // (S,) block descriptors
  for (int f = threadIdx.x; f < dim; f += blockDim.x) tab[f] = table[f];
  for (int s = threadIdx.x; s < a.n_segs; s += blockDim.x) blk[s] = blocks[s];
  __syncthreads();
  skip_warp(PackedTiles<NB, VEC, IP>{xp, pitch, words, tab, blk, q, dim, a.seg},
            reinterpret_cast<uint32_t*>(blk + a.n_segs), ids, alive, n_rows, thr, a, n_total,
            lanes, dist, rejected, segs_used);
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
// ``slot`` is the words of a lane's slot (kernels/fee_distance.py::
// skipdma_f32_slot): a multiple of 4 words that is an odd count of 16 B
// chunks takes the 16 B path, which also needs seg % 4 == 0 and 16 B aligned
// rows of a dim % 4 == 0 matrix; an odd count of words the 4 B path.
// ``warps`` warps per block, each scoring two tiles of 32 lanes; the caller
// sizes them to the shared memory.  Returns the cudaError_t of the launch (0
// on success).
int naszip_fee_skipdma_f32(const void* db, long long n_rows, int dim, const void* ids,
                           const void* alive, const void* q, const void* thr, const void* alpha,
                           const void* beta, const void* margin, long long n_q, int lanes,
                           int seg, int ip, int slot, int warps, void* dist, void* rejected,
                           void* segs_used, void* stream) {
  const long long n_total = n_q * lanes;
  if (n_total == 0) return 0;
  if (slot < seg) return static_cast<int>(cudaErrorInvalidValue);
  const naszip::FeeArgs a = fee_args(alpha, beta, margin, dim, seg, ip);
  const bool vec = slot % 4 == 0 && seg % 4 == 0 && dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(db) % 16 == 0;
  auto kernel = vec ? (ip ? &fee_skipdma_f32_kernel<true, true>
                          : &fee_skipdma_f32_kernel<true, false>)
                    : (ip ? &fee_skipdma_f32_kernel<false, true>
                          : &fee_skipdma_f32_kernel<false, false>);
  const int threads = warps * 32;
  const long long per_block = 64LL * warps;  // two tiles per warp
  const dim3 grid(static_cast<unsigned>((n_total + per_block - 1) / per_block));
  const size_t smem = static_cast<size_t>(warps) * 2 * 32 * slot * sizeof(float);
  const cudaError_t err = naszip::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(db), n_rows, dim, slot, static_cast<const int*>(ids),
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
