// Tiered Dfloat FEE early-exit kernel for Hopper (sm_90a), batched over
// queries with the row gather fused by id.
//
//   naszip_fee_tiered  replaces repro/kernels/fee_distance.py ::
//                      fee_distance_tiered_pallas (_tiered_kernel)
//
// The row is split at a segment boundary into a resident coarse tier (C, Wc)
// and a residual tier (C, Wr), each its own burst-aligned bitstream.  The TPU
// kernel streams the coarse blocks and DMAs the residual word spans only for
// tiles with a live lane.  Here one thread scores one lane, as
// fee_packed_kernel does, with its burst-staged decode applied per tier: for
// each live segment s the lane stages the block's covering bursts
// (kernels/fee_distance.py::block_bursts of the tier's own layout) from the
// coarse row while s < Sc = Dc / seg and from the residual row after that, 16
// B at a time where that tier's rows allow it (naszip::burst_loads), else 4 B
// at a time, and decodes the staged words in registers
// (naszip::seg_part_bursts).  The block descriptors and burst table of both
// tiers sit in shared memory, coarse first (kernels/fee_distance.py::
// _tier_tables).  A lane reads the residual row only for segments it
// reaches, so exited and dead lanes never touch xr: the survivor-fetch
// contract.  One kernel takes every split, 0 and S included (an empty tier's
// rows are never read; the TPU kernel falls back to the packed kernels there
// only because a Pallas kernel cannot take an empty tier).
//
// Bound on this card: bytes (each live segment's covering bursts in its
// tier, ~32 B for ~3 flops per feature); the decode's instructions, not the
// bytes, set most of the time, which the compile-time positions of
// one-format blocks keep low.  split_config keeps every feature's format and
// the accumulate/exit step is naszip::fee_step, so outputs are bit-identical
// to fee_distance_packed over the parent layout's rows at every split.
#include "naszip_common.cuh"

namespace {

constexpr int kThreads = 256;

// VC, VR: the coarse and the residual tier take 16 B loads.  The main
// path's staging of two bursts is held to 40 registers, six blocks an SM.
template <int NB, bool VC, bool VR, bool IP>
__global__ void __launch_bounds__(kThreads, NB <= 2 ? 6 : 1)
    fee_tiered_kernel(const uint32_t* __restrict__ xc, const uint32_t* __restrict__ xr,
                      long long n_rows, int wc, long long pitch_c, int wr, long long pitch_r,
                      int sc, int dim, const int4* __restrict__ table,
                      const int4* __restrict__ blocks, const int* __restrict__ ids,
                      const uint8_t* __restrict__ alive, const float* __restrict__ q,
                      const float* __restrict__ thr, naszip::FeeArgs a, long long n_total,
                      int lanes, float* __restrict__ dist, uint8_t* __restrict__ rejected,
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
    const uint32_t* row_c = xc + id * pitch_c;
    const uint32_t* row_r = xr + id * pitch_r;
    const float* qr = q + qi * dim;
    naszip::fee_lane_parts(
        [&](int s) {
          const int4 d = blk[s];
          const bool coarse = s < sc;
          uint32_t w[4 * NB + 1];
          if constexpr (VC == VR) {
            naszip::BurstRow<NB, VC>{coarse ? row_c : row_r, coarse ? wc : wr}.load(d, w);
          } else if (coarse) {  // uniform over the lanes that score segment s
            naszip::BurstRow<NB, VC>{row_c, wc}.load(d, w);
          } else {
            naszip::BurstRow<NB, VR>{row_r, wr}.load(d, w);
          }
          return naszip::seg_part_bursts<NB, IP>(w, d, tab, qr, s * a.seg, a.seg);
        },
        __ldg(thr + qi), a, dist + g, rejected + g, segs_used + g);
  } else {
    naszip::dead_lane(dist + g, rejected + g, segs_used + g);
  }
}

// The fee_tiered_kernel built for NB staged bursts: 16 B or 4 B loads from
// each tier, and the metric.
template <int NB, bool VC, bool VR>
auto pick_ip(bool ip) {
  return ip ? &fee_tiered_kernel<NB, VC, VR, true> : &fee_tiered_kernel<NB, VC, VR, false>;
}

template <int NB>
auto pick(bool vec_c, bool vec_r, bool ip) {
  if (vec_c) return vec_r ? pick_ip<NB, true, true>(ip) : pick_ip<NB, true, false>(ip);
  return vec_r ? pick_ip<NB, false, true>(ip) : pick_ip<NB, false, false>(ip);
}

}  // namespace

extern "C" {

// All pointers are device pointers of contiguous tensors, except the tier
// rows: (n_rows, wc) and (n_rows, wr) words at a pitch of pitch_c and
// pitch_r words; alive may be null, and so may an empty tier's rows.  dc,
// the coarse tier's features, is a multiple of seg.  table is the (dim, 4)
// burst table and blocks the (S, 4) block descriptors of both tiers, coarse
// first (kernels/fee_distance.py::_tier_tables); nb (2, 4, 8 or 16) is the
// staging size.  Returns the cudaError_t of the launch (0 on success).
int naszip_fee_tiered(const void* xc, const void* xr, long long n_rows, int wc,
                      long long pitch_c, int wr, long long pitch_r, int dc, int dim,
                      const void* table, const void* blocks, int nb, const void* ids,
                      const void* alive, const void* q, const void* thr, const void* alpha,
                      const void* beta, const void* margin, long long n_q, int lanes, int seg,
                      int ip, void* dist, void* rejected, void* segs_used, void* stream) {
  const long long n_total = n_q * lanes;
  if (n_total == 0) return 0;
  if (dc % seg) return static_cast<int>(cudaErrorInvalidValue);
  const naszip::FeeArgs a{static_cast<const float*>(alpha), static_cast<const float*>(beta),
                          static_cast<const float*>(margin), dim / seg, seg, ip};
  // an empty tier is never read: it counts as aligned
  const bool vec_c = wc == 0 || naszip::burst_loads(xc, pitch_c, wc);
  const bool vec_r = wr == 0 || naszip::burst_loads(xr, pitch_r, wr);
  decltype(&fee_tiered_kernel<2, true, true, true>) kernel;
  switch (nb) {
    case 2: kernel = pick<2>(vec_c, vec_r, ip); break;
    case 4: kernel = pick<4>(vec_c, vec_r, ip); break;
    case 8: kernel = pick<8>(vec_c, vec_r, ip); break;
    case 16: kernel = pick<16>(vec_c, vec_r, ip); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(dim) * sizeof(int4) +
                      static_cast<size_t>(a.n_segs) * sizeof(int4);
  const cudaError_t err = naszip::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_total + kThreads - 1) / kThreads));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xc), static_cast<const uint32_t*>(xr), n_rows, wc, pitch_c,
      wr, pitch_r, dc / seg, dim, static_cast<const int4*>(table),
      static_cast<const int4*>(blocks), static_cast<const int*>(ids),
      static_cast<const uint8_t*>(alive), static_cast<const float*>(q),
      static_cast<const float*>(thr), a, n_total, lanes, static_cast<float*>(dist),
      static_cast<uint8_t*>(rejected), static_cast<int*>(segs_used));
  return static_cast<int>(cudaGetLastError());
}

const char* naszip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
