// Device code shared by the NasZip kernels: the Dfloat field widening and
// compile-time field positions (also used by dfloat_unpack.cu), the
// burst-staged block decode of the three packed FEE kernels (packed rows,
// tier rows, packed skip-DMA), and the FEE accumulate/exit step.  All five
// FEE kernels (f32 rows, packed rows, tiered rows, and the two skip-DMA
// kernels) sum a segment in feature order through fee_term() or
// fee_term_ip() (seg_part(), seg_part_bursts(), or the f32 skip-DMA
// kernel's own loop over its landed floats) and take fee_step(), so they
// add the same values in the same order with the same rounding: packed,
// tiered and skip-DMA scores are bit-identical to f32 scores over the
// emulated (db_q) rows.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace naszip {

struct FeeArgs {
  const float* alpha;   // (S,)
  const float* beta;    // (S,)
  const float* margin;  // (S,)
  int n_segs;
  int seg;
  int ip;               // 0: squared L2, 1: negated inner product
};

__device__ __forceinline__ float fee_term(float x, float y, float part, int ip) {
  if (ip) return __fmaf_rn(x, y, part);
  const float d = __fsub_rn(x, y);
  return __fmaf_rn(d, d, part);
}

// Segment s's partial score: a sequential sum over its features, read four at
// a time when VEC (seg % 4 == 0 and 16-byte aligned rows and queries; only
// rows with a load4 take it).
template <bool VEC, class Row>
__device__ __forceinline__ float seg_part(const Row& row, const float* q, int f0,
                                          const FeeArgs& a) {
  float part = 0.0f;
  if constexpr (VEC) {
    for (int f = f0; f < f0 + a.seg; f += 4) {
      const float4 x = row.load4(f);
      const float4 y = __ldg(reinterpret_cast<const float4*>(q + f));
      part = fee_term(x.x, y.x, part, a.ip);
      part = fee_term(x.y, y.y, part, a.ip);
      part = fee_term(x.z, y.z, part, a.ip);
      part = fee_term(x.w, y.w, part, a.ip);
    }
  } else {
    for (int f = f0; f < f0 + a.seg; ++f) part = fee_term(row.load1(f), __ldg(q + f), part, a.ip);
  }
  return a.ip ? -part : part;
}

// The widening of a packed field fld (masked to its width) with its format's
// constants, precomputed on the host (kernels/fee_distance.py::
// block_bursts): body = the mask of the field's exponent and mantissa bits,
// mul = 1 << (23 - n_man), ebias = (127 - bias) << 23 modulo 2^32.  The body
// times mul puts the exponent at bit 23 and the mantissa's top at bit 22,
// where adding ebias re-biases the exponent (the mantissa bits below cannot
// carry); the sign is the field's top bit.  Bit-identical to the reference's
// decode_fields: the exponent re-bias wraps modulo 2^32 when bias > 127, as
// its uint32 arithmetic does.
__device__ __forceinline__ float widen_field(uint32_t fld, uint32_t body, uint32_t mul,
                                             uint32_t ebias) {
  const uint32_t bits = (fld & body) * mul + ebias;
  const uint32_t sign = fld > body ? 0x80000000u : 0u;
  return fld == 0u ? 0.0f : __uint_as_float(bits | sign);  // a zero field stays zero
}

// One row of the burst table: x = bit offset | word index relative to word
// 4 * b0 << 5, y = field mask (1 << width) - 1, z = mul, w = ebias.  v is the
// field shifted down to bit 0.
__device__ __forceinline__ float decode_burst_field(uint32_t v, int4 t) {
  const uint32_t mask = static_cast<uint32_t>(t.y);
  return widen_field(v & mask, mask >> 1, static_cast<uint32_t>(t.z),
                     static_cast<uint32_t>(t.w));
}

// fee_term with the metric fixed at compile time (the same operations).
template <bool IP>
__device__ __forceinline__ float fee_term_ip(float x, float y, float part) {
  if constexpr (IP) return __fmaf_rn(x, y, part);
  const float d = __fsub_rn(x, y);
  return __fmaf_rn(d, d, part);
}

// The burst-staged block decode of the packed FEE kernels.  A FEE block's
// fields, carry words included, lie in its covering bursts [b0, b1): 16 B
// units of the row, 4-word aligned (kernels/fee_distance.py::block_bursts).
// A lane stages those bursts' words in w (w[4 * NB] and the words past the
// block's bursts zero), read once with 16 B loads or copies, and decodes the
// block's fields from registers: a dynamically indexed register array would
// live in local memory, so every word is picked by a compile-time index or by
// compare/select.  Both decoders sum the features in order as fee_term does
// (IP: the metric), so packed scores equal f32 scores bit for bit.
//
// seg_part_table: any block, from the burst table.  The features of a block
// are in word order, so the unrolled loop over the staged bursts takes each
// burst's fields in turn and picks a field's word pair among the burst's four
// words and the next burst's first (a carry word) by compare/select.
template <int NB, bool IP>
__device__ __forceinline__ float seg_part_table(const uint32_t (&w)[4 * NB + 1],
                                                const int4* table, const float* q, int f0,
                                                int seg) {
  float part = 0.0f;
  int f = f0;
  const int f_end = f0 + seg;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    for (; f < f_end; ++f) {
      const int4 t = table[f];
      if ((t.x >> 7) != c) break;  // the block's next field lies in a later burst
      const bool upper = (t.x & 64) != 0, odd = (t.x & 32) != 0;  // words 2-3; word 1 or 3
      const uint32_t p0 = upper ? w[4 * c + 2] : w[4 * c];
      const uint32_t p1 = upper ? w[4 * c + 3] : w[4 * c + 1];
      const uint32_t p2 = upper ? w[4 * c + 4] : w[4 * c + 2];
      const uint32_t lo = odd ? p1 : p0, hi = odd ? p2 : p1;
      const float x = decode_burst_field(__funnelshift_r(lo, hi, t.x), t);  // shift t.x & 31
      part = fee_term_ip<IP>(x, __ldg(q + f), part);
    }
  }
  return IP ? -part : part;
}

// Field l of staged burst c of a width-W run that starts the burst, shifted
// down to bit 0 (c and l compile-time: the position is fixed).
template <int W, int NB>
__device__ __forceinline__ uint32_t static_field(const uint32_t (&w)[4 * NB + 1], int c, int l) {
  const int bit = l * W, wi = 4 * c + bit / 32, ofs = bit % 32;
  return ofs + W > 32 ? __funnelshift_r(w[wi], w[wi + 1], ofs) : w[wi] >> ofs;
}

// Field l of staged burst c of a width-W run that starts the burst, widened.
template <int W, int NB>
__device__ __forceinline__ float static_value(const uint32_t (&w)[4 * NB + 1], int c, int l,
                                              uint32_t mul, uint32_t ebias) {
  constexpr uint32_t MASK = W == 32 ? 0xffffffffu : (1u << W) - 1u;
  return widen_field(static_field<W, NB>(w, c, l) & MASK, MASK >> 1, mul, ebias);
}

// seg_part_static: a block whose seg fields share one format of width W and
// start a 128-bit burst.  Field j then lies at bit (j % PER) * W of burst
// j / PER, a compile-time position, as the TPU kernel's static shifts
// (_decode_block) have it; only the format's mul and ebias come from the
// block's descriptor.  A burst whose PER fields all belong to the block runs
// unguarded, so its query loads issue together, as float4s where PER % 4 == 0
// and the query slice is 16 B aligned.
template <int W, int NB, bool IP>
__device__ __forceinline__ float seg_part_static(const uint32_t (&w)[4 * NB + 1], uint32_t mul,
                                                 uint32_t ebias, const float* q, int seg) {
  constexpr int PER = 128 / W;
  const bool q16 = (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (c * PER >= seg) break;
    if ((c + 1) * PER <= seg) {
      if constexpr (PER % 4 == 0) {
        if (q16) {
#pragma unroll
          for (int l = 0; l < PER; l += 4) {
            const float4 y = __ldg(reinterpret_cast<const float4*>(q + c * PER + l));
            part = fee_term_ip<IP>(static_value<W, NB>(w, c, l, mul, ebias), y.x, part);
            part = fee_term_ip<IP>(static_value<W, NB>(w, c, l + 1, mul, ebias), y.y, part);
            part = fee_term_ip<IP>(static_value<W, NB>(w, c, l + 2, mul, ebias), y.z, part);
            part = fee_term_ip<IP>(static_value<W, NB>(w, c, l + 3, mul, ebias), y.w, part);
          }
          continue;
        }
      }
#pragma unroll
      for (int l = 0; l < PER; ++l) {
        part = fee_term_ip<IP>(static_value<W, NB>(w, c, l, mul, ebias), __ldg(q + c * PER + l),
                               part);
      }
    } else {
#pragma unroll
      for (int l = 0; l < PER; ++l) {
        if (c * PER + l == seg) break;
        part = fee_term_ip<IP>(static_value<W, NB>(w, c, l, mul, ebias), __ldg(q + c * PER + l),
                               part);
      }
    }
  }
  return IP ? -part : part;
}

// Segment s's partial score from the staged words of its block, described by
// d = (b0, nb | W << 8, mul, ebias): W != 0 takes the compile-time positions
// of seg_part_static (built for NB <= 4: the unrolled positions of a larger
// staging would not stay in registers), W == 0 the burst table.  The branch
// is uniform over the lanes that score segment s.
template <int NB, bool IP>
__device__ __forceinline__ float seg_part_bursts(const uint32_t (&w)[4 * NB + 1], int4 d,
                                                 const int4* table, const float* q, int f0,
                                                 int seg) {
  if constexpr (NB <= 4) {
    const uint32_t mul = static_cast<uint32_t>(d.z), ebias = static_cast<uint32_t>(d.w);
    const float* qs = q + f0;
    switch (d.y >> 8) {
      case 32: return seg_part_static<32, NB, IP>(w, mul, ebias, qs, seg);
      case 24: return seg_part_static<24, NB, IP>(w, mul, ebias, qs, seg);
      case 21: return seg_part_static<21, NB, IP>(w, mul, ebias, qs, seg);
      case 18: return seg_part_static<18, NB, IP>(w, mul, ebias, qs, seg);
      case 16: return seg_part_static<16, NB, IP>(w, mul, ebias, qs, seg);
      case 14: return seg_part_static<14, NB, IP>(w, mul, ebias, qs, seg);
      case 12: return seg_part_static<12, NB, IP>(w, mul, ebias, qs, seg);
      default: break;
    }
  }
  return seg_part_table<NB, IP>(w, table, q, f0, seg);
}

// A lane's packed row, for the kernels that stage a block's covering bursts
// in registers (fee_distance_packed, fee_distance_tiered).  load() stages the
// bursts of the block with descriptor d = (b0, nb | W << 8, ...): 16 B loads
// when VEC (burst_loads: 16 B aligned row base, a pitch and W that are
// multiples of 4 words), otherwise the same words 4 B at a time, clipped to
// the row's W words.  Each word is read once; the staging past the block's
// bursts is zero.
template <int NB, bool VEC>
struct BurstRow {
  const uint32_t* p;
  int words;  // W: the row's words (the pitch may be larger)
  __device__ __forceinline__ void load(int4 d, uint32_t (&w)[4 * NB + 1]) const {
    if constexpr (VEC) {
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < (d.y & 0xFF)) v = __ldg(reinterpret_cast<const uint4*>(p) + d.x + c);
        w[4 * c] = v.x;
        w[4 * c + 1] = v.y;
        w[4 * c + 2] = v.z;
        w[4 * c + 3] = v.w;
      }
    } else {
      const int w0 = 4 * d.x, n = min(4 * (d.y & 0xFF), words - w0);
#pragma unroll
      for (int i = 0; i < 4 * NB; ++i) w[i] = i < n ? __ldg(p + w0 + i) : 0u;
    }
    w[4 * NB] = 0u;
  }
};

// Add segment s's partial score to the accumulator and decide the exit.  The
// estimate is rounded at every operation, as the plain version's elementwise
// float32 ops are; a lane exits only before the last segment: there the full
// score is known.
__device__ __forceinline__ bool fee_step(float part, int s, float thr, const FeeArgs& a,
                                         float* acc) {
  *acc = __fadd_rn(*acc, part);
  const float est = __fsub_rn(__fdiv_rn(__fmul_rn(__ldg(a.alpha + s), *acc), __ldg(a.beta + s)),
                              __ldg(a.margin + s));
  return s + 1 < a.n_segs && est >= thr;
}

// FEE early exit for one lane.  Segment s is read only while the lane is
// alive: a lane that exits stops streaming its row, which is the paper's
// point.  Rejected lanes report the partial score of the segments they used.
// part(s) reads and sums segment s.
template <class Part>
__device__ __forceinline__ void fee_lane_parts(Part part, float thr, const FeeArgs& a,
                                               float* dist, uint8_t* rejected, int* segs_used) {
  float acc = 0.0f;
  int s = 0;
  bool exited = false;
  while (s < a.n_segs && !exited) {
    exited = fee_step(part(s), s, thr, a, &acc);
    ++s;
  }
  *dist = acc;
  *rejected = exited;
  *segs_used = s;
}

template <bool VEC, class Row>
__device__ __forceinline__ void fee_lane(const Row& row, const float* q, float thr,
                                         const FeeArgs& a, float* dist, uint8_t* rejected,
                                         int* segs_used) {
  fee_lane_parts([&](int s) { return seg_part<VEC>(row, q, s * a.seg, a); }, thr, a, dist,
                 rejected, segs_used);
}

// A lane that is not scored (dead, or its id names no row) reports dist 0,
// rejected, 0 segments: it moved no bytes.
__device__ __forceinline__ void dead_lane(float* dist, uint8_t* rejected, int* segs_used) {
  *dist = 0.0f;
  *rejected = 1;
  *segs_used = 0;
}

// A lane is scored only when it is alive and its id names a row.
__device__ __forceinline__ bool lane_live(const int* ids, const uint8_t* alive, long long g,
                                          long long n_rows, int* id) {
  *id = ids[g];
  return (alive == nullptr || alive[g]) && *id >= 0 && *id < n_rows;
}

// Whether the packed kernels can read a block's covering bursts 16 B at a
// time: a 16 B aligned row base, and a pitch and W that are multiples of 4
// words (so every row's bursts are aligned and lie inside its W words).
inline bool burst_loads(const void* xp, long long pitch, int words) {
  return reinterpret_cast<uintptr_t>(xp) % 16 == 0 && pitch % 4 == 0 && words % 4 == 0;
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace naszip
