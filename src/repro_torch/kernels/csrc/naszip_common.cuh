// Device code shared by the NasZip kernels: the Dfloat field decoder and the
// FEE accumulate/exit step.  All five FEE kernels (f32 rows, packed rows,
// tiered rows, and the two skip-DMA kernels) sum a segment with seg_part()
// and take fee_step(), so they add the same values in the same order with the
// same rounding: packed, tiered and skip-DMA scores are bit-identical to f32
// scores over the emulated (db_q) rows.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace naszip {

// One feature of a packed Dfloat row, built on the host from
// dfloat.feature_positions (kernels/dfloat_unpack.py::decode_table):
//   x = word index, y = bit offset | width << 8,
//   z = n_exp | n_man << 8, w = exponent bias.
// word(i) returns word i of the row; the second word is read only for a field
// that spans two words.
template <class Word>
__device__ __forceinline__ float decode_field(Word word, int4 t) {
  const int ofs = t.y & 0xFF, width = t.y >> 8;
  const int n_exp = t.z & 0xFF, n_man = t.z >> 8;
  uint32_t v = word(t.x) >> ofs;
  if (ofs + width > 32) v |= word(t.x + 1) << (32 - ofs);  // ofs > 0 here
  const uint32_t fld = width == 32 ? v : (v & ((1u << width) - 1u));
  if (fld == 0u) return 0.0f;  // a zero field stays zero
  const uint32_t sign = (fld >> (width - 1)) & 1u;
  const uint32_t e = (fld >> n_man) & ((1u << n_exp) - 1u);
  const uint32_t man = fld & ((1u << n_man) - 1u);
  // 127 - bias wraps modulo 2^32 when bias > 127, as the reference decoder's
  // uint32 arithmetic does; e + ebias is the f32 exponent for every valid field
  const uint32_t ebias = static_cast<uint32_t>(127 - t.w);
  return __uint_as_float((sign << 31) | ((e + ebias) << 23) | (man << (23 - n_man)));
}

// The same decode from a row in device memory.
__device__ __forceinline__ float decode_feature(const uint32_t* row, int4 t) {
  return decode_field([row](int i) { return __ldg(row + i); }, t);
}

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
template <bool VEC, class Row>
__device__ __forceinline__ void fee_lane(const Row& row, const float* q, float thr,
                                         const FeeArgs& a, float* dist, uint8_t* rejected,
                                         int* segs_used) {
  float acc = 0.0f;
  int s = 0;
  bool exited = false;
  while (s < a.n_segs && !exited) {
    exited = fee_step(seg_part<VEC>(row, q, s * a.seg, a), s, thr, a, &acc);
    ++s;
  }
  *dist = acc;
  *rejected = exited;
  *segs_used = s;
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

}  // namespace naszip
