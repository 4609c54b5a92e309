// The greedy descent through the graph's upper levels for Hopper (sm_90a):
// every query's walk from the entry node down to its base-level entry, all
// levels in one launch.
//
// Replaces no TPU kernel: the JAX package leaves the descent to XLA
// (repro/core/search.py::descend_entry), and the port ran it as a host loop
// of batched torch steps, ~15 launches and one sync a step, every query
// through every step.  The plain version is kernels/ref.py::descend_ref.
//
// One warp a query, kWarps queries a block; the query's features are staged
// in shared memory.  Levels are walked top first from the flat layout of
// core/search.py::DeviceLevels: one ids array (each level's sorted global
// ids), one adjacency array (each level's (n, m) level-local positions,
// row-major) and a (levels, 4) int64 table of (ids offset, n, adjacency
// offset, m).  On each level the warp
//   1. finds its entry among the level's sorted ids by a binary search, 32
//      probes a round (the level's first position when the entry is not
//      there, as the plain version's searchsorted and where);
//   2. steps: gathers the current node's m neighbour positions in one
//      coalesced read and their global ids, scores their rows, takes the
//      first minimum (the lowest slot on ties, as torch.argmin) and moves
//      there only if it is strictly nearer; a query that stops improving
//      leaves the level at once;
//   3. records its moves in the level's counter (atomicMax), so the host
//      can tell the plain loop's step count without a sync a step.
//
// Scoring a step's rows.  A row is read in units of at most 16 B: four
// features of an f32 row, a 128-bit burst of a packed or tier row (the
// Dfloat layout puts every field of a burst at a compile-time position of
// its width, as dfloat_unpack.cu decodes it; a layout of one width is
// decoded without a switch), or, for layouts whose bursts are not 128 bits,
// one field.  G lanes (the least power of two holding a row's units, at
// most 32) take a row, 32 / G rows a pass; a lane issues the loads of kBuf
// units (of one or several rows) before it decodes any, so a step pays a
// few memory latencies, not one a row.  Fields are widened with
// naszip::widen_field, so each decoded row is bit-equal to the
// dfloat_unpack kernel's.  Each unit's terms are summed from 0 in feature
// order by fee_term's rule (l2: fma of the difference, ip: fma of the
// product, negated at the end), a lane adds its units' sums in order, and
// the G lanes' sums are added in a fixed butterfly order, so a distance is
// the same in every pass and call.  Distances are not bit-equal to the
// plain version's torch sums: a near tie may send a walk another way there.
//
// Bound on this card: the latency of each step's dependent loads and of
// its decode and sums, hidden only by the other resident warps (a step
// waits on the one before: position, id, row, decision).  A call is a
// memset of the move counters and the launch; it allocates nothing and does
// not synchronise.
#include "naszip_common.cuh"

namespace {

constexpr int kWarps = 4;     // queries a block, one warp each
constexpr int kMaxM = 256;    // a level's adjacency width a launch takes
constexpr int kBuf = 4;       // units a lane loads before it decodes

enum Kind { kF32 = 0, kBurst = 1, kField = 2 };

// The storage's rows: one tensor (f32, packed) or a tier pair (coarse, then
// residual features).  Unit u of a row: f32, features [4u, 4u + 4); burst,
// 16 B burst u of tier 0's row, or burst u - units0 of tier 1's; field,
// feature u, its word and offset from desc.
struct Rows {
  const uint32_t* p0;
  const uint32_t* p1;
  long long pitch0, pitch1;  // words
  int in16;                  // bit t: tier t's rows take 16 B loads
  const int4* desc;          // burst: (first feature, n | width << 8, mul, ebias)
                             // field: (word, offset | width << 8 | tier << 16, mul, ebias)
  int units, units0, dim, group;
};

// Unit u's descriptor: the burst and field kinds' table row; for f32 rows
// (first feature, features in the unit, 0, 0).  A unit past the row's end
// gets one of no fields.
template <int KIND>
__device__ __forceinline__ int4 unit_desc(const Rows& R, int u, bool ok) {
  if (!ok) return make_int4(0, 0, 0, 0);
  if constexpr (KIND == kF32) return make_int4(4 * u, min(4, R.dim - 4 * u), 0, 0);
  return __ldg(R.desc + u);
}

// Unit u of row id (d: its descriptor).
template <int KIND>
__device__ __forceinline__ uint4 load_unit(const Rows& R, int4 d, long long id, int u) {
  if constexpr (KIND == kF32) {
    const uint32_t* row = R.p0 + id * R.pitch0;
    if (R.in16) return __ldg(reinterpret_cast<const uint4*>(row) + u);
    const int f = 4 * u;
    return make_uint4(__ldg(row + f), d.y > 1 ? __ldg(row + f + 1) : 0u,
                      d.y > 2 ? __ldg(row + f + 2) : 0u, d.y > 3 ? __ldg(row + f + 3) : 0u);
  } else if constexpr (KIND == kBurst) {
    const int t = u >= R.units0;
    const int b = u - t * R.units0;
    const uint32_t* row = t ? R.p1 + id * R.pitch1 : R.p0 + id * R.pitch0;
    if ((R.in16 >> t) & 1) return __ldg(reinterpret_cast<const uint4*>(row) + b);
    return make_uint4(__ldg(row + 4 * b), __ldg(row + 4 * b + 1), __ldg(row + 4 * b + 2),
                      __ldg(row + 4 * b + 3));
  } else {
    const int ofs = d.y & 0xFF, width = (d.y >> 8) & 0xFF;
    const uint32_t* row = (d.y >> 16) ? R.p1 + id * R.pitch1 : R.p0 + id * R.pitch0;
    return make_uint4(__ldg(row + d.x), ofs + width > 32 ? __ldg(row + d.x + 1) : 0u, 0u, 0u);
  }
}

// fn(feature, value) for the n fields of a width-W burst staged in w.
template <int W, class Fn>
__device__ __forceinline__ void burst_fields(const uint32_t (&w)[5], int n, uint32_t mul,
                                             uint32_t ebias, int f0, Fn& fn) {
  constexpr int PER = 128 / W;
#pragma unroll
  for (int l = 0; l < PER; ++l)
    if (l < n) fn(f0 + l, naszip::static_value<W, 1>(w, 0, l, mul, ebias));
}

// fn(feature, value) for each field of unit u, loaded as v, in feature order
// (d: its descriptor; a unit of no fields calls nothing).  W: the width of
// every burst of the layout, or 0 when they differ (a switch a unit).
template <int KIND, int W, class Fn>
__device__ __forceinline__ void unit_fields(int4 d, int u, uint4 v, Fn& fn) {
  if constexpr (KIND == kF32) {
    if (d.y > 0) fn(d.x, __uint_as_float(v.x));
    if (d.y > 1) fn(d.x + 1, __uint_as_float(v.y));
    if (d.y > 2) fn(d.x + 2, __uint_as_float(v.z));
    if (d.y > 3) fn(d.x + 3, __uint_as_float(v.w));
  } else if constexpr (KIND == kBurst) {
    const uint32_t w[5] = {v.x, v.y, v.z, v.w, 0u};
    const int n = d.y & 0xFF;
    const uint32_t mul = static_cast<uint32_t>(d.z), ebias = static_cast<uint32_t>(d.w);
    if constexpr (W != 0) {
      burst_fields<W>(w, n, mul, ebias, d.x, fn);
    } else {
      switch ((d.y >> 8) & 0xFF) {  // the host sends only palette widths down this path
        case 32: burst_fields<32>(w, n, mul, ebias, d.x, fn); break;
        case 24: burst_fields<24>(w, n, mul, ebias, d.x, fn); break;
        case 21: burst_fields<21>(w, n, mul, ebias, d.x, fn); break;
        case 18: burst_fields<18>(w, n, mul, ebias, d.x, fn); break;
        case 16: burst_fields<16>(w, n, mul, ebias, d.x, fn); break;
        case 14: burst_fields<14>(w, n, mul, ebias, d.x, fn); break;
        case 12: burst_fields<12>(w, n, mul, ebias, d.x, fn); break;
        default: break;
      }
    }
  } else {
    const int ofs = d.y & 0xFF, width = (d.y >> 8) & 0xFF;
    if (width == 0) return;
    uint32_t x = v.x >> ofs;
    if (ofs + width > 32) x |= v.y << (32 - ofs);  // ofs > 0 here
    const uint32_t mask = width == 32 ? 0xffffffffu : (1u << width) - 1u;
    fn(u, naszip::widen_field(x & mask, mask >> 1, static_cast<uint32_t>(d.z),
                              static_cast<uint32_t>(d.w)));
  }
}

// The (pass, unit-of-the-row) item after (p, v): v counts 0..V-1 a pass.
__device__ __forceinline__ void next_item(int V, int& p, int& v) {
  if (++v == V) {
    v = 0;
    ++p;
  }
}

// The distances of the n rows ids[0..n) (shared memory) to the query qs (its
// D features in shared memory) into dist[0..n) (shared memory); the whole
// warp calls it.  Lane l takes row g = l / G of each pass and its units s,
// s + G, ... (s = l % G), a warp-uniform walk over (pass, unit) items, kBuf
// at a time: the loads of all kBuf items (descriptors, then row units) are
// issued before any is decoded, each item's terms are summed from 0 in
// feature order (independent chains, which the scheduler interleaves), and
// the items' sums are added to the lane's in item order; at a pass's end
// the G lanes' sums are added in butterfly order.
template <int KIND, bool IP, int W>
__device__ __forceinline__ void row_dists(const Rows& R, const float* qs, const int* ids, int n,
                                          float* dist, int lane) {
  const int G = R.group, per_pass = 32 / G;
  const int g = lane / G, s = lane - g * G;
  const int V = (R.units + G - 1) / G;  // units a lane takes of a row
  const int total = (n + per_pass - 1) / per_pass * V;
  float part = 0.0f;
  for (int i0 = 0; i0 < total; i0 += kBuf) {
    const int p0 = i0 / V, v0 = i0 - p0 * V;
    uint4 buf[kBuf];
    int4 dsc[kBuf];
    int p = p0, v = v0;
#pragma unroll
    for (int j = 0; j < kBuf; ++j) {
      const int u = s + v * G, r = p * per_pass + g;
      const bool ok = i0 + j < total && r < n && u < R.units;
      dsc[j] = unit_desc<KIND>(R, u, ok);
      buf[j] = ok ? load_unit<KIND>(R, dsc[j], ids[r], u) : make_uint4(0u, 0u, 0u, 0u);
      next_item(V, p, v);
    }
    float sums[kBuf];
    p = p0;
    v = v0;
#pragma unroll
    for (int j = 0; j < kBuf; ++j) {
      float t = 0.0f;
      auto term = [&](int f, float x) { t = naszip::fee_term_ip<IP>(x, qs[f], t); };
      unit_fields<KIND, W>(dsc[j], s + v * G, buf[j], term);
      sums[j] = t;
      next_item(V, p, v);
    }
    p = p0;
    v = v0;
#pragma unroll
    for (int j = 0; j < kBuf; ++j) {
      if (i0 + j >= total) break;  // warp-uniform
      part = __fadd_rn(part, sums[j]);
      if (v == V - 1) {  // the pass's rows are read: add each row's G sums
        for (int o = G >> 1; o > 0; o >>= 1)
          part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
        const int r = p * per_pass + g;
        if (s == 0 && r < n) dist[r] = IP ? -part : part;
        part = 0.0f;
      }
      next_item(V, p, v);
    }
  }
  __syncwarp();
}

// The first position of [0, n) whose id is >= key, n if none, by the whole
// warp: each round its 32 lanes probe 32 evenly spaced positions of the
// range left and keep the span before the first probe >= key.  The last
// lane's probe always lies at or past hi (a probe there counts as >= key),
// so some lane answers even when the answer is hi itself.
__device__ __forceinline__ int lower_bound(const int* __restrict__ sorted, int n, int key,
                                           int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo >= 32) {
    const int step = (hi - lo) / 32 + 1;
    const int at = lo + (lane + 1) * step - 1;
    const unsigned ge = __ballot_sync(0xffffffffu, at >= hi || __ldg(sorted + at) >= key);
    const int k = __ffs(ge) - 1;
    hi = min(hi, lo + (k + 1) * step - 1);
    lo += k * step;
  }
  const int at = lo + lane;
  return lo + __ffs(__ballot_sync(0xffffffffu, at >= hi || __ldg(sorted + at) >= key)) - 1;
}

template <int KIND, bool IP, int W>
__global__ void __launch_bounds__(kWarps * 32)
    descend_kernel(Rows R, const float* __restrict__ queries, long long n_q,
                   const int* __restrict__ ids, const int* __restrict__ adj,
                   const long long* __restrict__ table, int n_levels, int entry,
                   int* __restrict__ entries, int* __restrict__ moves) {
  extern __shared__ float q_smem[];  // (kWarps, dim): each warp's query
  __shared__ int nb_pos[kWarps][kMaxM];
  __shared__ int nb_id[kWarps][kMaxM];
  __shared__ float nb_d[kWarps][kMaxM];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qi = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (qi >= n_q) return;  // the whole warp leaves together
  float* qs = q_smem + warp * R.dim;
  for (int f = lane; f < R.dim; f += 32) qs[f] = __ldg(queries + qi * R.dim + f);
  int* pos = nb_pos[warp];
  int* nid = nb_id[warp];
  float* nd = nb_d[warp];
  __syncwarp();

  float d = 0.0f;
  bool scored = false;  // d is the distance of `entry`
  for (int l = n_levels - 1; l >= 0; --l) {
    const int* lids = ids + __ldg(table + 4 * l);
    const int n = static_cast<int>(__ldg(table + 4 * l + 1));
    const int* ladj = adj + __ldg(table + 4 * l + 2);
    const int m = static_cast<int>(__ldg(table + 4 * l + 3));
    // 1. the entry's position: the first id >= entry, else position 0
    int cur = min(lower_bound(lids, n, entry, lane), n - 1);
    if (__ldg(lids + cur) != entry) {
      cur = 0;
      scored = false;
    }
    if (!scored) {
      if (lane == 0) nid[0] = __ldg(lids + cur);
      __syncwarp();
      row_dists<KIND, IP, W>(R, qs, nid, 1, nd, lane);
      d = nd[0];
      scored = true;
      __syncwarp();
    }
    // 2. greedy steps
    int n_moves = 0;
    while (true) {
      for (int j = lane; j < m; j += 32) {
        const int p = __ldg(ladj + static_cast<long long>(cur) * m + j);
        pos[j] = p;
        nid[j] = __ldg(lids + p);
      }
      __syncwarp();
      row_dists<KIND, IP, W>(R, qs, nid, m, nd, lane);
      float best = lane < m ? nd[lane] : __int_as_float(0x7f800000);  // +inf
      int slot = lane < m ? lane : kMaxM;
      for (int j = lane + 32; j < m; j += 32) {
        const float v = nd[j];
        if (v < best) {
          best = v;
          slot = j;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int os = __shfl_xor_sync(0xffffffffu, slot, o);
        if (ob < best || (ob == best && os < slot)) {
          best = ob;
          slot = os;
        }
      }
      const bool better = best < d;  // warp-uniform
      if (better) {
        cur = pos[slot];
        d = best;
        ++n_moves;
      }
      __syncwarp();  // every lane has read pos and nd before the next step writes them
      if (!better) break;
    }
    // 3. the level's counter and the next level's entry
    if (lane == 0 && n_moves) atomicMax(moves + l, n_moves);
    entry = __ldg(lids + cur);
  }
  if (lane == 0) entries[qi] = entry;
}

// The group of lanes that takes a row: the least power of two >= min(units, 32).
int lanes_a_row(int units) {
  int g = 1;
  while (g < units && g < 32) g <<= 1;
  return g;
}

struct Launch {
  Rows R;
  const float* queries;
  long long n_q;
  const int* ids;
  const int* adj;
  const long long* table;
  int n_levels, entry;
  int* entries;
  int* moves;
  cudaStream_t stream;
};

template <int KIND, bool IP, int W>
int launch(const Launch& a) {
  auto kernel = descend_kernel<KIND, IP, W>;
  const size_t smem = static_cast<size_t>(kWarps) * a.R.dim * sizeof(float);
  const cudaError_t err = naszip::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.n_q + kWarps - 1) / kWarps));
  kernel<<<grid, kWarps * 32, smem, a.stream>>>(a.R, a.queries, a.n_q, a.ids, a.adj, a.table,
                                                a.n_levels, a.entry, a.entries, a.moves);
  return static_cast<int>(cudaGetLastError());
}

template <bool IP>
int launch_kind(int kind, int width, const Launch& a) {
  if (kind == kF32) return launch<kF32, IP, 0>(a);
  if (kind == kField) return launch<kField, IP, 0>(a);
  switch (width) {  // a layout of one width decodes at compile-time positions
    case 32: return launch<kBurst, IP, 32>(a);
    case 24: return launch<kBurst, IP, 24>(a);
    case 21: return launch<kBurst, IP, 21>(a);
    case 18: return launch<kBurst, IP, 18>(a);
    case 16: return launch<kBurst, IP, 16>(a);
    case 14: return launch<kBurst, IP, 14>(a);
    case 12: return launch<kBurst, IP, 12>(a);
    default: return launch<kBurst, IP, 0>(a);
  }
}

// Writes rows ids[0..n) decoded by the descent's unit reads, one warp a row,
// into out (n, dim): the test hook that holds unit_desc, load_unit and
// unit_fields to the storage's row rule.
template <int KIND>
__global__ void __launch_bounds__(kWarps * 32)
    descend_rows_kernel(Rows R, const long long* __restrict__ ids, long long n,
                        float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= n) return;
  float* orow = out + r * R.dim;
  auto put = [&](int f, float x) { orow[f] = x; };
  for (int u = lane; u < R.units; u += 32) {
    const int4 d = unit_desc<KIND>(R, u, true);
    unit_fields<KIND, 0>(d, u, load_unit<KIND>(R, d, ids[r], u), put);
  }
}

Rows make_rows(const void* p0, long long pitch0, const void* p1, long long pitch1, int in16,
               const void* desc, int units, int units0, int dim) {
  return Rows{static_cast<const uint32_t*>(p0), static_cast<const uint32_t*>(p1), pitch0, pitch1,
              in16, static_cast<const int4*>(desc), units, units0, dim, lanes_a_row(units)};
}

}  // namespace

extern "C" {

// kind 0: f32 rows p0 (pitch0 floats a row), units = ceil(dim / 4); kind 1:
// 128-bit bursts of the packed rows p0 (and, for a tier pair, p1), desc the
// (units, 4) burst table, the first units0 of them tier 0's, width the
// width of every burst (0 when they differ); kind 2: one field a unit, desc
// the (dim, 4) field table.  in16: bit t when tier t's rows take 16 B
// loads.  queries (n_q, dim) f32; ids, adj the flat level arrays, table
// their (n_levels, 4) int64 offsets (ids offset, n, adjacency offset, m),
// every m within 1..kMaxM; entries (n_q,) int32 out; moves (n_levels,)
// int32 out, zeroed here on the stream before the launch (also at
// n_q = 0, when nothing is launched).  All pointers are device pointers of
// contiguous tensors.  Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for an unknown kind).
int naszip_descend(int kind, int ip, const void* p0, long long pitch0, const void* p1,
                   long long pitch1, int in16, const void* desc, int units, int units0, int dim,
                   int width, const void* queries, long long n_q, const void* ids,
                   const void* adj, const void* table, int n_levels, int entry, void* entries,
                   void* moves, void* stream) {
  if (kind < 0 || kind > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_levels > 0) {
    const cudaError_t err = cudaMemsetAsync(moves, 0, static_cast<size_t>(n_levels) * sizeof(int),
                                            static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_q == 0) return 0;
  const Launch a{make_rows(p0, pitch0, p1, pitch1, in16, desc, units, units0, dim),
                 static_cast<const float*>(queries), n_q, static_cast<const int*>(ids),
                 static_cast<const int*>(adj), static_cast<const long long*>(table), n_levels,
                 entry, static_cast<int*>(entries), static_cast<int*>(moves),
                 static_cast<cudaStream_t>(stream)};
  return ip ? launch_kind<true>(kind, width, a) : launch_kind<false>(kind, width, a);
}

// The rows ids (n,) int64 decoded by the descent's unit reads into out
// (n, dim) f32; the storage arguments as naszip_descend's.
int naszip_descend_rows(int kind, const void* p0, long long pitch0, const void* p1,
                        long long pitch1, int in16, const void* desc, int units, int units0,
                        int dim, const void* ids, long long n, void* out, void* stream) {
  if (kind < 0 || kind > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Rows R = make_rows(p0, pitch0, p1, pitch1, in16, desc, units, units0, dim);
  const dim3 grid(static_cast<unsigned>((n + kWarps - 1) / kWarps));
  const auto* i = static_cast<const long long*>(ids);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (kind == kF32) descend_rows_kernel<kF32><<<grid, kWarps * 32, 0, s>>>(R, i, n, o);
  else if (kind == kBurst) descend_rows_kernel<kBurst><<<grid, kWarps * 32, 0, s>>>(R, i, n, o);
  else descend_rows_kernel<kField><<<grid, kWarps * 32, 0, s>>>(R, i, n, o);
  return static_cast<int>(cudaGetLastError());
}

const char* naszip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
