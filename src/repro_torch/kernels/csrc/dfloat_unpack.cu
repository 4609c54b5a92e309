// Dfloat bitstream decode for Hopper (sm_90a): packed rows -> f32 features,
// bit-exact vs dfloat.unpack_db.
//
// Replaces repro/kernels/dfloat_unpack.py :: dfloat_unpack_pallas (_kernel).
//
// The TPU kernel unrolls the layout's static shifts over a (TILE_C, W) block
// in VMEM: every Dfloat segment starts a 128-bit burst, and a burst of a
// width-w segment holds floor(128 / w) fields at bit l * w.  Here one thread
// decodes one 16 B burst of a row: it reads the burst with one 16 B load
// (consecutive threads take consecutive bursts, so a warp reads 512
// contiguous bytes), picks its fields at the compile-time positions of the
// burst's width (a template over the width palette) and widens each with its
// format's constants (naszip::widen_field), from a per-burst descriptor
// (first output feature, field count | width << 8, mul, ebias).  A block
// decodes its rows into a shared tile and then writes the tile with
// consecutive threads on consecutive 16 B of each output row, so every store
// instruction fills whole sectors; row arithmetic divides once per thread,
// not per element.
//
// Rows may be gathered by id (ids[r] names the source row, so the search's
// upper-level decode reads the rows in place instead of copying them first)
// and written at a column offset of a wider output (the tiered decode writes
// both tiers into one matrix).  An id that names no row decodes as zeros,
// reading nothing.  A layout whose bursts are not 128 bits (or whose widths
// lie outside the palette) takes the per-field path of the same source: one
// thread per (row, feature) from a staged per-feature table, exact too.
//
// Bound on this card: bytes.  The call must read the packed rows (and ids)
// and write 4 B per feature; the decode is a few integer operations a field.
#include "naszip_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;  // resident blocks an SM holds at full occupancy
constexpr int kMinBlocks = 8;                  // the burst path at full occupancy: 32 registers

// Store the n (<= N) values v to dst (shared memory): float4 stores where
// dst is 16 B aligned, floats otherwise.  N and every index are
// compile-time, so v stays in registers.
template <int N>
__device__ __forceinline__ void store_run(const float (&v)[N], int n, float* dst) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int l = 0; l < N; l += 4) {
      if (l + 4 <= N && l + 4 <= n) {
        reinterpret_cast<float4*>(dst + l)[0] = make_float4(v[l], v[l + 1], v[l + 2], v[l + 3]);
      } else {
#pragma unroll
        for (int k = l; k < l + 4 && k < N; ++k)
          if (k < n) dst[k] = v[k];
      }
    }
  } else {
#pragma unroll
    for (int l = 0; l < N; ++l)
      if (l < n) dst[l] = v[l];
  }
}

// The n fields of a width-W burst staged in w[0..3] (w[4] zero), widened and
// stored from dst on.
template <int W>
__device__ __forceinline__ void decode_burst(const uint32_t (&w)[5], int n, uint32_t mul,
                                             uint32_t ebias, float* dst) {
  constexpr int PER = 128 / W;
  float v[PER];
#pragma unroll
  for (int l = 0; l < PER; ++l) v[l] = naszip::static_value<W, 1>(w, 0, l, mul, ebias);
  store_run<PER>(v, n, dst);
}

// Row r's source row: ids[r] when gathering, else r; -1 when the id names
// no row.
__device__ __forceinline__ long long source_row(const long long* ids, long long r,
                                                long long n_src) {
  const long long s = ids == nullptr ? r : ids[r];
  return s >= 0 && s < n_src ? s : -1;
}

// The burst path.  A block decodes `rows` = kThreads / lanes consecutive
// output rows (lanes = min(bursts, kThreads) threads a row, each taking
// consecutive bursts) into a shared (rows, dim) tile, then writes the tile
// out with consecutive threads on consecutive 16 B of each output row
// (OUT4: 16 B aligned rows and column offset, dim % 4 == 0; else 4 B), so a
// warp's stores cover whole sectors.  A thread's own fields are 32 B apart
// from its neighbours' (a 16-bit burst holds eight): stored from registers
// to device memory directly, every store instruction would half-fill the
// sectors it touches.  IN16: 16 B burst loads (16 B aligned base and
// pitch), else the same four words 4 B at a time.  The descriptors (256 B
// on the main path) are read through the read-only cache, staged nowhere.
template <bool IN16, bool OUT4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dfloat_unpack_kernel(const uint32_t* __restrict__ packed, long long pitch,
                         long long n_src, const long long* __restrict__ ids, long long n_rows,
                         int bursts, int dim, const int4* __restrict__ desc,
                         float* __restrict__ out, long long ld, int col) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  const int lanes = min(bursts, kThreads);
  const int rows = kThreads / lanes;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const int g = threadIdx.x / lanes;
  const long long r = r0 + g;
  if (g < rows && r < n_rows) {
    const long long src = source_row(ids, r, n_src);
    const uint32_t* row = packed + (src < 0 ? 0 : src) * pitch;
    float* trow = tile + g * dim;
    for (int b = threadIdx.x - g * lanes; b < bursts; b += lanes) {
      const int4 d = __ldg(desc + b);
      const int n = d.y & 0xFF;
      if (src < 0) {
        for (int l = 0; l < n; ++l) trow[d.x + l] = 0.0f;
        continue;
      }
      uint32_t w[5];
      if constexpr (IN16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + b);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = __ldg(row + 4 * b + i);
      }
      w[4] = 0u;
      const uint32_t mul = static_cast<uint32_t>(d.z), ebias = static_cast<uint32_t>(d.w);
      float* dst = trow + d.x;
      switch (d.y >> 8) {  // the host sends only palette widths down this path
        case 32: decode_burst<32>(w, n, mul, ebias, dst); break;
        case 24: decode_burst<24>(w, n, mul, ebias, dst); break;
        case 21: decode_burst<21>(w, n, mul, ebias, dst); break;
        case 18: decode_burst<18>(w, n, mul, ebias, dst); break;
        case 16: decode_burst<16>(w, n, mul, ebias, dst); break;
        case 14: decode_burst<14>(w, n, mul, ebias, dst); break;
        case 12: decode_burst<12>(w, n, mul, ebias, dst); break;
        default: break;
      }
    }
  }
  __syncthreads();
  // write the tile: `per_row` units (16 B or 4 B) a row, consecutive threads
  // on consecutive units
  const int n_tile = static_cast<int>(min(static_cast<long long>(rows), n_rows - r0));
  constexpr int U = OUT4 ? 4 : 1;
  const int per_row = dim / U;
  const int c_lanes = min(per_row, kThreads);
  const int c_rows = kThreads / c_lanes;
  const int cg = threadIdx.x / c_lanes;
  if (cg >= c_rows) return;
  for (int t = cg; t < n_tile; t += c_rows) {
    float* orow = out + (r0 + t) * ld + col;
    for (int i = threadIdx.x - cg * c_lanes; i < per_row; i += c_lanes) {
      if constexpr (OUT4) {
        reinterpret_cast<float4*>(orow)[i] = tile4[t * per_row + i];
      } else {
        orow[i] = tile[t * dim + i];
      }
    }
  }
}

// The per-field path: the same walk over (row, feature), one field a thread,
// from a per-feature table (word index, bit offset | width << 8, mul, ebias).
__global__ void __launch_bounds__(kThreads)
    dfloat_unpack_fields_kernel(const uint32_t* __restrict__ packed, long long pitch,
                                long long n_src, const long long* __restrict__ ids,
                                long long n_rows, int dim, const int4* __restrict__ fields,
                                float* __restrict__ out, long long ld, int col) {
  extern __shared__ int4 tab[];
  for (int i = threadIdx.x; i < dim; i += kThreads) tab[i] = fields[i];
  __syncthreads();
  const int lanes = min(dim, kThreads);
  const int rows_per_step = kThreads / lanes;
  const int group = threadIdx.x / lanes;
  if (group >= rows_per_step) return;
  const int f_first = threadIdx.x - group * lanes;
  const long long step = static_cast<long long>(gridDim.x) * rows_per_step;
  for (long long r = static_cast<long long>(blockIdx.x) * rows_per_step + group; r < n_rows;
       r += step) {
    const long long src = source_row(ids, r, n_src);
    const uint32_t* row = packed + (src < 0 ? 0 : src) * pitch;
    float* orow = out + r * ld + col;
    for (int f = f_first; f < dim; f += lanes) {
      if (src < 0) {
        orow[f] = 0.0f;
        continue;
      }
      const int4 t = tab[f];
      const int ofs = t.y & 0xFF, width = t.y >> 8;
      uint32_t v = __ldg(row + t.x) >> ofs;
      if (ofs + width > 32) v |= __ldg(row + t.x + 1) << (32 - ofs);  // ofs > 0 here
      const uint32_t mask = width == 32 ? 0xffffffffu : (1u << width) - 1u;
      orow[f] = naszip::widen_field(v & mask, mask >> 1, static_cast<uint32_t>(t.z),
                                    static_cast<uint32_t>(t.w));
    }
  }
}

// Size the grid of a launch of n_blocks blocks (with `cap`, at most
// kBlocksPerSm a multiprocessor: the per-field path walks its rows in a
// loop) and allow its dynamic shared memory.
template <class Kernel>
int launch(Kernel kernel, long long n_blocks, bool cap, size_t smem, dim3* grid) {
  cudaError_t err = naszip::allow_smem(kernel, smem);
  if (err == cudaSuccess && cap) {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long most = static_cast<long long>(sms) * kBlocksPerSm;
    if (n_blocks > most) n_blocks = most;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = dim3(static_cast<unsigned>(n_blocks));
  return 0;
}

template <bool IN16, bool OUT4>
int launch_bursts(const uint32_t* p, long long pitch, long long n_src, const long long* ids,
                  long long n_rows, int bursts, int dim, const int4* desc, float* out,
                  long long ld, int col, cudaStream_t stream) {
  const int rows = kThreads / (bursts < kThreads ? bursts : kThreads);
  const size_t smem = static_cast<size_t>(rows) * dim * sizeof(float);
  auto kernel = dfloat_unpack_kernel<IN16, OUT4>;
  dim3 grid;
  const int code = launch(kernel, (n_rows + rows - 1) / rows, false, smem, &grid);
  if (code) return code;
  kernel<<<grid, kThreads, smem, stream>>>(p, pitch, n_src, ids, n_rows, bursts, dim, desc, out,
                                           ld, col);
  return 0;
}

}  // namespace

extern "C" {

// packed holds n_src rows at a pitch of `pitch` words; ids (int64, n_rows of
// them) or null; table is the (units, 4) int32 burst descriptor table
// (by_burst) or per-feature table of a layout of dim features; out has
// n_rows rows of ld floats, this layout's features written from column col.
// All pointers are device pointers of contiguous tensors.  Returns the
// cudaError_t of the launch (0 on success).
int naszip_dfloat_unpack(const void* packed, long long pitch, long long n_src, const void* ids,
                         long long n_rows, int by_burst, int units, int dim, const void* table,
                         void* out, long long ld, int col, void* stream) {
  if (n_rows == 0 || units == 0) return 0;
  const auto* p = static_cast<const uint32_t*>(packed);
  const auto* i = static_cast<const long long*>(ids);
  const auto* t = static_cast<const int4*>(table);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  int code;
  if (by_burst) {
    const bool in16 = naszip::burst_loads(packed, pitch, 4);
    const bool out4 = reinterpret_cast<uintptr_t>(o + col) % 16 == 0 && ld % 4 == 0 &&
                      dim % 4 == 0;
    auto go = [&](auto fn) { return fn(p, pitch, n_src, i, n_rows, units, dim, t, o, ld, col, s); };
    if (in16 && out4) code = go(launch_bursts<true, true>);
    else if (in16) code = go(launch_bursts<true, false>);
    else if (out4) code = go(launch_bursts<false, true>);
    else code = go(launch_bursts<false, false>);
  } else {
    const size_t smem = static_cast<size_t>(units) * sizeof(int4);
    const int lanes = units < kThreads ? units : kThreads;
    const int rows = kThreads / lanes;
    dim3 grid;
    code = launch(dfloat_unpack_fields_kernel, (n_rows + rows - 1) / rows, true, smem, &grid);
    if (code == 0)
      dfloat_unpack_fields_kernel<<<grid, kThreads, smem, s>>>(p, pitch, n_src, i, n_rows, units,
                                                               t, o, ld, col);
  }
  if (code) return code;
  return static_cast<int>(cudaGetLastError());
}

const char* naszip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
