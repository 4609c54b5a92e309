// The beam search hop's frontier step for Hopper (sm_90a): the neighbour
// gather, the visited test, the first-occurrence dedup, the fresh-first
// compaction and the visited update of one hop, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA
// (repro/core/search.py::_hop_body), and the port ran it as ~20 torch ops,
// among them a (Q, E*M, E*M) pairwise compare whose bool temporaries took
// most of a hop's device time.  The plain version is
// kernels/ref.py::frontier_ref.
//
// One warp a query, kWarps queries a block.  For each of the E*M frontier
// slots (pop p = slot / M, neighbour slot / M's remainder) the warp
//   1. gathers the id adj[max(nodes[p], 0)][slot % M] (the padded row 0 for
//      an unselected pop, as the plain version's clamped gather) into
//      shared memory, and keys the slot by its id if it is a candidate
//      (id >= 0, pop selected, visited bit clear) or -1 if not;
//   2. marks the first candidate of each id in slot order: a slot is fresh
//      iff no earlier slot has its key (every slot of one id shares its
//      visited bit, so the first valid occurrence is also the first
//      candidate, which is first_occurrence_mask's output); one
//      __ballot_sync a chunk of 32 slots keeps the fresh bits;
//   3. writes the stable fresh-first partition cut to `width`: fresh slots
//      in slot order, then the others in slot order, each slot's place from
//      __popc prefix counts of the ballots (E == 1 keeps slot order); and
//   4. sets each kept fresh id's bit in the query's visited row with
//      atomicOr.  Every visited read of the query happens in step 1, before
//      the __syncwarp that ends it, so no write can be seen by a read; kept
//      fresh ids are unique and unset, so the OR equals the plain version's
//      scatter_add_.
//
// Bound on this card: bytes, and latency on the two dependent loads of step
// 1 (the id, then its visited word).  A hop at Q = 10,000, E*M = 80 reads
// 80 ids and 80 random visited words a query and writes 4 outputs of
// `width` lanes: ~35 MB of sectors, ~10 us at 3.35 TB/s.  The dedup is
// E*M^2/2 shared-memory compares a query, broadcast across the warp.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;          // queries a block, one warp each
constexpr int kMaxSlots = 1024;    // E*M; shared memory 8 B a slot a warp

__global__ void __launch_bounds__(kWarps * 32)
    frontier_kernel(const int* __restrict__ nodes, const uint8_t* __restrict__ sel,
                    const int* __restrict__ adj, unsigned* visited, long long n_words,
                    long long n_q, int e, int m, int width, int* __restrict__ nbrs,
                    int* __restrict__ safe, uint8_t* __restrict__ fresh,
                    int* __restrict__ src) {
  extern __shared__ int smem[];
  const int slots = e * m;
  const int chunks = (slots + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (q >= n_q) return;  // the whole warp leaves together
  int* raw = smem + warp * (2 * slots + chunks);
  int* key = raw + slots;
  unsigned* fmask = reinterpret_cast<unsigned*>(key + slots);
  const int* qnodes = nodes + q * e;
  const uint8_t* qsel = sel + q * e;
  unsigned* vrow = visited + q * n_words;

  // 1. gather and visited test
  for (int j = lane; j < slots; j += 32) {
    const int p = j / m;
    const int id = adj[static_cast<long long>(max(qnodes[p], 0)) * m + (j - p * m)];
    raw[j] = id;
    bool cand = id >= 0 && qsel[p] != 0;
    if (cand) cand = ((vrow[id >> 5] >> (id & 31)) & 1u) == 0;
    key[j] = cand ? id : -1;
  }
  __syncwarp();

  // 2. first candidate of each id
  int n_fresh = 0;
  for (int c = 0; c < chunks; ++c) {
    const int j = c * 32 + lane;
    const int k = j < slots ? key[j] : -1;
    bool first = k >= 0;
    for (int i = 0; first && i < j; ++i) first = key[i] != k;
    const unsigned b = __ballot_sync(0xffffffffu, first);
    if (lane == 0) fmask[c] = b;
    n_fresh += __popc(b);
  }
  __syncwarp();

  // 3. fresh-first compaction and 4. visited update
  const long long row = q * width;
  int before = 0;  // fresh slots of the earlier chunks
  for (int c = 0; c < chunks; ++c) {
    const int j = c * 32 + lane;
    const unsigned b = fmask[c];
    const bool f = (b >> lane) & 1u;
    const int f_lt = before + __popc(b & ((1u << lane) - 1u));
    before += __popc(b);
    if (j >= slots) continue;
    const int pos = e == 1 ? j : (f ? f_lt : n_fresh + (j - f_lt));
    if (pos >= width) continue;
    const int id = raw[j];
    nbrs[row + pos] = id;
    safe[row + pos] = max(id, 0);
    fresh[row + pos] = f;
    src[row + pos] = j / m;
    if (f) atomicOr(vrow + (id >> 5), 1u << (id & 31));
  }
}

}  // namespace

extern "C" {

// nodes (n_q, e) int32, sel (n_q, e) bool, adj (rows, m) int32, visited
// (n_q, n_words) int32 words (updated in place); nbrs, safe, src (n_q, width)
// int32 and fresh (n_q, width) bool are written.  All pointers are device
// pointers of contiguous tensors.  Returns the cudaError_t of the launch (0
// on success; cudaErrorInvalidValue for e * m outside 1..kMaxSlots or a
// width outside 1..e * m, or other than m for e == 1).
int naszip_frontier(const void* nodes, const void* sel, const void* adj, void* visited,
                    long long n_words, long long n_q, int e, int m, int width, void* nbrs,
                    void* safe, void* fresh, void* src, void* stream) {
  const int slots = e * m;
  if (e < 1 || m < 1 || slots > kMaxSlots || width < 1 || width > slots ||
      (e == 1 && width != m))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_q == 0) return 0;
  const size_t smem = static_cast<size_t>(kWarps) * (2 * slots + (slots + 31) / 32) * 4;
  const dim3 grid(static_cast<unsigned>((n_q + kWarps - 1) / kWarps));
  frontier_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nodes), static_cast<const uint8_t*>(sel),
      static_cast<const int*>(adj), static_cast<unsigned*>(visited), n_words, n_q, e, m, width,
      static_cast<int*>(nbrs), static_cast<int*>(safe), static_cast<uint8_t*>(fresh),
      static_cast<int*>(src));
  return static_cast<int>(cudaGetLastError());
}

const char* naszip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
