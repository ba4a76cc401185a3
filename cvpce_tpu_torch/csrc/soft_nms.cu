// Sequential Soft-NMS re-scoring (Bodla et al. 2017): an overlap bitmask
// on all SMs, then one chain of rounds per image that touches only the
// winner's overlaps.
//
// Replaces the TPU kernel cvpce_tpu/ops/nms_pallas.py:_soft_nms_kernel
// (driven by soft_nms_scores_pallas), which sweeps all N entries in each
// round on the TPU's wide vector unit. The wrapper is
// cvpce_tpu_torch/ops/nms.py:soft_nms_scores_fused; its plain version
// soft_nms_scores computes the same rounds with torch ops.
//
// Semantics, as in _soft_nms_kernel: invalid entries start processed.
// Each round picks the unprocessed entry of highest current score (the
// lowest index on ties), marks it processed, and multiplies every other
// unprocessed score by exp(-iou^2 / sigma) (gaussian) or, where
// iou > thresh, by 1 - iou (linear). It stops when no unprocessed entry
// above -inf is left. The output is the current score of each valid
// entry and 0 at invalid ones. The IoU is
// inter / max((area_w + area_j) - inter, 1e-12) with the plain version's
// expression order; the file is built with -fmad=false, and expf is the
// CUDA math library's, so each decay rounds as torch's does and the
// scores are bit-equal to the plain version's.
//
// What bounds it: the latency of the dependent rounds, one per valid
// candidate (4693 on a serve photo, up to 5120), not operations or
// bytes: the arithmetic is ~N^2 / 2 IoUs, microseconds of the card's,
// and the input is 100 KB an image. A round is a chain of dependent
// steps (a shared load, a shuffle, a warp reduction, a named barrier, a
// decay's divisions and expf), so its budget is a few thousand cycles;
// the time divided by the rounds is chip_smoke.py's us_per_round.
//
// Two facts make the rounds short and exact. A pair's decay does not
// depend on which box of the pair wins (inter uses symmetric min/max and
// f32 addition commutes), so it can be tested once, in parallel, before
// the chain. And a score whose decay is exactly 1 does not change, so
// skipping it changes no bit: a round touches only the winner's overlaps
// and the groups whose best entry they were.
//   1. soft_mask_kernel, all SMs: a grid over (column word, row block,
//      image) writes mask[b][i][w], a 64-bit word whose bit t says that
//      valid box i and valid box 64w + t != i may decay each other: they
//      intersect and, under the linear rule, their IoU, by the chain's own
//      expression, is above thresh. Elsewhere the decay is exactly 1. A set
//      bit whose gaussian decay still rounds to 1 is multiplied in by the
//      chain and changes no bit. Full rows, both triangles: the order of
//      the rounds follows the scores, not the indices. Bits of invalid
//      boxes and of the ragged edge past n stay clear.
//   2. soft_chain_kernel, one 512-thread block per image: boxes, areas
//      and current scores in shared memory (28 B an entry, 144 KB at
//      N = 5120); all threads load them and write the output, and
//      between those two __syncthreads() 12 chain warps run the rounds
//      with one named barrier each. Lane l of chain warp k owns the
//      32-entry group k + 12 l: its unprocessed bits and its
//      best entry live in the lane's registers, and only warp k touches
//      the group's scores. A round:
//      - each warp reads the warps' bests of the last round and reduces
//        them to the same winner (64-bit keys: score, then lowest index);
//      - each lane reads its 32-bit half of the winner's mask row (L2-
//        resident), ANDed with its unprocessed bits. The runner-up (the
//        best of the other warps' bests) most often wins the next round,
//        so its half is loaded a round ahead;
//      - the warp's neighbours go into its list at a prefix of the lanes'
//        counts, and the lanes decay them, two each a pass, with the
//        plain version's expressions;
//      - a group whose best won or was decayed is rescanned by the whole
//        warp (a lane an entry); decays only lower scores, so no other
//        group's best can change. The warp's best goes to the other of
//        two buffers, so no warp writes what another may still read.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef unsigned long long u64;

constexpr int kBits = 64;          // boxes per mask word and row block
constexpr int kGroup = 32;         // entries per argmax group
constexpr int kThreads = 512;      // chain block: all load and store
constexpr int kChainWarps = 12;    // of which these run the rounds
constexpr int kMaxN = 8192;        // most entries an image may have
// a chain lane owns at most one group
static_assert(kChainWarps * 32 * kGroup >= kMaxN, "too few chain warps");
constexpr unsigned kFull = 0xffffffffu;
// the high half of the key of -inf: a round whose best key is at or
// below it (an empty group's key is 0) has no live entry left
constexpr unsigned kNegInfKey = 0x007fffffu;

// kernels this file has launched, read by soft_nms_kernels_launched
unsigned long long kernels_launched = 0;

__device__ __forceinline__ float area_of(float4 b) {
  return (b.z - b.x) * (b.w - b.y);
}

__device__ __forceinline__ float inter_of(float4 r, float4 c) {
  const float ix1 = fmaxf(r.x, c.x);
  const float iy1 = fmaxf(r.y, c.y);
  const float ix2 = fminf(r.z, c.z);
  const float iy2 = fminf(r.w, c.w);
  return fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
}

// the decay rule. When sigma is a power of two, x / sigma and
// x * (1 / sigma) round the same exact value, so the division becomes a
// multiply.
struct Rule {
  float sigma, inv_sigma, thresh;
  int linear, pow2;
};

// the factor winner r (area ra) applies to box c (area ca) given their
// intersection, with the plain version's expressions
__device__ __forceinline__ float decay_from(float inter, float ra, float ca,
                                            const Rule& rule) {
  const float uni = (ra + ca) - inter;
  const float iou = inter / fmaxf(uni, 1e-12f);
  if (rule.linear) return iou > rule.thresh ? 1.0f - iou : 1.0f;
  const float x = -(iou * iou);
  return expf(rule.pow2 ? x * rule.inv_sigma : x / rule.sigma);
}

// whether box c's decay from box r (areas ra, ca) may differ from exactly
// 1: they intersect (disjoint boxes have IoU +0: exp(-0) and 1 - 0 are
// 1), and, under the linear rule, their IoU is above thresh, with
// decay_from's expression
__device__ __forceinline__ bool may_decay(float4 r, float ra, float4 c,
                                          float ca, const Rule& rule) {
  const float inter = inter_of(r, c);
  if (!rule.linear || inter == 0.0f) return inter != 0.0f;
  const float iou = inter / fmaxf((ra + ca) - inter, 1e-12f);
  return iou > rule.thresh;
}

// A key is 64 bits that order by score, then by the lower index: the
// score's order bits (order_of; -0 ranks as +0, as the plain version's
// comparisons do) above the complement of the index. 0 is below every
// key.
__device__ __forceinline__ int index_of(u64 key) {
  return static_cast<int>(kFull - static_cast<unsigned>(key));
}

__host__ __device__ inline int mask_words(int n) {
  return (n + kBits - 1) / kBits;
}

__host__ __device__ inline int groups(int n) {
  return (n + kGroup - 1) / kGroup;
}

__global__ void __launch_bounds__(kBits)
soft_mask_kernel(const float4* __restrict__ boxes,
                 const uint8_t* __restrict__ valid, int n, Rule rule,
                 u64* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const int nw = mask_words(n);
  __shared__ float4 cbox[kBits];
  __shared__ float carea[kBits];
  __shared__ unsigned cvalid[2];
  const size_t base = static_cast<size_t>(b) * n;
  const int t = threadIdx.x;
  const int j = cb * kBits + t;
  bool vj = false;
  if (j < n) {
    const float4 v = boxes[base + j];
    cbox[t] = v;
    carea[t] = area_of(v);
    vj = valid[base + j] != 0;
  }
  const unsigned vb = __ballot_sync(kFull, vj);
  if (t % 32 == 0) cvalid[t / 32] = vb;
  __syncthreads();
  const int i = rb * kBits + t;
  if (i >= n) return;
  u64 bits = 0;
  if (valid[base + i]) {
    u64 cols = (static_cast<u64>(cvalid[1]) << 32) | cvalid[0];
    if (cb == rb) cols &= ~(1ull << t);
    const float4 r = boxes[base + i];
    const float ra = area_of(r);
    // cols is the same in every lane but the diagonal's: no divergence
#pragma unroll 8
    for (int c = 0; c < kBits; ++c)
      if (((cols >> c) & 1ull) &&
          may_decay(r, ra, cbox[c], carea[c], rule))
        bits |= 1ull << c;
  }
  mask[(base + i) * nw + cb] = bits;
}

// room in a chain warp's neighbour list: every entry of its groups
__host__ __device__ inline int list_len(int n) {
  return (groups(n) + kChainWarps - 1) / kChainWarps * kGroup;
}

// the chain's shared memory: boxes, areas, scores (padded to whole
// groups, so a group's scan never leaves them), the valid bits of each
// group, each chain warp's best key in two buffers and its neighbour list
size_t chain_smem(int n) {
  return static_cast<size_t>(n) * (16 + 4) +
         static_cast<size_t>(groups(n)) * (kGroup * 4 + 4) +
         2 * kChainWarps * 8 +
         static_cast<size_t>(kChainWarps) * list_len(n) * 4;
}

// the order bits of a score: the high half of its key
__device__ __forceinline__ unsigned order_of(float s) {
  unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the largest key held by any lane of the warp
__device__ __forceinline__ u64 warp_max_key(u64 k) {
  const unsigned hi = __reduce_max_sync(kFull, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_max_sync(
      kFull, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k)
                                                  : 0u);
  return (static_cast<u64>(hi) << 32) | lo;
}

// the best entry of group g, by the whole warp (lane e reads entry e):
// the highest score among the unprocessed entries `bits`, the lowest
// index on ties. Returns its key, 0 when no entry is above -inf; `bs`
// gets its score in every lane.
__device__ __forceinline__ u64 group_best(const float* scur, int g,
                                          unsigned bits, int lane,
                                          float& bs) {
  const float x = scur[g * kGroup + lane];
  const unsigned o = (bits >> lane) & 1u ? order_of(x) : 0u;
  const unsigned top = __reduce_max_sync(kFull, o);
  const int e = __ffs(__ballot_sync(kFull, o == top)) - 1;
  bs = __shfl_sync(kFull, x, e);
  return top > kNegInfKey
             ? (static_cast<u64>(top) << 32) |
                   (kFull - static_cast<unsigned>(g * kGroup + e))
             : 0ull;
}

__device__ __forceinline__ void chain_barrier(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

__global__ void __launch_bounds__(kThreads)
soft_chain_kernel(const float4* __restrict__ boxes,
                  const float* __restrict__ scores,
                  const uint8_t* __restrict__ valid,
                  const u64* __restrict__ mask, int n, Rule rule,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = mask_words(n), ng = groups(n);
  float4* sbox = reinterpret_cast<float4*>(smem);
  u64* wkey = reinterpret_cast<u64*>(sbox + n);  // [2][kChainWarps]
  float* sarea = reinterpret_cast<float*>(wkey + 2 * kChainWarps);
  float* scur = sarea + n;                        // [ng * kGroup]
  unsigned* vbits = reinterpret_cast<unsigned*>(scur + ng * kGroup);
  int* nbr = reinterpret_cast<int*>(vbits + ng);  // [kChainWarps][list_len]

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t base = static_cast<size_t>(b) * n;
  for (int j = tid; j < n; j += kThreads) {
    const float4 v = boxes[base + j];
    sbox[j] = v;
    sarea[j] = area_of(v);
    scur[j] = scores[base + j];
  }
  for (int g = warp; g < ng; g += kThreads / 32) {
    const int j = g * kGroup + lane;
    const unsigned vb = __ballot_sync(kFull, j < n && valid[base + j]);
    if (lane == 0) vbits[g] = vb;
  }
  __syncthreads();

  if (warp < kChainWarps) {
    // lane `lane` of chain warp `warp` owns group g: its unprocessed
    // bits and its best entry's key and score live in the lane's
    // registers, and only this warp touches the group's scores
    const int g = warp + kChainWarps * lane;
    const bool owns = g < ng;
    int* list = nbr + warp * list_len(n);
    unsigned live = owns ? vbits[g] : 0u;
    u64 key = 0;
    float bs = 0.0f;
    for (int q = 0; q < 32 && warp + kChainWarps * q < ng; ++q) {
      const int gq = warp + kChainWarps * q;
      float s;
      const u64 k = group_best(scur, gq, __shfl_sync(kFull, live, q), lane, s);
      if (lane == q) {
        key = k;
        bs = s;
      }
    }
    const u64 first = warp_max_key(key);
    if (lane == 0) wkey[warp] = first;
    chain_barrier(32 * kChainWarps);

    // each winner's mask row, read as 32-bit halves: half g is group g
    const unsigned* rows = reinterpret_cast<const unsigned*>(mask + base * nw);
    const size_t row_len = 2 * static_cast<size_t>(nw);
    int guess = -1;    // the winner whose half the lane prefetched
    unsigned ahead = 0;
    for (int round = 0;; ++round) {
      // every warp finds the same winner, the best of the warps' bests;
      // this round's bests go to the other buffer, so no warp writes
      // what another may still read
      const u64* key_now = wkey + (round & 1) * kChainWarps;
      u64* key_next = wkey + ((round & 1) ^ 1) * kChainWarps;
      const u64 warp_best = lane < kChainWarps ? key_now[lane] : 0ull;
      const u64 best = warp_max_key(warp_best);
      if (static_cast<unsigned>(best >> 32) <= kNegInfKey) break;
      const int w = index_of(best);

      // the winner's neighbours in this lane's group (its row has no bit
      // of its own); its half was loaded a round ahead if it was the
      // runner-up then
      unsigned row_half = ahead;
      if (w != guess)
        row_half = owns ? rows[static_cast<size_t>(w) * row_len + g] : 0u;
      // this round's runner-up, the best of the other warps' bests, most
      // often wins the next round: its half is loaded after the decays
      const u64 next = warp_max_key(warp_best == best ? 0ull : warp_best);
      const unsigned mine = row_half & live;
      if (g == w / kGroup) live &= ~(1u << (w % kGroup));
      const int cnt = __popc(mine);
      int excl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int o = __shfl_up_sync(kFull, excl, off);
        if (lane >= off) excl += o;
      }
      const int total = __shfl_sync(kFull, excl, 31);
      excl -= cnt;

      // the neighbours into the warp's list, each lane its own at its
      // prefix; then the decays, 64 a pass, two a lane side by side.
      // Neighbours overlap the winner, so the decays run branch-free (a
      // lane without a second neighbour decays the winner's own box and
      // drops the result).
      if (total > 32) {
        // many neighbours: a pass over all 32 bits, no bit search
#pragma unroll
        for (int t = 0, p = excl; t < kGroup; ++t) {
          const unsigned on = (mine >> t) & 1u;
          if (on) list[p] = g * kGroup + t;
          p += on;
        }
      } else {
        for (unsigned m = mine; m; m &= m - 1)
          list[excl++] = g * kGroup + __ffs(m) - 1;
      }
      __syncwarp();
      const float4 r = sbox[w];
      const float ra = sarea[w];
      for (int k = lane; k < total; k += 64) {
        const int j0 = list[k];
        const int j1 = k + 32 < total ? list[k + 32] : w;
        const float s0 = scur[j0], s1 = scur[j1];
        const float d0 = decay_from(inter_of(r, sbox[j0]), ra, sarea[j0], rule);
        const float d1 = decay_from(inter_of(r, sbox[j1]), ra, sarea[j1], rule);
        scur[j0] = s0 * d0;
        if (j1 != w) scur[j1] = s1 * d1;
      }
      guess = next ? index_of(next) : -1;
      if (owns && next) ahead = rows[static_cast<size_t>(guess) * row_len + g];
      __syncwarp();

      // a group's best changes only if it won or was decayed: those
      // groups are rescanned by the whole warp
      unsigned dirty = __ballot_sync(
          kFull, key && (index_of(key) == w || scur[index_of(key)] != bs));
      while (dirty) {
        // two at a time, so that their latencies overlap
        const int q0 = __ffs(dirty) - 1;
        dirty &= dirty - 1;
        const int q1 = dirty ? __ffs(dirty) - 1 : q0;
        dirty &= dirty - 1;
        float s0, s1;
        const u64 k0 = group_best(scur, warp + kChainWarps * q0,
                                  __shfl_sync(kFull, live, q0), lane, s0);
        const u64 k1 = group_best(scur, warp + kChainWarps * q1,
                                  __shfl_sync(kFull, live, q1), lane, s1);
        if (lane == q0) {
          key = k0;
          bs = s0;
        }
        if (lane == q1) {
          key = k1;
          bs = s1;
        }
      }
      const u64 mine_best = warp_max_key(key);
      if (lane == 0) key_next[warp] = mine_best;
      chain_barrier(32 * kChainWarps);
    }
  }
  __syncthreads();

  for (int j = tid; j < n; j += kThreads)
    out[base + j] = valid[base + j] ? scur[j] : 0.0f;
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

}  // namespace

extern "C" {

// Largest N: one image's chain state fits one block's shared memory
// (8192 on an H100).
int soft_nms_max_n() {
  static const int max_n = [] {
    const size_t optin = static_cast<size_t>(smem_optin());
    int n = kMaxN;
    while (n > 0 && chain_smem(n) > optin) n -= 32;
    return n;
  }();
  return max_n;
}

// Words per row of the mask scratch: the caller allocates
// batch * n * soft_nms_mask_words(n) 64-bit words.
int soft_nms_mask_words(int n) { return mask_words(n); }

unsigned long long soft_nms_kernels_launched() { return kernels_launched; }

// boxes: (batch, n, 4) f32; scores: (batch, n) f32; valid: (batch, n)
// uint8; mask: scratch, see soft_nms_mask_words; out: (batch, n) f32.
// All contiguous, in input order (no sort). Two launches.
int soft_nms_launch(const void* boxes, const void* scores, const void* valid,
                    void* mask, void* out, int batch, int n, float sigma,
                    float thresh, int linear, void* stream) {
  if (n <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
  if (n > soft_nms_max_n()) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = chain_smem(n);
  unsigned sb;
  memcpy(&sb, &sigma, sizeof sb);
  const unsigned exp_bits = (sb >> 23) & 0xff;
  const Rule rule = {sigma, 1.0f / sigma, thresh, linear,
                     (sb & 0x807fffffu) == 0 && exp_bits >= 1 &&
                         exp_bits <= 253};
  cudaError_t err = cudaFuncSetAttribute(
      soft_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = mask_words(n);
  soft_mask_kernel<<<dim3(nw, nw, batch), kBits, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      n, rule, static_cast<u64*>(mask));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++kernels_launched;
  soft_chain_kernel<<<batch, kThreads, smem, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<const u64*>(mask), n,
      rule, static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++kernels_launched;
  return static_cast<int>(cudaSuccess);
}

const char* soft_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
