// Fused actor-critic forward + Gaussian sample for the PPO rollout, with the
// products on Hopper's tensor cores.
//
// Replaces the TPU kernel drone2d_tpu/ops/pallas_policy.py::fused_sample_action.
// For a batch of observations x (B, obs_dim) it computes, in float32,
//
//   h_pi = tanh(tanh(x W_pi0 + b_pi0) W_pi1 + b_pi1)       (B, H)
//   h_vf = tanh(tanh(x W_vf0 + b_vf0) W_vf1 + b_vf1)       (B, H)
//   mean = h_pi W_mean + b_mean (B, 2),  value = h_vf W_value + b_value (B,)
//   action = mean + exp(log_std) * noise
//   logp   = sum_a (-0.5 (noise_a^2 + log 2pi) - log_std_a)
//
// with the standard-normal noise drawn outside, as in the TPU kernel.  It
// takes two hidden layers of one width H, H a multiple of 8 from 8 to 256
// (padded inside to HP, the next multiple of 32, with zero weights), obs_dim
// up to 32 and two actions.
//
// Agent axis: one launch serves S actor-critics with their weights stacked
// (each array (S, ...), agent-major) and S blocks of B rows (obs (S, B,
// obs_dim), noise (S, B, 2); outputs (S, B, ...)).  Agent a runs on
// blockIdx.y = a, with every pointer advanced by a times that array's
// per-agent size; rows stay on blockIdx.x.  A population of S seeds or S
// eval agents thus steps in one launch instead of S.  S = 1 is the
// unstacked call, with every offset 0.  The bulk-copied arrays keep 16-byte
// slices (their per-agent sizes are multiples of 8 floats, as H is); b_mean,
// b_value and log_std are read with __ldg and need only 4-byte alignment.
//
// Bounds on an H100 at B = 4096, H = 128: the function is 80,128 FLOP a row
// (2 trunks x (27x128 + 128x128) multiply-adds + 3 head dot products of 128),
// 328.2 MFLOP a call, i.e. 4.9 us on the float32 CUDA cores at 67 TFLOP/s.
// Its matrix products, done here in three fp16 MMAs each (below), are
// 3 x 325.1 MFLOP on the tensor cores: 1.0 us at the dense fp16 rate of
// 989 TFLOP/s (2.0 us at the TF32 rate).  Its ~0.7 MB of traffic would take
// 0.2 us.  A population step of S = 8 agents x B = 1024 rows does the work
// of 8192 rows, 656 MFLOP (9.8 us in float32, 2.0 us on the tensor cores),
// and reads 8 weight sets, ~1.3 MB (0.4 us).
//
// Design.
//  * Tiles: a block takes 32 rows (two m16 tiles), so B = 4096 gives 128
//    blocks, about one per SM.  Eight math warps: warp w runs trunk w / 4
//    over a quarter of the HP columns for all 32 rows.  A ninth warp only
//    issues the weight copies.  (wgmma would need 64-row tiles and leave
//    half of the SMs idle at this batch.)
//  * Products on the tensor cores, float32-accurate: each operand is split
//    into fp16 pieces, a = hi + lo / 2^11, and mma.sync m16n8k16 accumulates
//    hi*hi and hi*lo + lo*hi in float32 (two accumulators, combined once),
//    dropping only lo*lo, ~2^-22 of a product.  This is 3xTF32's accuracy
//    at twice its work per MMA: the TF32 m16n8k8 and the fp16 m16n8k16 MMA
//    issue at the same rate.  Weights and x enter as value / 2^8, so that
//    any |value| below 1.6e7 stays finite in fp16, with an absolute error
//    of at most 2^-22 |value| + 2^-28; tanh values need no scale.
//  * Weights: re-read from L2 in every block of 16 rows, the ~160 KB of
//    weights would move 41.6 MB at B = 4096.  Here a block copies them
//    once into shared memory with cp.async.bulk, completing on mbarriers:
//    both W0 with the biases and head weights first, then W1 in slices
//    through a ring of stages with full/empty barriers, so that layer 0 runs
//    while W1 arrives (20.3 MB leave L2 at B = 4096).  A copy moves a group
//    of 8 whole rows (4 KB at H = 128), not one row: small bulk copies issue
//    slowly.  The group layout (see Smem) keeps the B fragment loads free of
//    bank conflicts without padding the rows; each weight is split into its
//    pieces by the one warp that reads it.
//  * Activations stay on the chip: x and h0 are split into pieces once, as
//    they are written to shared memory, in the order of the A fragments;
//    h1 stays in the accumulators, and the heads reduce from registers in
//    float32 FMAs on the CUDA cores (quad shuffles, then a small shared
//    array across the four warps of a trunk).
//  * tanh: 1 - 2 / (2^(2|x| log2 e) + 1), four values to one reciprocal
//    (tanh4); absolute error below ~5e-7, where tanh.approx would have 2^-11
//    relative error, which the flagship critic head (weights up to ~38 over
//    128 units) would lift past 1e-5 of the value's scale.
//  * The epilogue uses round-to-nearest intrinsics, so it is not contracted
//    and matches the plain version's separate multiply and add: log-prob and
//    the affine sample are bit-equal to it.
//
// Budget (ptxas -v, sm_90a, CUDA 12.8): 72 to 168 registers a thread over
// the 12 instantiations, growing with HP, one block of 288 threads an SM;
// one of the two 168-register ones spills 24 bytes.  Shared memory is
// Smem<HP>::BYTES: 211,456 bytes at HP = 128 (a 4-stage ring, all of W1)
// and 214,528 at HP = 256 (2 stages for 16 slices of 16 rows).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int ROWS = 32;                       // batch rows a block
constexpr int MATH_WARPS = 8;                  // 4 a trunk
constexpr int MATH_THREADS = 32 * MATH_WARPS;
constexpr int THREADS = MATH_THREADS + 32;     // + the copy warp
constexpr int K0 = 32;                         // layer-0 depth: obs_dim <= 32, zero-padded
constexpr int SMEM_MAX = 232448;               // a block's shared memory on sm_90
constexpr int BAR_BYTES = 256;                 // mbarrier area at the base
constexpr int BAR_MATH = 1;                    // named barrier of the math warps
constexpr int BAR_TRUNK = 2;                   // + trunk: the four warps of a trunk
constexpr int BAR_INIT = 4;                    // mbarriers initialised (all threads)
constexpr float LOG_2PI = 1.8378770664093453f;
constexpr float LO_SCALE = 2048.f;             // 2^11: fp16 pieces x = hi + lo / 2^11
constexpr float RANGE_SCALE = 1.f / 256.f;     // weights and x enter the pieces / 2^8

// Weights live in shared memory in "slices" of 4 groups of G rows: a group
// is G consecutive rows of the (in, out) matrix, one bulk copy when H == HP,
// and groups are GS = G * HP + 8 floats apart.  In 16-deep k-step s the
// thread with quad index tq reads rows tq * G + 4s .. tq * G + 4s + 3 of the
// slice, so the four quads read four groups whose bank offsets are 0, 8, 16
// and 24: the B fragments load without bank conflicts from unpadded rows.
//
// Activations (x, h0), the A operands, are kept in "fragment order": for
// m-tile mt and k-step kappa, lane l's four A registers are the four words
// of 16-byte unit (mt * NK + kappa) * 32 + l, so one 16-byte load fetches
// them.  h0's units are swizzled, lane l ^ swz(l, kappa), so that the layer-0
// epilogue, whose lanes write two k-steps at once, stores without bank
// conflicts.
//
// Shared-memory layout for a padded width HP (byte offsets).
template <int HP>
struct Smem {
  static constexpr int GMAX = HP > 128 ? 4 : 8; // largest W1 group
  static constexpr int GS0 = 8 * HP + 8;        // W0 group stride (floats), G = 8
  static constexpr int GSMAX = GMAX * HP + 8;
  static constexpr int X_HI = BAR_BYTES;                      // f16x2 [2][K0/16][32][4]
  static constexpr int X_LO = X_HI + ROWS * K0 * 2;           // f16x2 [2][K0/16][32][4]
  static constexpr int H0 = X_LO + ROWS * K0 * 2;             // f16x2 [2 trunks][hi, lo][2][HP/16][32][4]
  static constexpr int H0_BYTES = 2 * 2 * ROWS * HP * 2;
  static constexpr int W0 = H0 + H0_BYTES;                    // f32 [2][4][GS0]
  static constexpr int VEC = W0 + 2 * 4 * GS0 * 4;            // f32 b0[2][HP] b1[2][HP]
                                                              //     w_mean[HP][2] w_value[HP]
  static constexpr int PART = VEC + 7 * HP * 4;               // f32 [4][ROWS][3]
  static constexpr int RING = PART + 4 * ROWS * 3 * 4;        // f32 [STAGES][2][4][GSMAX]
  static constexpr int STAGE = 2 * 4 * GSMAX * 4;
  static constexpr int FIT = (SMEM_MAX - RING) / STAGE;
  static constexpr int MAX_SLICES = HP / 16;                  // G = 4
  static constexpr int STAGES = FIT < MAX_SLICES ? FIT : MAX_SLICES;
  static constexpr int BYTES = RING + STAGES * STAGE;
  static_assert(STAGES >= 2, "the W1 ring needs two stages");
  static_assert((1 + 2 * STAGES) * 8 <= BAR_BYTES, "mbarriers overflow their area");
  static_assert(H0 % 16 == 0 && W0 % 16 == 0 && RING % 16 == 0, "bulk copies need 16-byte alignment");
};

struct Trunk {
  const float* w0;  // (obs_dim, H)
  const float* b0;  // (H,)
  const float* w1;  // (H, H)
  const float* b1;  // (H,)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Blocks until the phase of parity `parity` has completed.  A copy that
// never lands would hang the card; after ~2^24 polls (well over a second)
// the kernel traps instead, and the launch reports an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// Global -> shared copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) that completes on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// tanh of four values: tanh x = sign(x) (1 - 2 / (2^(2 |x| log2 e) + 1)),
// the formula of CUDA's tanhf for |x| >= 0.6, used for every x, with one
// reciprocal for the four denominators (1 / d0 = d1 d2 d3 / (d0 d1 d2 d3)):
// the special-function unit, 4 lanes a cycle per scheduler, bounds the
// epilogues, and this takes 5 of its operations for 4 values instead of
// tanhf's 8.  The exponent is clamped at 30 (tanh is 1 in float32 from
// |x| = 9.1 on), so the product stays below 2^121.  Absolute error below
// ~5e-7 (tanhf's ~1e-7; tanh.approx has 2^-11 relative).
__device__ __forceinline__ void tanh4(float (&v)[4]) {
  float d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(d[i]) : "f"(fminf(fabsf(v[i]) * 2.8853900817779268f, 30.f)));
    d[i] += 1.f;
  }
  const float p01 = d[0] * d[1], p23 = d[2] * d[3];
  const float r = __fdividef(2.f, p01 * p23);
  const float r01 = r * p23, r23 = r * p01;  // 2 / (d0 d1), 2 / (d2 d3)
  v[0] = copysignf(1.f - r01 * d[1], v[0]);
  v[1] = copysignf(1.f - r01 * d[0], v[1]);
  v[2] = copysignf(1.f - r23 * d[3], v[2]);
  v[3] = copysignf(1.f - r23 * d[2], v[3]);
}

// The A fragment at fragment index `idx` (see Smem): hi and lo pieces.
__device__ __forceinline__ void load_a(const uint32_t* hi, const uint32_t* lo, int idx,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const uint4 h = *reinterpret_cast<const uint4*>(hi + idx * 4);
  const uint4 l = *reinterpret_cast<const uint4*>(lo + idx * 4);
  ah[0] = h.x; ah[1] = h.y; ah[2] = h.z; ah[3] = h.w;
  al[0] = l.x; al[1] = l.y; al[2] = l.z; al[3] = l.w;
}

// The swizzle of h0's units: an XOR below 4 that is constant over each
// quarter-warp (so the 16-byte reads stay conflict-free) and separates the
// writers of the layer-0 epilogue, lanes 4g + tq' of one half-warp writing
// k-steps kappa and kappa + 1.
__device__ __forceinline__ int swz(int l, int kappa) {
  return l ^ ((((l >> 3) & 1) << 1) | (kappa & 1));
}

__device__ __forceinline__ uint32_t h2_bits(__half2 h) {
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// The fp16 pieces of a pair (x0 in the low half).
__device__ __forceinline__ void split_h2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 f = __half22float2(h);
  hi = h2_bits(h);
  lo = h2_bits(__floats2half2_rn(fmaf(f.x, -LO_SCALE, x0 * LO_SCALE),
                                 fmaf(f.y, -LO_SCALE, x1 * LO_SCALE)));
}

// d += a * b on one m16n8k16 fp16 tile, float32 accumulation.
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-deep k-step of either layer: this thread's k are the four rows w,
// w + HP, w + 2 HP, w + 3 HP (logical k 2tq, 2tq + 1, 2tq + 8, 2tq + 9).
// hi*hi goes to acc, the two cross terms (scaled by 2^11) to accx.
template <int HP, int NT>
__device__ __forceinline__ void kstep16(float (&acc)[2][NT][4], float (&accx)[2][NT][4],
                                        const uint32_t (&ah)[2][4], const uint32_t (&al)[2][4],
                                        const float* w, int col0, int g) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = col0 + nt * 8 + g;
    split_h2(w[n] * RANGE_SCALE, w[HP + n] * RANGE_SCALE, bh[nt][0], bl[nt][0]);
    split_h2(w[2 * HP + n] * RANGE_SCALE, w[3 * HP + n] * RANGE_SCALE, bh[nt][1], bl[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma16(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma16(accx[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma16(accx[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
}

// acc = (hi*hi + cross terms / 2^11) * scale: the product in float32.
template <int NT>
__device__ __forceinline__ void combine(float (&acc)[2][NT][4], const float (&accx)[2][NT][4],
                                        float scale) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][nt][e] = fmaf(accx[mt][nt][e], 1.f / LO_SCALE, acc[mt][nt][e]) * scale;
}

// G: the W1 group size, 8 when 32 divides H and the ring's stages hold it,
// else 4; the last slice may then be short (H is a multiple of 8).
template <int HP, int G>
__global__ void __launch_bounds__(THREADS, 1) fused_sample_action_kernel(
    const float* __restrict__ obs, int B, int obs_dim, int H, Trunk pi, Trunk vf,
    const float* __restrict__ w_mean, const float* __restrict__ b_mean,
    const float* __restrict__ w_value, const float* __restrict__ b_value,
    const float* __restrict__ log_std, const float* __restrict__ noise,
    float* __restrict__ action, float* __restrict__ logp, float* __restrict__ value) {
  using L = Smem<HP>;
  constexpr int GS0 = L::GS0, NST = L::STAGES, NK16 = HP / 16;
  constexpr int GS = G * HP + 8;  // W1 group stride (floats)
  static_assert(G <= L::GMAX, "W1 groups larger than the ring's stages");
  constexpr int NT = HP / 32;  // n8 tiles a warp: a quarter of HP
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* w0_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = w0_full + 1;
  uint64_t* empty = full + NST;
  __half* x_hi = reinterpret_cast<__half*>(smem + L::X_HI);
  __half* x_lo = reinterpret_cast<__half*>(smem + L::X_LO);
  float* w0s = reinterpret_cast<float*>(smem + L::W0);
  float* vec = reinterpret_cast<float*>(smem + L::VEC);
  float* part = reinterpret_cast<float*>(smem + L::PART);
  float* ring = reinterpret_cast<float*>(smem + L::RING);

  // this block's agent: its weights, and its B rows of every batch array
  const size_t ag = blockIdx.y;
  pi.w0 += ag * obs_dim * H, vf.w0 += ag * obs_dim * H;
  pi.b0 += ag * H, vf.b0 += ag * H, pi.b1 += ag * H, vf.b1 += ag * H;
  pi.w1 += ag * H * H, vf.w1 += ag * H * H;
  w_mean += ag * 2 * H, w_value += ag * H;
  b_mean += ag * 2, b_value += ag, log_std += ag * 2;
  obs += ag * B * obs_dim, noise += ag * 2 * B;
  action += ag * 2 * B, logp += ag * B, value += ag * B;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * ROWS;
  const int nslices = (H + 4 * G - 1) / (4 * G);
  const bool whole_rows = H == HP;  // rows contiguous in smem: one copy a group

  // Global loads first, so that their latency overlaps the set-up: this
  // block's rows of x, and the epilogue's inputs for row tid.
  float xv[ROWS * K0 / MATH_THREADS];
#pragma unroll
  for (int j = 0; j < ROWS * K0 / MATH_THREADS; ++j) {
    const int i = tid + j * MATH_THREADS, r = i / K0, c = i % K0;
    xv[j] = (tid < MATH_THREADS && c < obs_dim && row0 + r < B)
                ? __ldg(obs + (size_t)(row0 + r) * obs_dim + c)
                : 0.f;
  }
  float2 nz = make_float2(0.f, 0.f);
  float bm0 = 0.f, bm1 = 0.f, bv = 0.f, ls0 = 0.f, ls1 = 0.f;
  if (tid < ROWS && row0 + tid < B) {
    nz = __ldg(reinterpret_cast<const float2*>(noise) + row0 + tid);
    bm0 = __ldg(b_mean), bm1 = __ldg(b_mean + 1), bv = __ldg(b_value);
    ls0 = __ldg(log_std), ls1 = __ldg(log_std + 1);
  }

  if (warp == MATH_WARPS) {
    // The copy warp: initialises the mbarriers, then copies W0 of both
    // trunks and the W1 slices through the ring.
    if (lane == 0) {
      mbar_init(w0_full, 1);
      for (int s = 0; s < NST; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, MATH_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect_tx(w0_full, (2u * obs_dim + 7) * H * 4);
    }
    __syncwarp();
    asm volatile("bar.arrive %0, %1;" ::"n"(BAR_INIT), "n"(THREADS) : "memory");
    for (int c = lane; c < 2 * K0; c += 32) {
      const int t = c / K0, r = c % K0;
      if (r < obs_dim && (!whole_rows || r % 8 == 0)) {
        const int rows = whole_rows ? min(8, obs_dim - r) : 1;
        bulk_copy(w0s + (t * 4 + r / 8) * GS0 + (r % 8) * HP,
                  (t ? vf.w0 : pi.w0) + (size_t)r * H, rows * H * 4, w0_full);
      }
    }
    // the biases and head weights, on the same barrier
    if (lane < 6) {
      const float* src = lane == 0 ? pi.b0 : lane == 1 ? vf.b0 : lane == 2 ? pi.b1
                       : lane == 3 ? vf.b1 : lane == 4 ? w_mean : w_value;
      bulk_copy(vec + (lane < 5 ? lane : 6) * HP, src, (lane == 4 ? 2 : 1) * H * 4, w0_full);
    }
    const int rpc = whole_rows ? G : 1;  // rows a copy
    const int per_group = G / rpc;
    for (int i = 0; i < nslices; ++i) {
      const int s = i % NST, use = i / NST;
      const int groups = min(4 * G, H - i * 4 * G) / G;  // whole groups in this slice
      if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
      if (lane == 0) mbar_expect_tx(full + s, 2u * groups * G * H * 4);
      __syncwarp();
      for (int c = lane; c < 2 * groups * per_group; c += 32) {
        const int t = c / (groups * per_group), j = (c / per_group) % groups, p = c % per_group;
        bulk_copy(ring + (size_t)s * (L::STAGE / 4) + (t * 4 + j) * GS + p * rpc * HP,
                  (t ? vf.w1 : pi.w1) + (size_t)(i * 4 * G + j * G + p * rpc) * H,
                  rpc * H * 4, full + s);
      }
    }
    return;
  }

  // Zero what the copies leave unwritten and the products read: W0 rows
  // obs_dim..K0-1, and the columns H..HP-1 of every weight row.  These bytes
  // are disjoint from the copies' destinations.
  const int pad = HP - H;
  for (int i = tid; i < 2 * (K0 - obs_dim) * HP; i += MATH_THREADS) {
    const int r = i / HP, t = r / (K0 - obs_dim), k = obs_dim + r % (K0 - obs_dim);
    w0s[(t * 4 + k / 8) * GS0 + (k % 8) * HP + i % HP] = 0.f;
  }
  for (int i = tid; i < 2 * obs_dim * pad; i += MATH_THREADS) {
    const int r = i / pad, t = r / obs_dim, k = r % obs_dim;
    w0s[(t * 4 + k / 8) * GS0 + (k % 8) * HP + H + i % pad] = 0.f;
  }
  {
    // A short last slice in a stage of its own: its missing groups meet
    // zero columns of h0, and must not hold NaN bits.  (A reused stage holds
    // an earlier slice's weights there.)
    const int last = nslices - 1, groups = (H - last * 4 * G) / G;
    if (groups < 4 && last < NST) {
      for (int i = tid; i < 2 * (4 - groups) * G * HP; i += MATH_THREADS) {
        const int r = i / HP, t = r / ((4 - groups) * G), j = groups + (r / G) % (4 - groups);
        ring[(size_t)last * (L::STAGE / 4) + (t * 4 + j) * GS + (r % G) * HP + i % HP] = 0.f;
      }
    }
  }
  for (int i = tid; i < NST * 2 * 4 * G * pad; i += MATH_THREADS) {
    const int r = i / pad;  // (stage, trunk, group, row in group)
    ring[(size_t)(r / (8 * G)) * (L::STAGE / 4) + ((r / G) % 8) * GS + (r % G) * HP + H +
         i % pad] = 0.f;
  }
  // x / 2^8 (as W1, for range), split into fp16 pieces once, in fragment
  // order: row r = 16 mt + 8 hf + g and column c = 8 tq + 4 s + p go to
  // lane 4 g + tq of k-step s, register 2 (p / 2) + hf, half p % 2.
#pragma unroll
  for (int j = 0; j < ROWS * K0 / MATH_THREADS; ++j) {
    const int i = tid + j * MATH_THREADS, r = i / K0, c = i % K0;
    const int p = c % 4;
    const int idx = (((r / 16) * 2 + (c % 8) / 4) * 32 + (r % 8) * 4 + c / 8) * 8 +
                    ((p / 2) * 2 + (r % 16) / 8) * 2 + p % 2;
    const float v = xv[j] * RANGE_SCALE;
    const __half h = __float2half_rn(v);
    x_hi[idx] = h;
    x_lo[idx] = __float2half_rn(fmaf(__half2float(h), -LO_SCALE, v * LO_SCALE));
  }
  named_sync(BAR_INIT, THREADS);  // x staged, and the mbarriers initialised

  const int t = warp / 4, q = warp % 4;  // trunk, column quarter
  const int g = lane / 4, tq = lane % 4;  // mma groupID, thread in group
  const int col0 = q * (HP / 4);
  float acc[2][NT][4];

  // Layer 0: (32, K0) x (K0, HP) for this warp's columns in fp16 pieces;
  // W0 is one slice of 4 groups of 8 rows, two 16-deep k-steps.
  float accx[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = accx[mt][nt][e] = 0.f;
  mbar_wait(w0_full, 0);
#pragma unroll
  for (int ks = 0; ks < K0 / 16; ++ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      load_a(reinterpret_cast<const uint32_t*>(x_hi), reinterpret_cast<const uint32_t*>(x_lo),
             (mt * 2 + ks) * 32 + lane, ah[mt], al[mt]);
    }
    kstep16<HP, NT>(acc, accx, ah, al, w0s + (t * 4 + tq) * GS0 + 4 * ks * HP, col0, g);
  }
  combine<NT>(acc, accx, 1.f / (RANGE_SCALE * RANGE_SCALE));

  // h0 = tanh(. + b0) into shared memory as fp16 pieces, in fragment order
  // for layer 1: column c = 4G i + G tq' + 4 s + p sits in 16-deep k-step
  // i G/4 + s of lane 4 g + tq', register p / 2 (row g) or p / 2 + 1 (row
  // g + 8).  The padded columns give tanh(0) = 0.
  uint32_t* h0_hi = reinterpret_cast<uint32_t*>(smem + L::H0) + t * ROWS * HP;
  uint32_t* h0_lo = h0_hi + ROWS * HP / 2;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = col0 + nt * 8 + 2 * tq;
    const int kappa = (c / (4 * G)) * (G / 4) + (c % G) / 4;
    const int unit_lane = swz(g * 4 + (c % (4 * G)) / G, kappa);
    const int reg = (c % 4) / 2 * 2;
    const float2 b = c < H ? *reinterpret_cast<const float2*>(vec + t * HP + c)
                           : make_float2(0.f, 0.f);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int w = ((mt * NK16 + kappa) * 32 + unit_lane) * 4 + reg;
      float y[4] = {acc[mt][nt][0] + b.x, acc[mt][nt][1] + b.y, acc[mt][nt][2] + b.x,
                    acc[mt][nt][3] + b.y};
      tanh4(y);
      uint2 hi, lo;  // rows g and g + 8: registers reg and reg + 1
      split_h2(y[0], y[1], hi.x, lo.x);
      split_h2(y[2], y[3], hi.y, lo.y);
      *reinterpret_cast<uint2*>(h0_hi + w) = hi;
      *reinterpret_cast<uint2*>(h0_lo + w) = lo;
    }
  }
  named_sync(BAR_TRUNK + t, MATH_THREADS / 2);

  // Layer 1: (32, H) x (H, HP) in fp16 pieces, W1 streamed through the ring.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = accx[mt][nt][e] = 0.f;
  for (int i = 0; i < nslices; ++i) {
    const int s = i % NST;
    mbar_wait(full + s, (i / NST) & 1);
    const float* w = ring + (size_t)s * (L::STAGE / 4) + (t * 4 + tq) * GS;
#pragma unroll
    for (int ks = 0; ks < G / 4; ++ks) {
      const int kappa = i * (G / 4) + ks;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        load_a(h0_hi, h0_lo, (mt * NK16 + kappa) * 32 + swz(lane, kappa), ah[mt], al[mt]);
      }
      kstep16<HP, NT>(acc, accx, ah, al, w + 4 * ks * HP, col0, g);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
  combine<NT>(acc, accx, 1.f / RANGE_SCALE);

  // Heads from registers: h1 = tanh(. + b1), then this warp's share of the
  // mean (trunk 0) or value (trunk 1) dot products for rows g, g + 8, g + 16
  // and g + 24 (index [mt][half]).
  float head[2][2][2];  // [mt][half][output]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) head[mt][hf][0] = head[mt][hf][1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = col0 + nt * 8 + 2 * tq;
    if (c < H) {
      const float2 b = *reinterpret_cast<const float2*>(vec + (2 + t) * HP + c);
      // w_mean rows c and c + 1: (c, 0), (c, 1), (c + 1, 0), (c + 1, 1)
      const float4 wm = t == 0 ? *reinterpret_cast<const float4*>(vec + 4 * HP + 2 * c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const float2 wv = t == 1 ? *reinterpret_cast<const float2*>(vec + 6 * HP + c)
                               : make_float2(0.f, 0.f);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float y[4] = {acc[mt][nt][0] + b.x, acc[mt][nt][1] + b.y, acc[mt][nt][2] + b.x,
                      acc[mt][nt][3] + b.y};
        tanh4(y);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float y0 = y[2 * hf], y1 = y[2 * hf + 1];
          if (t == 0) {
            head[mt][hf][0] = fmaf(y1, wm.z, fmaf(y0, wm.x, head[mt][hf][0]));
            head[mt][hf][1] = fmaf(y1, wm.w, fmaf(y0, wm.y, head[mt][hf][1]));
          } else {
            head[mt][hf][0] = fmaf(y1, wv.y, fmaf(y0, wv.x, head[mt][hf][0]));
          }
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        float v = head[mt][hf][o];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        head[mt][hf][o] = v;
      }
  if (tq == 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* p = part + (q * ROWS + mt * 16 + hf * 8 + g) * 3;
        if (t == 0) {
          p[0] = head[mt][hf][0];
          p[1] = head[mt][hf][1];
        } else {
          p[2] = head[mt][hf][0];
        }
      }
  }
  named_sync(BAR_MATH, MATH_THREADS);

  if (tid < ROWS && row0 + tid < B) {
    const int row = row0 + tid;
    float out[3];
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      float s = part[tid * 3 + o];
#pragma unroll
      for (int qq = 1; qq < 4; ++qq) s += part[(qq * ROWS + tid) * 3 + o];
      out[o] = s;
    }
    const float mean0 = out[0] + bm0, mean1 = out[1] + bm1;
    const float n0 = nz.x, n1 = nz.y;
    action[2 * row] = __fadd_rn(mean0, __fmul_rn(expf(ls0), n0));
    action[2 * row + 1] = __fadd_rn(mean1, __fmul_rn(expf(ls1), n1));
    const float l0 = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(__fmul_rn(n0, n0), LOG_2PI)), ls0);
    const float l1 = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(__fmul_rn(n1, n1), LOG_2PI)), ls1);
    logp[row] = __fadd_rn(l0, l1);
    value[row] = out[2] + bv;
  }
}

struct Args {
  const float* obs;
  int B, S, obs_dim, H;
  Trunk pi, vf;
  const float *w_mean, *b_mean, *w_value, *b_value, *log_std, *noise;
  float *action, *logp, *value;
};

// The dynamic shared-memory limit is set once an instantiation and device,
// at its first launch, so that a launch while a stream is being captured
// into a CUDA graph issues nothing but the kernel itself.  Two threads that
// race on a first launch both set the same value, which is harmless.
constexpr int MAX_DEVICES = 64;

template <int HP, int G>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = Smem<HP>::BYTES;
  // 0: not set yet; else 1 + the cudaError_t of the one cudaFuncSetAttribute
  static std::atomic<int> configured[MAX_DEVICES];
  int device = 0;
  const cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int c = configured[device].load();
  if (c == 0) {
    c = 1 + (int)cudaFuncSetAttribute(fused_sample_action_kernel<HP, G>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    configured[device].store(c);
  }
  if (c != 1) return c - 1;
  const dim3 grid((a.B + ROWS - 1) / ROWS, a.S);
  fused_sample_action_kernel<HP, G><<<grid, THREADS, bytes, stream>>>(
      a.obs, a.B, a.obs_dim, a.H, a.pi, a.vf, a.w_mean, a.b_mean, a.w_value, a.b_value,
      a.log_std, a.noise, a.action, a.logp, a.value);
  return (int)cudaGetLastError();
}

// W1 groups of 8 rows where 32 divides H and the ring's stages hold them.
template <int HP>
int launch_width(const Args& a, cudaStream_t stream) {
  if constexpr (Smem<HP>::GMAX >= 8) {
    if (a.H % 32 == 0) return launch<HP, 8>(a, stream);
  }
  return launch<HP, 4>(a, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are contiguous
// float32 device arrays for S agents of B rows each (see "Agent axis"), the
// weights stored (in, out), each array but b_mean, b_value and log_std
// 16-byte aligned.  Takes S in [1, 65535], H a multiple of 8 in [8, 256]
// and obs_dim in [1, 32].  Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int fused_sample_action_launch(
    const float* obs, int B, int S, int obs_dim, int H,
    const float* pi_w0, const float* pi_b0, const float* pi_w1, const float* pi_b1,
    const float* vf_w0, const float* vf_b0, const float* vf_w1, const float* vf_b1,
    const float* w_mean, const float* b_mean, const float* w_value,
    const float* b_value, const float* log_std, const float* noise,
    float* action, float* logp, float* value, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (S > 65535 || obs_dim < 1 || obs_dim > K0 || H < 8 || H > 256 || H % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{obs, B, S, obs_dim, H,
               Trunk{pi_w0, pi_b0, pi_w1, pi_b1}, Trunk{vf_w0, vf_b0, vf_w1, vf_b1},
               w_mean, b_mean, w_value, b_value, log_std, noise, action, logp, value};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((H + 31) / 32) {
    case 1: return launch_width<32>(a, s);
    case 2: return launch_width<64>(a, s);
    case 3: return launch_width<96>(a, s);
    case 4: return launch_width<128>(a, s);
    case 5: return launch_width<160>(a, s);
    case 6: return launch_width<192>(a, s);
    case 7: return launch_width<224>(a, s);
    case 8: return launch_width<256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
