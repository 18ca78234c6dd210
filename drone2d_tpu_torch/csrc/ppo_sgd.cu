// One PPO minibatch step of an actor-critic population: the clipped-surrogate
// loss, its gradient, the per-member global-norm clip and Adam, in three
// launches.
//
// Replaces no TPU kernel: the JAX package leaves its SGD step to XLA
// (`drone2d_tpu/learn/ppo.py::loss_fn` under `jax.value_and_grad`, then
// optax).  It was added because, issued as PyTorch and cuBLAS calls, one
// minibatch step is a chain of ~239 small dependent kernels: at the seed
// hunts' shape (8 members x 2,048 rows, H = 128) 1.0 ms a step, 5.8% of its
// float32 bound, and at the SB3 shape (8 x 64 rows, H = 64) pure launch
// latency.
//
// What a step computes, per member m of S (one stacked actor-critic; S = 1
// for a single one), exactly what `learn/ppo.py::_epoch` computes on the
// CPU (`PPOLearner.plain_sgd_step`):
//   rows r of minibatch k, gathered by the epoch's shuffle straight from the
//   rollout's tensors ('exact'/'affine': row perm[k mb + r]; 'timeperm':
//   timestep perm[k T/M + r / N], env r % N);
//   the advantages normalised over the minibatch (two-pass population
//   variance, + 1e-8), both tanh trunks and heads, the Gaussian log-prob,
//   the clipped surrogate, the value loss and the entropy bonus; the
//   gradient of loss = pg + vf_coef v - ent_coef ent into every leaf;
//   optax's clip_by_global_norm (no epsilon: divide by n and multiply by
//   max_norm when n >= max_norm); torch's capturable Adam arithmetic
//   (optax's algebra) in place on the optimizer's own moments and step
//   counts; and the row (loss, policy_loss, value_loss, entropy,
//   clip_fraction, approx_kl).
//
// Bounds on an H100: a row costs 226,560 FLOP at H = 128 (the forward's
// 80,128, as many for the weights' gradients, and the inputs' gradients of
// every layer but the first: no gradient flows into the observations), so
// a step of 8 x 2,048 rows is 3.71 GFLOP, 55.4 us at the 67 TFLOP/s
// float32 rate; its bytes (the rows, ~1 MB, and 8 members' weights,
// moments and gradients, ~5 MB) take under 2 us.  At the SB3 shape a step
// is 33 MFLOP, 0.49 us: there only the number of dependent launches and
// the blocks' own latency count.
//
// Design.
//  * Launch 1 (`grad`): a block per (row block, trunk, member).  The policy
//    trunk (with the mean head and log_std) and the value trunk share no
//    weight and their loss terms separate, so they run in separate blocks.
//    A block holds its rows' inputs, both hidden layers and their
//    gradients in shared memory, streams the weights through a two-stage
//    ring of 32-row chunks (cp.async), and writes its trunk's gradient
//    summed over its rows to a partial buffer (no atomics).  Rows a block:
//    128 where H <= 128 and the minibatch has more than 64 rows, else 64:
//    so 16 blocks a trunk at the hunts' shape (FLOP-bound: 512 blocks over
//    132 SMs) and one at the SB3 shape (latency-bound: 16 blocks).
//  * Products: float32 FMAs on the CUDA cores (TF32 stays off; fp16 pieces
//    would drop small gradients), register tiles of up to 8 x 8 outputs a
//    thread over a 16 x 16 thread grid; the activations' rows are padded
//    to an odd pitch so that both orientations read without bank conflicts.
//  * Launch 2 (`sums`): blocks over each member's elements (its 13 leaves
//    in order, 4 a thread) sum the partials in a fixed order into the
//    gradients, and each block its share of the member's sum of squares.
//    Launch 3 (`adam`): each block takes the member's norm from those
//    shares (a fixed order), clips and steps Adam on its elements.  Many
//    blocks keep enough loads in flight: the partials are ~42 MB a step at
//    the hunts' shape.  Reruns are bit-identical, and a member's results do
//    not depend on the others.  With a data-parallel group, the gradients
//    are all-reduced after launch 2, which then runs again over them for
//    the norm; the advantage moments come from `moments` launches around
//    their all-reduces.
//  * The step counts are incremented by launch 1 (one thread), read by
//    launch 3.
//
// Budget (ptxas -v, sm_90a, CUDA 12.8): launch 1 takes 72 to 168 registers
// a thread over its 12 instantiations, none spilled, and Smem<HP, RB>::BYTES
// of shared memory (187,200 at HP = RB = 128: one block an SM).  Measured
// on an H100 (PERF.md §6): 204 us a step at the hunts' shape, 27.2% of its
// float32 bound, and 37 us at the SB3 shape.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KX = 32;                // layer-0 depth: obs_dim <= 32, zero-padded
constexpr int XP = KX + 1;            // pitch of the rows' inputs
constexpr int KC = 32;                // weight rows a staged chunk
constexpr int LEAVES = 13;
constexpr int PI = 0, VF = 7;         // first leaf of each trunk (see Leaf order)
constexpr int LOG_STD = 6;
constexpr int PER_THREAD = 4;         // elements a thread in launches 2 and 3
constexpr int MAX_DEVICES = 64;
constexpr float LOG_2PI = 1.8378770664093453f;

// Leaves in this order: pi0/w, pi0/b, pi1/w, pi1/b, pi_out/w, pi_out/b,
// log_std, vf0/w, vf0/b, vf1/w, vf1/b, vf_out/w, vf_out/b; each array is
// (S, ...) member-major and contiguous, `n` elements a member.
struct Leaf {
  float* param;
  float* grad;
  float* exp_avg;
  float* exp_avg_sq;
  float* step;  // Adam's step count of this leaf: a float32 scalar
  long long n;
};

struct Args {
  const float *obs, *act, *logp_old, *adv, *ret;
  const long long* perm;
  float *partial, *rowpart, *moments, *row, *normpart;
  Leaf leaves[LEAVES];
  // element (m, t, n) of the rows' tensors (in rows; obs and act scale by
  // their widths), and the shuffle's stride between members
  long long s_member, s_time, s_env, perm_member;
  int S, F, H, mb, k, timeperm, n_envs, steps_per_mb, nrb, mblocks;
  // Adam's constants as torch rounds them: beta1, beta2 and 1 - beta1,
  // 1 - beta2 taken in double and rounded once
  float clip_range, vf_coef, ent_coef, max_norm, lr, beta1, beta2, one_minus_beta1,
      one_minus_beta2, eps;
};

// A trunk's gradient in the partial buffer: w0 (F, H), b0, w1 (H, H), b1,
// w_out (H, A), b_out (A), then (policy trunk only) log_std (A).
__host__ __device__ inline long long trunk_offset(int leaf, int F, int H) {
  const int A = leaf < VF ? 2 : 1;
  const long long FH = (long long)F * H, HH = (long long)H * H;
  switch (leaf < VF ? leaf : leaf - VF) {
    case 0: return 0;
    case 1: return FH;
    case 2: return FH + H;
    case 3: return FH + H + HH;
    case 4: return FH + 2 * H + HH;
    case 5: return FH + 2 * H + HH + (long long)H * A;
    default: return FH + 2 * H + HH + (long long)H * A + A;  // log_std
  }
}

// Floats a trunk's partial takes (the policy trunk's, the larger).
__host__ __device__ inline long long trunk_floats(int F, int H) {
  return trunk_offset(LOG_STD, F, H) + 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte global -> shared copy; bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sum of every thread's `v`, in a fixed order (butterflies within the
// warps, then the warps' sums in turn), returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = scratch[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s += scratch[w];
  return s;
}

// The row (in rows of the rollout's tensors) of row j of minibatch k of
// member m.
__device__ __forceinline__ long long row_addr(const Args& a, int m, int j) {
  const long long* perm = a.perm + m * a.perm_member;
  if (a.timeperm) {
    const long long t = perm[(long long)a.k * a.steps_per_mb + j / a.n_envs];
    return m * a.s_member + t * a.s_time + (long long)(j % a.n_envs) * a.s_env;
  }
  return m * a.s_member + perm[(long long)a.k * a.mb + j] * a.s_env;
}

// The minibatch's advantage mean of member m, or with `mean` given its
// population variance about that mean: the same arithmetic in every block
// and in `moments_kernel`.
__device__ float adv_moment(const Args& a, int m, bool var, float mean, float* scratch) {
  float s = 0.f;
  for (int j = threadIdx.x; j < a.mb; j += THREADS) {
    const float x = a.adv[row_addr(a, m, j)];
    s += var ? (x - mean) * (x - mean) : x;
  }
  return block_sum(s, scratch) / (float)a.mb;
}

// acc[i][j] += sum over k < K of A(ty + 16 i, k) B(k, tx + 16 j), with
// A(r, k) = A[r AI + k AK] and B(k, c) = B[k BK + c] in shared memory.
template <int TM, int TN, int AI, int AK, int BK, int K>
__device__ __forceinline__ void gemm(float (&acc)[TM][TN], const float* A, const float* B) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* a0 = A + ty * AI;
  const float* b0 = B + tx;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a0[i * 16 * AI + k * AK];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b0[k * BK + j * 16];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// Shared memory of launch 1 for a padded width HP and RB rows (floats).
template <int HP, int RB>
struct Smem {
  static constexpr int HPP = HP + 1;         // odd pitch of a row of activations
  static constexpr int X = 0;                // RB x XP inputs
  static constexpr int H1 = X + RB * XP;     // RB x HPP: h1, later dz1
  static constexpr int H2 = H1 + RB * HPP;   // RB x HPP: h2, later dz2
  static constexpr int W = H2 + RB * HPP;    // 2 x KC x HPP weight chunks
  static constexpr int WO = W + 2 * KC * HPP;  // HP x 2 head weights
  static constexpr int B0 = WO + 2 * HP;
  static constexpr int B1 = B0 + HP;
  static constexpr int DOUT = B1 + HP;       // RB x 2: head outputs, then their gradients
  static constexpr int GLS = DOUT + 2 * RB;  // RB x 2: each row's log_std gradient
  static constexpr int ADDR = GLS + 2 * RB;  // RB rows' addresses (long long)
  static constexpr int SCRATCH = ADDR + 2 * RB;
  static constexpr int FLOATS = SCRATCH + 2 * WARPS;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(ADDR % 2 == 0, "8-byte aligned addresses");
};

// Chunk c of a (K, H) row-major matrix: rows c KC .. c KC + KC - 1 into
// dst[kk][j] (pitch HP + 1), zero past K or H.
template <int HP>
__device__ __forceinline__ void stage_rows(float* dst, const float* w, int K, int H, int c) {
  for (int idx = threadIdx.x; idx < KC * HP; idx += THREADS) {
    const int kk = idx / HP, j = idx % HP, k = c * KC + kk;
    const bool ok = k < K && j < H;
    cp_async4(dst + kk * (HP + 1) + j, ok ? w + (long long)k * H + j : w, ok ? 4 : 0);
  }
}

// Chunk c of the transpose of an (H, H) matrix: dst[kk][k] = w[k][c KC + kk].
template <int HP>
__device__ __forceinline__ void stage_cols(float* dst, const float* w, int H, int c) {
  for (int idx = threadIdx.x; idx < KC * HP; idx += THREADS) {
    const int kk = idx % KC, k = idx / KC, j = c * KC + kk;
    const bool ok = k < H && j < H;
    cp_async4(dst + kk * (HP + 1) + k, ok ? w + (long long)k * H + j : w, ok ? 4 : 0);
  }
}

// acc += A (rows of pitch AI, K = HP) times an (HP, HP) matrix whose chunk c
// `stage(c, dst)` copies; chunk 0 is already in flight into buffer 0.
template <int HP, int TM, int TN, int AI, class Stage>
__device__ __forceinline__ void gemm_chunks(float (&acc)[TM][TN], const float* A, float* wbuf,
                                            Stage stage) {
  constexpr int HPP = HP + 1, NCH = HP / KC;
  for (int c = 0; c < NCH; ++c) {
    if (c + 1 < NCH) {
      stage(c + 1, wbuf + ((c + 1) & 1) * KC * HPP);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    gemm<TM, TN, AI, 1, HPP, KC>(acc, A + c * KC, wbuf + (c & 1) * KC * HPP);
    __syncthreads();
  }
}

template <int HP, int RB>
__global__ void __launch_bounds__(THREADS, 1) grad_kernel(const __grid_constant__ Args a) {
  using L = Smem<HP, RB>;
  constexpr int HPP = L::HPP, TM = RB / 16, TN = HP / 16;
  extern __shared__ __align__(16) float sm[];
  const int rb = blockIdx.x, trunk = blockIdx.y, m = blockIdx.z, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int F = a.F, H = a.H, A = trunk == 0 ? 2 : 1;
  const int rows = min(RB, a.mb - rb * RB);
  const Leaf* lv = a.leaves + (trunk == 0 ? PI : VF);
  const float* w0 = lv[0].param + m * lv[0].n;
  const float* b0 = lv[1].param + m * lv[1].n;
  const float* w1 = lv[2].param + m * lv[2].n;
  const float* b1 = lv[3].param + m * lv[3].n;
  const float* wo = lv[4].param + m * lv[4].n;
  const float* bo = lv[5].param + m * lv[5].n;
  float* part = a.partial + ((long long)(m * 2 + trunk) * a.nrb + rb) * trunk_floats(F, H);
  float* x = sm + L::X;
  float* h1 = sm + L::H1;
  float* h2 = sm + L::H2;
  float* wbuf = sm + L::W;
  float* scratch = sm + L::SCRATCH;
  long long* addr = reinterpret_cast<long long*>(sm + L::ADDR);

  if (m == 0 && trunk == 0 && rb == 0 && tid < LEAVES) *a.leaves[tid].step += 1.f;

  // the weights of layer 0 (buffer 1) and layer 1's first chunk (buffer 0)
  stage_rows<HP>(wbuf + KC * HPP, w0, F, H, 0);
  cp_commit();
  stage_rows<HP>(wbuf, w1, H, H, 0);
  cp_commit();
  for (int j = tid; j < HP; j += THREADS) {
    sm[L::B0 + j] = j < H ? b0[j] : 0.f;
    sm[L::B1 + j] = j < H ? b1[j] : 0.f;
    sm[L::WO + 2 * j] = j < H ? wo[j * A] : 0.f;
    sm[L::WO + 2 * j + 1] = j < H && A == 2 ? wo[j * A + 1] : 0.f;
  }
  for (int r = tid; r < RB; r += THREADS) addr[r] = r < rows ? row_addr(a, m, rb * RB + r) : -1;
  float mean, var;
  if (a.moments != nullptr) {
    mean = a.moments[m];
    var = a.moments[a.S + m];
  } else {
    mean = adv_moment(a, m, false, 0.f, scratch);
    var = adv_moment(a, m, true, mean, scratch);
  }
  __syncthreads();  // addr
  for (int idx = tid; idx < RB * KX; idx += THREADS) {
    const int r = idx / KX, f = idx % KX;
    x[r * XP + f] = r < rows && f < F ? a.obs[addr[r] * F + f] : 0.f;
  }
  cp_wait<1>();
  __syncthreads();

  // forward: h1 = tanh(x w0 + b0), h2 = tanh(h1 w1 + b1)
  {
    float acc[TM][TN];
    zero(acc);
    gemm<TM, TN, XP, 1, HPP, KX>(acc, x, wbuf + KC * HPP);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        h1[r * HPP + c] = tanhf(acc[i][j] + sm[L::B0 + c]);
      }
    __syncthreads();
    zero(acc);
    gemm_chunks<HP, TM, TN, HPP>(acc, h1, wbuf, [&](int c, float* dst) {
      stage_rows<HP>(dst, w1, H, H, c);
    });
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        h2[r * HPP + c] = tanhf(acc[i][j] + sm[L::B1 + c]);
      }
  }
  // the transpose of w1 for dz1, in flight while the loss and dw1 run
  stage_cols<HP>(wbuf, w1, H, 0);
  cp_commit();
  __syncthreads();

  // heads: a warp a row, lanes over the width, butterfly sums
  for (int r = tid >> 5; r < RB; r += WARPS) {
    float s0 = 0.f, s1 = 0.f;
    for (int c = tid & 31; c < HP; c += 32) {
      const float h = h2[r * HPP + c];
      s0 = fmaf(h, sm[L::WO + 2 * c], s0);
      s1 = fmaf(h, sm[L::WO + 2 * c + 1], s1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if ((tid & 31) == 0) {
      sm[L::DOUT + 2 * r] = s0 + bo[0];
      sm[L::DOUT + 2 * r + 1] = A == 2 ? s1 + bo[1] : 0.f;
    }
  }
  __syncthreads();

  // each row's loss terms and the gradient of its head outputs
  const float inv_mb = 1.f / (float)a.mb;
  float t0 = 0.f, t1 = 0.f, t2 = 0.f;
  if (tid < RB) {
    const int r = tid;
    float d0 = 0.f, d1 = 0.f, g0 = 0.f, g1 = 0.f;
    if (r < rows) {
      const long long at = addr[r];
      if (trunk == 0) {
        const float* ls = a.leaves[LOG_STD].param + m * 2;
        const float adv = (a.adv[at] - mean) / (sqrtf(var) + 1e-8f);
        const float sd0 = expf(ls[0]), sd1 = expf(ls[1]);
        const float z0 = (a.act[2 * at] - sm[L::DOUT + 2 * r]) / sd0;
        const float z1 = (a.act[2 * at + 1] - sm[L::DOUT + 2 * r + 1]) / sd1;
        const float logp = (-0.5f * (z0 * z0 + LOG_2PI) - ls[0]) +
                           (-0.5f * (z1 * z1 + LOG_2PI) - ls[1]);
        const float old = a.logp_old[at];
        const float ratio = expf(logp - old);
        const float lo = 1.f - a.clip_range, hi = 1.f + a.clip_range;
        const float pg1 = adv * ratio, pg2 = adv * fminf(fmaxf(ratio, lo), hi);
        // d min / d pg1 and d pg2 as autograd takes them (a tie splits)
        const float w1 = pg1 < pg2 ? 1.f : (pg1 > pg2 ? 0.f : 0.5f);
        const float inside = ratio >= lo && ratio <= hi ? 1.f : 0.f;
        const float g_ratio = -inv_mb * (w1 * adv + (1.f - w1) * adv * inside);
        const float g_logp = g_ratio * ratio;
        d0 = g_logp * z0 / sd0;
        d1 = g_logp * z1 / sd1;
        g0 = g_logp * (z0 * z0 - 1.f);
        g1 = g_logp * (z1 * z1 - 1.f);
        t0 = fminf(pg1, pg2);
        t1 = fabsf(ratio - 1.f) > a.clip_range ? 1.f : 0.f;
        t2 = old - logp;
      } else {
        const float diff = a.ret[at] - sm[L::DOUT + 2 * r];
        t0 = diff * diff;
        d0 = -(2.f * diff) * (a.vf_coef * inv_mb);
      }
    }
    sm[L::DOUT + 2 * r] = d0;
    sm[L::DOUT + 2 * r + 1] = d1;
    sm[L::GLS + 2 * r] = g0;
    sm[L::GLS + 2 * r + 1] = g1;
  }
  {
    float* rp = a.rowpart + ((long long)(m * 2 + trunk) * a.nrb + rb) * 4;
    const float s0 = block_sum(t0, scratch);
    const float s1 = block_sum(t1, scratch);
    const float s2 = block_sum(t2, scratch);
    if (tid == 0) {
      rp[0] = s0;
      rp[1] = s1;
      rp[2] = s2;
      if (trunk == 0) {
        const float* ls = a.leaves[LOG_STD].param + m * 2;
        rp[3] = (ls[0] + 0.5f * (LOG_2PI + 1.f)) + (ls[1] + 0.5f * (LOG_2PI + 1.f));
      }
    }
  }
  __syncthreads();  // DOUT, GLS

  // the heads' gradients and log_std's: over the block's rows
  const int first = trunk == 0 ? PI : VF;
  for (int idx = tid; idx < H * A; idx += THREADS) {
    const int c = idx / A, o = idx % A;
    float s = 0.f;
    for (int r = 0; r < RB; ++r) s = fmaf(h2[r * HPP + c], sm[L::DOUT + 2 * r + o], s);
    part[trunk_offset(first + 4, F, H) + idx] = s;
  }
  if (tid < (trunk == 0 ? 2 * A : A)) {
    const int o = tid % A;
    const float* src = sm + (tid < A ? L::DOUT : L::GLS);
    float s = 0.f;
    for (int r = 0; r < RB; ++r) s += src[2 * r + o];
    part[trunk_offset(tid < A ? first + 5 : LOG_STD, F, H) + o] = s;
  }
  __syncthreads();
  // dz2 = (dout w_out^T) (1 - h2^2), over h2
  for (int idx = tid; idx < RB * HP; idx += THREADS) {
    const int r = idx / HP, c = idx % HP;
    const float g = sm[L::DOUT + 2 * r] * sm[L::WO + 2 * c] +
                    sm[L::DOUT + 2 * r + 1] * sm[L::WO + 2 * c + 1];
    const float h = h2[r * HPP + c];
    h2[r * HPP + c] = g * (1.f - h * h);
  }
  __syncthreads();
  // dw1 = h1^T dz2 and db1, in passes of WP rows of dw1
  {
    constexpr int WP = HP <= 128 ? HP : 32, TMW = WP / 16;
    for (int i0 = 0; i0 < HP; i0 += WP) {
      float acc[TMW][TN];
      zero(acc);
      gemm<TMW, TN, 1, HPP, HPP, RB>(acc, h1 + i0, h2);
#pragma unroll
      for (int i = 0; i < TMW; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int r = i0 + ty + 16 * i, c = tx + 16 * j;
          if (r < H && c < H) part[trunk_offset(2, F, H) + (long long)r * H + c] = acc[i][j];
        }
    }
    for (int c = tid; c < H; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < RB; ++r) s += h2[r * HPP + c];
      part[trunk_offset(3, F, H) + c] = s;
    }
  }
  __syncthreads();
  // dz1 = (dz2 w1^T) (1 - h1^2), over h1
  {
    float acc[TM][TN];
    zero(acc);
    gemm_chunks<HP, TM, TN, HPP>(acc, h2, wbuf, [&](int c, float* dst) {
      stage_cols<HP>(dst, w1, H, c);
    });
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float h = h1[r * HPP + c];
        h1[r * HPP + c] = acc[i][j] * (1.f - h * h);
      }
  }
  __syncthreads();
  // dw0 = x^T dz1 and db0
  {
    float acc[KX / 16][TN];
    zero(acc);
    gemm<KX / 16, TN, 1, XP, HPP, RB>(acc, x, h1);
#pragma unroll
    for (int i = 0; i < KX / 16; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int f = ty + 16 * i, c = tx + 16 * j;
        if (f < F && c < H) part[(long long)f * H + c] = acc[i][j];
      }
    for (int c = tid; c < H; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < RB; ++r) s += h1[r * HPP + c];
      part[trunk_offset(1, F, H) + c] = s;
    }
  }
}

// The advantage moments of the group path: which 0 the local mean into
// moments[m], which 1 the local variance about moments[m] (the all-reduced
// mean) into moments[S + m].
__global__ void __launch_bounds__(THREADS)
    moments_kernel(const __grid_constant__ Args a, int which) {
  __shared__ float scratch[2 * WARPS];
  const int m = blockIdx.x;
  const float v = adv_moment(a, m, which == 1, which == 1 ? a.moments[m] : 0.f, scratch);
  if (threadIdx.x == 0) a.moments[which * a.S + m] = v;
}

// The element of member m that slot j of thread t in block b of launches 2
// and 3 takes: PER_THREAD elements a thread, each slot coalesced over the
// threads; -> its leaf and its offset in the leaf (leaf -1: none).
__device__ __forceinline__ int element(const Args& a, int b, int j, long long& off) {
  long long e = ((long long)b * PER_THREAD + j) * THREADS + threadIdx.x;
  for (int l = 0; l < LEAVES; ++l) {
    if (e < a.leaves[l].n) {
      off = e;
      return l;
    }
    e -= a.leaves[l].n;
  }
  return -1;
}

// Launch 2: member m's gradient, a block's share of it: with `partials`,
// the sums of the row blocks' partials in a fixed order (and the entropy
// bonus's constant for log_std) into the gradients, and block 0 the row;
// without, the gradients as they are (all-reduced over a group).  Each
// block's sum of squares into normpart[m][b].
__global__ void __launch_bounds__(THREADS) sums_kernel(const __grid_constant__ Args a,
                                                       int partials) {
  __shared__ float scratch[2 * WARPS];
  const int b = blockIdx.x, m = blockIdx.y, tid = threadIdx.x;
  const long long pt = trunk_floats(a.F, a.H);

  if (partials && b == 0 && tid < 32) {
    // the row: warp 0's lanes over the row blocks, then butterflies (a fixed
    // order); policy trunk (pg, clipped, kl), value trunk (v)
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int rb = tid; rb < a.nrb; rb += 32) {
      const float* pi = a.rowpart + ((long long)(m * 2) * a.nrb + rb) * 4;
      const float* vf = a.rowpart + ((long long)(m * 2 + 1) * a.nrb + rb) * 4;
      s[0] += pi[0];
      s[1] += pi[1];
      s[2] += pi[2];
      s[3] += vf[0];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
    if (tid == 0) {
      const float inv_mb = 1.f / (float)a.mb;
      const float pg = -(s[0] * inv_mb), v = s[3] * inv_mb;
      const float ent = a.rowpart[(long long)(m * 2) * a.nrb * 4 + 3];
      const float out[6] = {pg + a.vf_coef * v - a.ent_coef * ent, pg, v, ent, s[1] * inv_mb,
                            s[2] * inv_mb};
      for (int i = 0; i < 6; ++i) a.row[i * a.S + m] = out[i];
    }
  }

  float g[PER_THREAD];
  int leaf[PER_THREAD];
  long long off[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    leaf[j] = element(a, b, j, off[j]);
    g[j] = 0.f;
  }
  if (partials) {
    // the row blocks outermost, so that every slot's loads are in flight
    const float* src[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      src[j] = leaf[j] < 0 ? a.partial
                           : a.partial + (long long)(m * 2 + (leaf[j] < VF ? 0 : 1)) * a.nrb * pt +
                                 trunk_offset(leaf[j], a.F, a.H) + off[j];
      g[j] = src[j][0];
    }
    for (int rb = 1; rb < a.nrb; ++rb)
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) g[j] += src[j][rb * pt];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      if (leaf[j] < 0) g[j] = 0.f;
      if (leaf[j] == LOG_STD) g[j] -= a.ent_coef;  // the entropy bonus: d ent / d log_std = 1
    }
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (leaf[j] >= 0) a.leaves[leaf[j]].grad[m * a.leaves[leaf[j]].n + off[j]] = g[j];
  } else {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (leaf[j] >= 0) g[j] = a.leaves[leaf[j]].grad[m * a.leaves[leaf[j]].n + off[j]];
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) ss += g[j] * g[j];
  const float total = block_sum(ss, scratch);
  if (tid == 0) a.normpart[(long long)m * a.mblocks + b] = total;
}

// Launch 3: member m's norm from its blocks' sums of squares (a fixed
// order, the same in every block), then a block's share of the clip and
// the Adam step.
__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ Args a) {
  __shared__ float norm_sh;
  const int b = blockIdx.x, m = blockIdx.y;
  if (threadIdx.x < 32) {
    // warp 0's lanes over the member's blocks, then butterflies: a fixed
    // order, the same in every block
    float s = 0.f;
    for (int q = threadIdx.x; q < a.mblocks; q += 32) s += a.normpart[(long long)m * a.mblocks + q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) norm_sh = sqrtf(s);
  }
  // every slot's loads first, then its arithmetic and stores
  int leaf[PER_THREAD];
  long long at[PER_THREAD];
  float gr[PER_THREAD], mu[PER_THREAD], nu[PER_THREAD], w[PER_THREAD], t[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    long long off = 0;
    leaf[j] = element(a, b, j, off);
    if (leaf[j] < 0) continue;
    const Leaf& lf = a.leaves[leaf[j]];
    at[j] = m * lf.n + off;
    gr[j] = lf.grad[at[j]];
    mu[j] = lf.exp_avg[at[j]];
    nu[j] = lf.exp_avg_sq[at[j]];
    w[j] = lf.param[at[j]];
    t[j] = *lf.step;
  }
  __syncthreads();
  const float norm = norm_sh;
  const bool clip = !(norm < a.max_norm);
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (leaf[j] < 0) continue;
    const Leaf& lf = a.leaves[leaf[j]];
    float g = gr[j];
    if (clip) g = g / norm * a.max_norm;
    // torch's capturable Adam: step_size = lr / (beta1^t - 1) (negative),
    // denom = (sqrt(v) / sqrt(1 - beta2^t) + eps) / step_size
    const float step_size = 1.f / ((powf(a.beta1, t[j]) - 1.f) / a.lr);
    const float bc2 = sqrtf(-(powf(a.beta2, t[j]) - 1.f));
    const float m1 = mu[j] + a.one_minus_beta1 * (g - mu[j]);
    float v1 = nu[j] * a.beta2;
    v1 = v1 + a.one_minus_beta2 * g * g;
    const float denom = (sqrtf(v1) / bc2 + a.eps) / step_size;
    lf.grad[at[j]] = g;
    lf.exp_avg[at[j]] = m1;
    lf.exp_avg_sq[at[j]] = v1;
    lf.param[at[j]] = w[j] + m1 / denom;
  }
}

template <int HP, int RB>
int launch_grad(const Args& a, cudaStream_t stream) {
  constexpr int bytes = Smem<HP, RB>::BYTES;
  // the shared-memory limit is set once an instantiation and device, at its
  // first launch, so that a launch under a stream capture issues only the
  // kernel; 0: not set yet, else 1 + the cudaError_t of the setting
  static std::atomic<int> configured[MAX_DEVICES];
  int device = 0;
  const cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int c = configured[device].load();
  if (c == 0) {
    c = 1 + (int)cudaFuncSetAttribute(grad_kernel<HP, RB>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    configured[device].store(c);
  }
  if (c != 1) return c - 1;
  grad_kernel<HP, RB><<<dim3(a.nrb, 2, a.S), THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HP>
int launch_width(const Args& a, cudaStream_t stream) {
  if constexpr (HP <= 128) {
    if (a.mb > 64) return launch_grad<HP, 128>(a, stream);
  }
  return launch_grad<HP, 64>(a, stream);
}

bool valid(const Args& a) {
  return a.S >= 1 && a.S <= 65535 && a.F >= 1 && a.F <= KX && a.H >= 8 && a.H <= 256 &&
         a.H % 8 == 0 && a.mb >= 1 && a.nrb >= 1;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  `args` points at an Args on
// the host (the kernels get a copy); every pointer in it is a device
// address.  Each
// launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success).

// The row blocks launch 1 makes for a minibatch of mb rows at width H.
extern "C" int ppo_sgd_row_blocks(int mb, int H) {
  const int rb = ((H + 31) / 32 * 32 <= 128 && mb > 64) ? 128 : 64;
  return (mb + rb - 1) / rb;
}

// Floats of one trunk's partial gradient (see trunk_offset).
extern "C" long long ppo_sgd_trunk_floats(int F, int H) { return trunk_floats(F, H); }

// The blocks a member launches 2 and 3 make: PER_THREAD of its elements (its
// 13 leaves' in order) a thread.
extern "C" int ppo_sgd_member_blocks(int F, int H) {
  const long long n = trunk_floats(F, H) + (long long)F * H + H + (long long)H * H + H + H + 1;
  return (int)((n + THREADS * PER_THREAD - 1) / (THREADS * PER_THREAD));
}

extern "C" int ppo_sgd_args_bytes() { return (int)sizeof(Args); }

extern "C" int ppo_sgd_grad_launch(const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (!valid(*a) || a->nrb != ppo_sgd_row_blocks(a->mb, a->H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((a->H + 31) / 32) {
    case 1: return launch_width<32>(*a, s);
    case 2: return launch_width<64>(*a, s);
    case 3: return launch_width<96>(*a, s);
    case 4: return launch_width<128>(*a, s);
    case 5: return launch_width<160>(*a, s);
    case 6: return launch_width<192>(*a, s);
    case 7: return launch_width<224>(*a, s);
    case 8: return launch_width<256>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ppo_sgd_moments_launch(const void* args, int which, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (!valid(*a) || a->moments == nullptr || which < 0 || which > 1) {
    return (int)cudaErrorInvalidValue;
  }
  moments_kernel<<<a->S, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a, which);
  return (int)cudaGetLastError();
}

extern "C" int ppo_sgd_sums_launch(const void* args, int partials, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (!valid(*a) || a->mblocks != ppo_sgd_member_blocks(a->F, a->H)) {
    return (int)cudaErrorInvalidValue;
  }
  sums_kernel<<<dim3(a->mblocks, a->S), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      *a, partials);
  return (int)cudaGetLastError();
}

extern "C" int ppo_sgd_adam_launch(const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (!valid(*a) || a->mblocks != ppo_sgd_member_blocks(a->F, a->H)) {
    return (int)cudaErrorInvalidValue;
  }
  adam_kernel<<<dim3(a->mblocks, a->S), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
