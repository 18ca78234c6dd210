// Fused actor-critic forward + Gaussian sample for the PPO rollout.
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
// with the standard-normal noise drawn outside, as in the TPU kernel.
//
// Bound on an H100: at B = 4096, H = 128 the products are 80,128 FLOP a row
// (2 trunks x (27x128 + 128x128) multiply-adds + 3 head dot products of 128),
// 328 MFLOP a call, on the float32 CUDA cores (no TF32: the JAX package is
// float32 and parity is held to 1e-5).  The bytes are ~0.7 MB (obs, noise,
// ~160 KB of weights, outputs).  At 67 TFLOP/s and 3.35 TB/s that is 4.9 us
// of arithmetic against 0.2 us of memory traffic: the kernel is bound by
// operations.
//
// Design.  The TPU kernel packs both trunks into one block-diagonal chain
// because its matrix unit pads K=27 and N=2H anyway; here that would double
// the arithmetic (half of the packed W1 is zeros) and the packed W1 (256 KB
// at H=128) would not fit a block's shared memory.  So the two trunks run as
// two H-wide chains side by side in one block of 2H threads, sharing one read
// of each observation row:
//   * a block takes ROWS rows; the rows' inputs and both hidden layers stay in
//     shared memory, never in device memory;
//   * thread t owns hidden unit t % H of trunk t / H and keeps ROWS
//     accumulators in registers, so each weight it loads (coalesced across
//     the warp, served from L1/L2 where the ~160 KB of weights stay resident)
//     feeds ROWS fused multiply-adds, and every activation read from shared
//     memory is a broadcast (float4 along k in the HxH layer);
//   * the three heads are warp dot products with shuffle reductions, and one
//     thread a row writes action, log-prob and value.
// Accumulation is full float32 (fmaf); the epilogue uses round-to-nearest
// intrinsics so that it is not contracted and matches the plain version's
// separate multiply and add.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;  // batch rows per block
constexpr float LOG_2PI = 1.8378770664093453f;

struct Trunk {
  const float* w0;  // (obs_dim, H)
  const float* b0;  // (H,)
  const float* w1;  // (H, H)
  const float* b1;  // (H,)
};

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

template <int H>
__global__ void __launch_bounds__(2 * H) fused_sample_action_kernel(
    const float* __restrict__ obs, int B, int obs_dim, Trunk pi, Trunk vf,
    const float* __restrict__ w_mean, const float* __restrict__ b_mean,
    const float* __restrict__ w_value, const float* __restrict__ b_value,
    const float* __restrict__ log_std, const float* __restrict__ noise,
    float* __restrict__ action, float* __restrict__ logp,
    float* __restrict__ value) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [ROWS][obs_dim]
  float* h0 = xs + pad4(ROWS * obs_dim);        // [ROWS][2H]
  float* h1 = h0 + ROWS * 2 * H;                // [ROWS][2H]
  float* outs = h1 + ROWS * 2 * H;              // [ROWS][3]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, B - row0);

  for (int i = tid; i < ROWS * obs_dim; i += 2 * H) {
    xs[i] = i / obs_dim < rows ? obs[(size_t)row0 * obs_dim + i] : 0.f;
  }
  __syncthreads();

  const int trunk = tid / H;  // 0 = policy, 1 = value; uniform in a warp
  const int j = tid % H;
  const Trunk tr = trunk == 0 ? pi : vf;
  float acc[ROWS];

  // layer 0: (ROWS, obs_dim) x (obs_dim, H)
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int k = 0; k < obs_dim; ++k) {
    const float w = __ldg(tr.w0 + k * H + j);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(xs[r * obs_dim + k], w, acc[r]);
  }
  {
    const float b = __ldg(tr.b0 + j);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) h0[r * 2 * H + trunk * H + j] = tanhf(acc[r] + b);
  }
  __syncthreads();

  // layer 1: (ROWS, H) x (H, H), four k at a time
  const float* hin = h0 + trunk * H;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int k = 0; k < H; k += 4) {
    const float wa = __ldg(tr.w1 + (k + 0) * H + j);
    const float wb = __ldg(tr.w1 + (k + 1) * H + j);
    const float wc = __ldg(tr.w1 + (k + 2) * H + j);
    const float wd = __ldg(tr.w1 + (k + 3) * H + j);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(hin + r * 2 * H + k);
      float a = acc[r];
      a = fmaf(hv.x, wa, a);
      a = fmaf(hv.y, wb, a);
      a = fmaf(hv.z, wc, a);
      a = fmaf(hv.w, wd, a);
      acc[r] = a;
    }
  }
  {
    const float b = __ldg(tr.b1 + j);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) h1[r * 2 * H + trunk * H + j] = tanhf(acc[r] + b);
  }
  __syncthreads();

  // heads: (row, output) pairs, one warp each; outputs 0, 1 = mean, 2 = value
  const int warp = tid / 32, lane = tid % 32;
  for (int p = warp; p < ROWS * 3; p += 2 * H / 32) {
    const int r = p / 3, o = p % 3;
    const float* hrow = h1 + r * 2 * H + (o == 2 ? H : 0);
    float s = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float w = o == 2 ? __ldg(w_value + k) : __ldg(w_mean + k * 2 + o);
      s = fmaf(hrow[k], w, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) outs[r * 3 + o] = s + (o == 2 ? __ldg(b_value) : __ldg(b_mean + o));
  }
  __syncthreads();

  if (tid < rows) {
    const int row = row0 + tid;
    const float ls0 = __ldg(log_std), ls1 = __ldg(log_std + 1);
    const float n0 = noise[2 * row], n1 = noise[2 * row + 1];
    action[2 * row] = __fadd_rn(outs[tid * 3], __fmul_rn(expf(ls0), n0));
    action[2 * row + 1] = __fadd_rn(outs[tid * 3 + 1], __fmul_rn(expf(ls1), n1));
    const float l0 = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(__fmul_rn(n0, n0), LOG_2PI)), ls0);
    const float l1 = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(__fmul_rn(n1, n1), LOG_2PI)), ls1);
    logp[row] = __fadd_rn(l0, l1);
    value[row] = outs[tid * 3 + 2];
  }
}

template <int H>
int launch(const float* obs, int B, int obs_dim, Trunk pi, Trunk vf,
           const float* w_mean, const float* b_mean, const float* w_value,
           const float* b_value, const float* log_std, const float* noise,
           float* action, float* logp, float* value, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (pad4(ROWS * obs_dim) + 4 * ROWS * H + ROWS * 3);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sample_action_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + ROWS - 1) / ROWS);
  fused_sample_action_kernel<H><<<grid, 2 * H, smem, stream>>>(
      obs, B, obs_dim, pi, vf, w_mean, b_mean, w_value, b_value, log_std, noise,
      action, logp, value);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are contiguous
// float32 device arrays; weights are stored (in, out).  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int fused_sample_action_launch(
    const float* obs, int B, int obs_dim, int H,
    const float* pi_w0, const float* pi_b0, const float* pi_w1, const float* pi_b1,
    const float* vf_w0, const float* vf_b0, const float* vf_w1, const float* vf_b1,
    const float* w_mean, const float* b_mean, const float* w_value,
    const float* b_value, const float* log_std, const float* noise,
    float* action, float* logp, float* value, void* stream) {
  if (B <= 0) return 0;
  const Trunk pi{pi_w0, pi_b0, pi_w1, pi_b1};
  const Trunk vf{vf_w0, vf_b0, vf_w1, vf_b1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64:
      return launch<64>(obs, B, obs_dim, pi, vf, w_mean, b_mean, w_value, b_value,
                        log_std, noise, action, logp, value, s);
    case 128:
      return launch<128>(obs, B, obs_dim, pi, vf, w_mean, b_mean, w_value, b_value,
                         log_std, noise, action, logp, value, s);
    case 256:
      return launch<256>(obs, B, obs_dim, pi, vf, w_mean, b_mean, w_value, b_value,
                         log_std, noise, action, logp, value, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
