// Impact-path modal resonator advance for Hopper (sm_90a).
//
// Replaces: mesheditor_tpu/synth/pallas_impact.py:_kernel, the Pallas TPU kernel launched by
// render_block_impacts_pallas. Same function over a whole render call: for every sample s,
//
//     excite[o,k] = sum_r force[s,r,o] * gain[r,o,k]        (r in slot order)
//     z[o,k]     <- z[o,k] * c[o,k] + excite[o,k]           (split re/im)
//     mix[s]      = sum_o sum_k out_gain[o] * Im z[o,k]
//
// with exact, separately rounded float32 multiplies and adds: every product and sum is
// written with __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts into an FMA, so the
// state matches the plain PyTorch version (synth/impact.py:_resonate_plain) bit for bit.
//
// What bounds it on this card: each (o,k) lane is an independent sample-serial recurrence of
// about R+6 float ops per sample, so the kernel is LATENCY-bound, not bandwidth- or
// FLOP-bound: at the bench shape (64 objects x 256 modes) there are 16,384 lanes, fewer than
// one per H100 core, and every sample waits on the previous one.
//
// What the design does about it:
//  - one thread owns one lane and keeps z, c, and its first gain rows in registers for the
//    whole call: the TPU kernel's sequential 256-sample grid existed only to carry state in
//    VMEM, and here the sample loop simply runs inside the thread;
//  - a block stages its objects' force rows for a run of samples in shared memory, so the
//    per-sample force read is a shared-memory broadcast;
//  - the per-sample mix is reduced in a FIXED order with no float atomics: a warp-shuffle
//    tree gives one partial per (warp, sample), and a second kernel sums each sample's
//    partials in warp order. The result is deterministic and independent of how a stretch
//    of samples is cut into calls (rendering 2S samples equals rendering S then S, bit for
//    bit).
//
// The kernel launches on the caller's stream, allocates nothing, and the C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 128;  // lanes per block
constexpr int kWarps = kThreads / 32;
constexpr int kRegSlots = 4;  // gain rows held in registers; further slots read global memory
constexpr int kMaxRun = 256;  // samples of force rows staged per pass
constexpr size_t kSmemBudget = 48 * 1024;

// Objects a block's lanes can span (lanes are object-major, o * n_modes + k).
__host__ __device__ inline int max_obj_span(int n_modes) {
  return (kThreads - 1) / n_modes + 2;
}

__global__ void __launch_bounds__(kThreads)
resonate_kernel(const float* __restrict__ coeff_re, const float* __restrict__ coeff_im,
                const float* __restrict__ out_gain, const float* __restrict__ gain,
                const float* __restrict__ force, const float* __restrict__ z0_re,
                const float* __restrict__ z0_im, float* __restrict__ z_re,
                float* __restrict__ z_im, float* __restrict__ partials, int n_obj,
                int n_modes, int n_slots, int n_samples, int run) {
  extern __shared__ float f_run[];  // [run][n_slots][obj_span]
  const int lanes = n_obj * n_modes;
  const int block_first = blockIdx.x * kThreads;
  const int lane = block_first + threadIdx.x;
  const bool live = lane < lanes;
  const int first_obj = block_first / n_modes;
  const int last_lane = min(lanes, block_first + kThreads) - 1;
  const int obj_span = last_lane / n_modes - first_obj + 1;
  const int stage = n_slots * obj_span;  // staged floats per sample
  const int local_o = live ? lane / n_modes - first_obj : 0;

  float cr = 0.f, ci = 0.f, g = 0.f, zr = 0.f, zi = 0.f;
  float greg[kRegSlots] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    cr = coeff_re[lane];
    ci = coeff_im[lane];
    g = out_gain[lane / n_modes];
    zr = z0_re[lane];
    zi = z0_im[lane];
#pragma unroll
    for (int r = 0; r < kRegSlots; ++r) {
      if (r < n_slots) greg[r] = gain[(size_t)r * lanes + lane];
    }
  }
  const int warp_global = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool writer = (threadIdx.x & 31) == 0;

  for (int s0 = 0; s0 < n_samples; s0 += run) {
    const int len = min(run, n_samples - s0);
    __syncthreads();  // the previous run's staged rows are no longer read
    for (int idx = threadIdx.x; idx < len * stage; idx += kThreads) {
      const int t = idx / stage;
      const int rem = idx - t * stage;
      const int r = rem / obj_span;
      const int j = rem - r * obj_span;
      f_run[idx] = force[((size_t)(s0 + t) * n_slots + r) * n_obj + first_obj + j];
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float* f = f_run + t * stage + local_o;
      float e = 0.f;
#pragma unroll
      for (int r = 0; r < kRegSlots; ++r) {
        if (r < n_slots) e = __fadd_rn(e, __fmul_rn(f[r * obj_span], greg[r]));
      }
      for (int r = kRegSlots; r < n_slots; ++r) {
        const float gr = live ? gain[(size_t)r * lanes + lane] : 0.f;
        e = __fadd_rn(e, __fmul_rn(f[r * obj_span], gr));
      }
      const float nr = __fadd_rn(__fsub_rn(__fmul_rn(zr, cr), __fmul_rn(zi, ci)), e);
      const float ni = __fadd_rn(__fmul_rn(zr, ci), __fmul_rn(zi, cr));
      zr = nr;
      zi = ni;
      float v = live ? __fmul_rn(g, ni) : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      }
      if (writer) partials[(size_t)warp_global * n_samples + s0 + t] = v;
    }
  }
  if (live) {
    z_re[lane] = zr;
    z_im[lane] = zi;
  }
}

// mix[s] = sum over partial rows w = 0..n_partials-1 of partials[w, s], in row order.
__global__ void mix_kernel(const float* __restrict__ partials, int n_partials, int n_samples,
                           float* __restrict__ mix) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_samples) return;
  float acc = 0.f;
  for (int w = 0; w < n_partials; ++w) {
    acc = __fadd_rn(acc, partials[(size_t)w * n_samples + s]);
  }
  mix[s] = acc;
}

}  // namespace

extern "C" {

// Rows of the partials scratch the caller allocates: (impact_resonator_partials, n_samples).
int impact_resonator_partials(int n_obj, int n_modes) {
  const int lanes = n_obj * n_modes;
  return (lanes + kThreads - 1) / kThreads * kWarps;
}

// Advance the (n_obj, n_modes) resonator grid n_samples samples from (z0_re, z0_im) into
// (z_re, z_im) and write the per-sample mix. Shapes (all float32, C-contiguous):
// coeff_re/coeff_im/z0_*/z_* (O,K); out_gain (O,); gain (R,O,K); force (S,R,O);
// partials (impact_resonator_partials(O,K), S); mix (S,). Returns a cudaError_t.
int impact_resonator(const float* coeff_re, const float* coeff_im, const float* out_gain,
                     const float* gain, const float* force, const float* z0_re,
                     const float* z0_im, float* z_re, float* z_im, float* partials,
                     float* mix, int n_obj, int n_modes, int n_slots, int n_samples,
                     void* stream) {
  if (n_obj <= 0 || n_modes <= 0 || n_slots < 0 || n_samples < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lanes = n_obj * n_modes;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  const size_t per_sample = (size_t)n_slots * max_obj_span(n_modes) * sizeof(float);
  int run = kMaxRun;
  if (per_sample > 0) {
    const size_t fit = kSmemBudget / per_sample;
    if (fit == 0) return cudaErrorInvalidValue;
    run = fit < (size_t)kMaxRun ? (int)fit : kMaxRun;
  }
  resonate_kernel<<<blocks, kThreads, run * per_sample, st>>>(
      coeff_re, coeff_im, out_gain, gain, force, z0_re, z0_im, z_re, z_im, partials, n_obj,
      n_modes, n_slots, n_samples, run);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_samples > 0) {
    mix_kernel<<<(n_samples + 255) / 256, 256, 0, st>>>(partials, blocks * kWarps, n_samples,
                                                       mix);
  }
  return cudaGetLastError();
}

}  // extern "C"
