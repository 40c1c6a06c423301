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
// What bounds it on this card: LATENCY. Each (o,k) lane is an independent sample-serial
// recurrence: three dependent float operations a sample (~12 cycles). At the bench shape
// (64 objects x 256 modes) there are 16,384 lanes, one warp per scheduler of 128 SMs, so
// nothing hides a stall in a lane's in-order stream. The recurrence itself is the floor of
// this design; a time-parallel scan would go below it but changes the state's rounding.
//
// What the design does about it: only the 3-operation recurrence stays on the per-sample
// chain, and nothing else stalls the lane's in-order stream.
//  - one thread owns one lane and keeps z, c, and its first gain rows in registers for the
//    whole call;
//  - samples go in runs of 32, fully unrolled: the run's excitations (which do not depend
//    on z) are formed first, then the 32 updates follow back to back;
//  - the mix leaves the chain: each lane stores out_gain * Im z of every sample of the run
//    into its warp's slice of shared memory; at the run's end lane t sums sample t's 32
//    values in a fixed pairwise order over the lanes and writes one partial per (warp,
//    sample); a second kernel sums each sample's partials in a fixed order (row groups in
//    parallel, then the groups). No float atomics, and a sample's sum order does not depend
//    on where a run or a call starts, so rendering 2S samples equals rendering S then S,
//    bit for bit;
//  - the force rows of a block's objects are staged into shared memory a run of samples at a
//    time, double-buffered with cp.async: the next run lands while the current one is read.
//
// The kernels launch on the caller's stream, allocate nothing, and the C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kRegSlots = 4;   // gain rows held in registers; further slots read global memory
constexpr int kMaxRun = 256;   // samples of force rows staged per pass
constexpr int kMixRun = 32;    // samples a warp stashes before it reduces their mix
constexpr int kStashRow = 33;  // floats per stashed sample (32 lanes + 1: no bank conflicts)
constexpr int kThreads = 128;  // lanes per block (64, 128 and 256 measured; 128 fastest)
constexpr int kMixGroups = 8;     // row groups the mix kernel sums in parallel
constexpr size_t kStageBudget = 24 * 1024;   // bytes of the two staged force buffers
constexpr size_t kDefaultSmem = 48 * 1024;   // above this the launch needs an opt-in

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Objects a block's lanes can span (lanes are object-major, o * n_modes + k).
inline int max_obj_span(int threads, int n_modes) { return (threads - 1) / n_modes + 2; }

struct Plan {
  int blocks, warps, run;
  size_t bytes;
};

bool make_plan(int n_obj, int n_modes, int n_slots, Plan* p) {
  if (n_obj <= 0 || n_modes <= 0 || n_slots < 0) return false;
  const int lanes = n_obj * n_modes;
  p->blocks = (lanes + kThreads - 1) / kThreads;
  p->warps = kThreads / 32;
  const size_t per_sample = (size_t)n_slots * max_obj_span(kThreads, n_modes) * sizeof(float);
  p->run = kMaxRun;
  if (per_sample > 0) {
    const size_t fit = kStageBudget / (2 * per_sample);
    if (fit == 0) return false;
    p->run = fit < (size_t)kMaxRun ? (int)fit : kMaxRun;
    if (p->run > kMixRun) p->run -= p->run % kMixRun;  // whole runs of 32 per staged pass
  }
  p->bytes = (size_t)p->warps * kMixRun * kStashRow * sizeof(float) + 2 * p->run * per_sample;
  return true;
}

// sum of v[lo..lo+n) as a fixed pairwise tree
template <int LO, int N>
struct Tree {
  static __device__ __forceinline__ float sum(const float* v) {
    return __fadd_rn(Tree<LO, N / 2>::sum(v), Tree<LO + N / 2, N - N / 2>::sum(v));
  }
};
template <int LO>
struct Tree<LO, 1> {
  static __device__ __forceinline__ float sum(const float* v) { return v[LO]; }
};

__global__ void __launch_bounds__(kThreads)
resonate_kernel(const float* __restrict__ coeff_re, const float* __restrict__ coeff_im,
                const float* __restrict__ out_gain, const float* __restrict__ gain,
                const float* __restrict__ force, const float* __restrict__ z0_re,
                const float* __restrict__ z0_im, float* __restrict__ z_re,
                float* __restrict__ z_im, float* __restrict__ partials, int n_obj,
                int n_modes, int n_slots, int n_samples, int run) {
  extern __shared__ float smem[];
  const int nthreads = kThreads;
  const int nwarps = kThreads >> 5;
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  const int lanes = n_obj * n_modes;
  const int block_first = blockIdx.x * nthreads;
  const int lane = block_first + threadIdx.x;
  const bool live = lane < lanes;
  const int first_obj = block_first / n_modes;
  const int last_lane = min(lanes, block_first + nthreads) - 1;
  const int obj_span = last_lane / n_modes - first_obj + 1;
  const int stage = n_slots * obj_span;  // staged floats per sample
  const int local_o = live ? lane / n_modes - first_obj : 0;

  float* stash = smem + (size_t)warp * kMixRun * kStashRow;  // [kMixRun][kStashRow]
  float* f_buf = smem + (size_t)nwarps * kMixRun * kStashRow;  // [2][run][n_slots][obj_span]

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
  float* part_row = partials + (size_t)(blockIdx.x * nwarps + warp) * n_samples;

  // Lane u < n sums sample u of the run over the warp's 32 lanes (fixed pairwise order).
  auto flush = [&](int s_first, int n) {
    __syncwarp();
    if (wl < n) {
      float row[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) row[j] = stash[wl * kStashRow + j];
      part_row[s_first + wl] = Tree<0, 32>::sum(row);
    }
    __syncwarp();  // the stash is read before the next run writes it
  };
  auto stage_run = [&](int s0, float* buf) {
    const int len = min(run, n_samples - s0);
    for (int idx = threadIdx.x; idx < len * stage; idx += nthreads) {
      const int t = idx / stage;
      const int rem = idx - t * stage;
      const int r = rem / obj_span;
      const int j = rem - r * obj_span;
      cp_async4(buf + idx, force + ((size_t)(s0 + t) * n_slots + r) * n_obj + first_obj + j);
    }
    cp_async_commit();
  };
  // slot r's gain for this lane: the first rows from registers, the rest from global memory
  auto slot_gain = [&](int r) {
    float gr = greg[0];
#pragma unroll
    for (int q = 1; q < kRegSlots; ++q) gr = r == q ? greg[q] : gr;
    return r < kRegSlots ? gr : (live ? gain[(size_t)r * lanes + lane] : 0.f);
  };

  if (n_samples > 0) stage_run(0, f_buf);
  for (int s0 = 0, b = 0; s0 < n_samples; s0 += run, b ^= 1) {
    const int len = min(run, n_samples - s0);
    cp_async_wait_all();
    __syncthreads();  // this run's rows have landed; the other buffer is no longer read
    if (s0 + run < n_samples) stage_run(s0 + run, f_buf + (size_t)(b ^ 1) * run * stage);
    const float* fr = f_buf + (size_t)b * run * stage + local_o;
    for (int c = 0; c < len; c += kMixRun) {
      const float* f = fr + c * stage;
      const int n = min(kMixRun, len - c);
      if (n == kMixRun) {
        // excite[u] = sum_r f[u, r] * gain[r], slot order, for the whole run first
        float e[kMixRun];
#pragma unroll
        for (int u = 0; u < kMixRun; ++u) e[u] = 0.f;
        for (int r = 0; r < n_slots; ++r) {
          const float gr = slot_gain(r);
#pragma unroll
          for (int u = 0; u < kMixRun; ++u) {
            e[u] = __fadd_rn(e[u], __fmul_rn(f[u * stage + r * obj_span], gr));
          }
        }
#pragma unroll
        for (int u = 0; u < kMixRun; ++u) {
          const float nr = __fadd_rn(__fsub_rn(__fmul_rn(zr, cr), __fmul_rn(zi, ci)), e[u]);
          const float ni = __fadd_rn(__fmul_rn(zr, ci), __fmul_rn(zi, cr));
          zr = nr;
          zi = ni;
          stash[u * kStashRow + wl] = __fmul_rn(g, ni);
        }
      } else {  // the call's last, shorter run: the same operations, one sample at a time
        for (int u = 0; u < n; ++u) {
          float e = 0.f;
          for (int r = 0; r < n_slots; ++r) {
            e = __fadd_rn(e, __fmul_rn(f[u * stage + r * obj_span], slot_gain(r)));
          }
          const float nr = __fadd_rn(__fsub_rn(__fmul_rn(zr, cr), __fmul_rn(zi, ci)), e);
          const float ni = __fadd_rn(__fmul_rn(zr, ci), __fmul_rn(zi, cr));
          zr = nr;
          zi = ni;
          stash[u * kStashRow + wl] = __fmul_rn(g, ni);
        }
      }
      flush(s0 + c, n);
    }
  }
  if (live) {
    z_re[lane] = zr;
    z_im[lane] = zi;
  }
}

// mix[s] = sum of partials[w, s] over the n_partials rows: kMixGroups contiguous groups of
// rows, each summed in row order by one warp (lane = sample), then the groups in order.
__global__ void __launch_bounds__(kMixGroups * 32)
mix_kernel(const float* __restrict__ partials, int n_partials, int n_samples,
           float* __restrict__ mix) {
  __shared__ float group_sum[kMixGroups][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * 32 + lane;
  const int per = (n_partials + kMixGroups - 1) / kMixGroups;
  const int r1 = min(n_partials, (w + 1) * per);
  float acc = 0.f;
  if (s < n_samples) {
    for (int r = w * per; r < r1; ++r) acc = __fadd_rn(acc, partials[(size_t)r * n_samples + s]);
  }
  group_sum[w][lane] = acc;
  __syncthreads();
  if (w == 0 && s < n_samples) {
    float m = group_sum[0][lane];
#pragma unroll
    for (int q = 1; q < kMixGroups; ++q) m = __fadd_rn(m, group_sum[q][lane]);
    mix[s] = m;
  }
}

}  // namespace

extern "C" {

// Rows of the partials scratch the caller allocates: (impact_resonator_partials, n_samples).
// Returns -1 when the shapes do not fit.
int impact_resonator_partials(int n_obj, int n_modes) {
  Plan p;
  if (!make_plan(n_obj, n_modes, 0, &p)) return -1;
  return p.blocks * p.warps;
}

// Advance the (n_obj, n_modes) resonator grid n_samples samples from (z0_re, z0_im) into
// (z_re, z_im) and write the per-sample mix. Shapes (all float32, C-contiguous):
// coeff_re/coeff_im/z0_*/z_* (O,K); out_gain (O,); gain (R,O,K); force (S,R,O); partials
// (impact_resonator_partials(O,K), S); mix (S,). Returns a cudaError_t.
int impact_resonator(const float* coeff_re, const float* coeff_im, const float* out_gain,
                     const float* gain, const float* force, const float* z0_re,
                     const float* z0_im, float* z_re, float* z_im, float* partials,
                     float* mix, int n_obj, int n_modes, int n_slots, int n_samples,
                     void* stream) {
  Plan p;
  if (n_samples < 0 || !make_plan(n_obj, n_modes, n_slots, &p)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.bytes > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        resonate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
    if (err != cudaSuccess) return err;
  }
  resonate_kernel<<<p.blocks, kThreads, p.bytes, st>>>(
      coeff_re, coeff_im, out_gain, gain, force, z0_re, z0_im, z_re, z_im, partials, n_obj,
      n_modes, n_slots, n_samples, p.run);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_samples > 0) {
    mix_kernel<<<(n_samples + 31) / 32, kMixGroups * 32, 0, st>>>(partials, p.blocks * p.warps,
                                                                n_samples, mix);
  }
  return cudaGetLastError();
}

}  // extern "C"
