// The block's strike precompute for Hopper (sm_90a): the impacts' half-sine force curves,
// the acceleration-noise click, the per-impact gain rows and their regroup into the
// (slot, object) form that the resonator kernels read, in one launch.
//
// Replaces no TPU kernel. The JAX package forms the same values with jitted XLA ops
// (mesheditor_tpu/synth/render.py:_impact_force_curves and the click in render_block_impl,
// mesheditor_tpu/synth/pallas_impact.py:_regroup_impacts), which XLA fuses into a few
// device programs. Run eagerly, the port's plain chain (synth/render.py:_impact_force_curves,
// impact_click, impact_gain_rows; synth/strikes.py:_regroup) is some 330 launches a block,
// 256 of them the click's loop over every row of the impact table, and the block waits on
// the host that issues them. This kernel takes the whole chain, at any shape, in one launch.
//
// For every impact-table row i, sample s of the block and mode k (R slots, O objects of the
// bank, the object range [obj_lo, obj_lo + O)):
//
//     a        = age[i] + 1 + s;  live = active[i] && a <= total[i]
//     f(i, s)  = live ? gamma * float(sin(double((pi_f32 * pulse_step) * float(a)))) : 0
//     f(i, -1) = the same at a = age[i], live only when 1 <= age[i] <= total[i]
//     click[s] = sum over active rows in table order of (accel_amp * click_gain) *
//                (f(i, s) - f(i, s - 1)), one rounded add per row, starting from +0
//     slot(i)  = (rank, obj - obj_lo) for an active row whose object lies in the range and
//                whose rank (earlier such rows on the same object) is below R
//     force[s, slot(i)]   = 0 + f(i, s)
//     gain[slot(i), k]    = 0 + ((sx*jx + sz*jz) + sy*jy),  s* = shapes[obj, expos, k, :]
//
// and zero in every other element of force and gain. Every product and sum is written with
// __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts into an FMA, in the plain chain's
// order: PyTorch's CUDA sum(-1) over three terms splits them over two lanes (x and z in one,
// y in the other), hence the gain row's order. "0 +" turns a negative zero into +0, as the
// plain chain's index_add_ into zeros does. Inactive rows are skipped in the click: they add
// (amp * +0) to a sum that starts at +0 and so never becomes -0, which changes no bit.
//
// What bounds it on this card: LATENCY, not bytes or operations. At the play cells' shapes
// (128 table rows, 0-3 live, S = 512, R = 1-2, O = 64, K = 256) the kernel writes 386 KB of
// mostly zeros (0.12 us at 3.35 TB/s) and evaluates a few thousand double-precision sines;
// its time is a launch and one pass of a few dependent steps: about 4.3 us a block on an
// H100 80GB HBM3 at 700 W, where the plain chain issues some 330 launches.
//
// What the design does about it: one launch, no second pass and no atomics.
//  - Every CTA redoes the row ranking (an ordered compaction of the active rows by warp
//    ballots, then a rank count over the compacted rows in shared memory): a few hundred
//    comparisons, cheaper than a second launch.
//  - CTA b owns samples [256b, 256b + 256) of force and click, and a contiguous range of
//    gain; it zero-fills its own ranges, synchronises, then writes its kept slots over them,
//    so no two CTAs touch one element and the wrapper allocates without a memset.
//  - One thread a sample forms that sample's click and kept forces in a loop in registers
//    over the compacted active rows; a sample's value does not depend on where the block
//    starts, so 2S samples equal S then S, bit for bit.
//
// The kernel launches on the caller's stream, allocates nothing, and the C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // samples a CTA owns; threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kGainPerCta = 8192;      // gain elements a CTA owns
constexpr size_t kDefaultSmem = 48 * 1024;  // above this the launch needs an opt-in
constexpr float kPi = 3.14159265358979323846f;  // math.pi rounded to float32, as PyTorch does

// The pulse's force at integer age a (the caller decides whether the row is live there).
__device__ __forceinline__ float pulse_force(float step_pi, float gamma, int a) {
  const float phase = __fmul_rn(step_pi, __int2float_rn(a));
  return __fmul_rn(gamma, __double2float_rn(sin(static_cast<double>(phase))));
}

__device__ __forceinline__ size_t smin(size_t a, size_t b) { return a < b ? a : b; }

// Zero n floats at p with the CTA's threads (16-byte stores where p is aligned).
__device__ __forceinline__ void zero_fill(float* p, size_t n) {
  size_t head = 0;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const size_t n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    for (size_t e = threadIdx.x; e < n4; e += kThreads) p4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    head = n4 * 4;
  }
  for (size_t e = head + threadIdx.x; e < n; e += kThreads) p[e] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
strike_precompute_kernel(const uint8_t* __restrict__ active, const int* __restrict__ obj,
                         const int* __restrict__ expos, const float* __restrict__ j,
                         const float* __restrict__ pulse_step, const float* __restrict__ gamma,
                         const float* __restrict__ accel_amp, const int* __restrict__ age,
                         const int* __restrict__ total, const float* __restrict__ shapes,
                         float* __restrict__ force, float* __restrict__ gain,
                         float* __restrict__ click, int n_imp, int n_obj, int n_points,
                         int n_modes, int n_slots, int n_samples, int obj_lo,
                         float click_gain) {
  extern __shared__ int smem[];
  int* s_row = smem;               // active rows, in table order
  int* s_code = smem + n_imp;      // their bank object, or -1 outside the range
  int* s_slot = smem + 2 * n_imp;  // their slot r * O + o, or -1 when not kept
  __shared__ int s_warp[kWarps];
  __shared__ int s_live;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t slots = static_cast<size_t>(n_slots) * n_obj;

  // This CTA's ranges: samples [s0, s1) of force and click, elements [g0, g1) of gain.
  const int s0 = min(n_samples, static_cast<int>(blockIdx.x) * kThreads);
  const int s1 = min(n_samples, s0 + kThreads);
  const size_t n_gain = slots * n_modes;
  const size_t g0 = smin(n_gain, static_cast<size_t>(blockIdx.x) * kGainPerCta);
  const size_t g1 = smin(n_gain, g0 + kGainPerCta);
  zero_fill(force + static_cast<size_t>(s0) * slots, static_cast<size_t>(s1 - s0) * slots);
  zero_fill(gain + g0, g1 - g0);

  // Ordered compaction of the active rows.
  if (threadIdx.x == 0) s_live = 0;
  __syncthreads();
  for (int base = 0; base < n_imp; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool act = i < n_imp && active[i] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, act);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int at = s_live + __popc(mask & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) at += s_warp[w];
    if (act) {
      const int o = obj[i];
      s_row[at] = i;
      s_code[at] = (o >= obj_lo && o - obj_lo < n_obj) ? o - obj_lo : -1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += s_warp[w];
      s_live += sum;
    }
    __syncthreads();
  }
  const int n_live = s_live;

  // Rank of each active row among the earlier ones on its object: its slot, if kept.
  for (int a = threadIdx.x; a < n_live; a += kThreads) {
    const int code = s_code[a];
    int slot = -1;
    if (code >= 0) {
      int rank = 0;
      for (int b = 0; b < a; ++b) rank += s_code[b] == code;
      if (rank < n_slots) slot = rank * n_obj + code;
    }
    s_slot[a] = slot;
  }
  __syncthreads();  // also orders the zero fill before the writes below

  // One thread a sample: the click and the kept forces.
  const int s = s0 + static_cast<int>(threadIdx.x);
  if (s < s1) {
    float acc = 0.f;
    for (int a = 0; a < n_live; ++a) {
      const int i = s_row[a];
      const float step_pi = __fmul_rn(kPi, __ldg(pulse_step + i));
      const float g = __ldg(gamma + i);
      const int ag = __ldg(age + i);
      const int tot = __ldg(total + i);
      // Ages wrap as PyTorch's int32 adds do.
      const int a_now = static_cast<int>(static_cast<unsigned>(ag) + 1u + static_cast<unsigned>(s));
      const int a_prev = static_cast<int>(static_cast<unsigned>(ag) + static_cast<unsigned>(s));
      const float f = a_now <= tot ? pulse_force(step_pi, g, a_now) : 0.f;
      const bool prev_live = a_prev <= tot && (s > 0 || a_prev >= 1);
      const float fp = prev_live ? pulse_force(step_pi, g, a_prev) : 0.f;
      const float amp = __fmul_rn(__ldg(accel_amp + i), click_gain);
      acc = __fadd_rn(acc, __fmul_rn(amp, __fsub_rn(f, fp)));
      const int slot = s_slot[a];
      if (slot >= 0) force[static_cast<size_t>(s) * slots + slot] = __fadd_rn(0.f, f);
    }
    click[s] = acc;
  }

  // The kept slots' gain rows that fall in this CTA's range.
  for (int a = 0; a < n_live; ++a) {
    const int slot = s_slot[a];
    if (slot < 0) continue;
    const size_t row0 = static_cast<size_t>(slot) * n_modes;
    const size_t lo = g0 > row0 ? g0 : row0;
    const size_t hi = smin(g1, row0 + n_modes);
    if (lo >= hi) continue;
    const int i = s_row[a];
    const float jx = __ldg(j + 3 * i), jy = __ldg(j + 3 * i + 1), jz = __ldg(j + 3 * i + 2);
    const float* sh = shapes + (static_cast<size_t>(s_code[a]) * n_points + __ldg(expos + i)) *
                                   n_modes * 3;
    for (size_t e = lo + threadIdx.x; e < hi; e += kThreads) {
      const float* v = sh + (e - row0) * 3;
      const float xz = __fadd_rn(__fmul_rn(v[0], jx), __fmul_rn(v[2], jz));
      gain[e] = __fadd_rn(0.f, __fadd_rn(xz, __fmul_rn(v[1], jy)));
    }
  }
}

}  // namespace

extern "C" {

// The strike precompute of one block. Shapes (C-contiguous): active (I,) uint8 (bool);
// obj, expos, age, total (I,) int32; j (I,3), pulse_step, gamma, accel_amp (I,) float32;
// shapes (O,P,K,3) float32, the bank's objects [obj_lo, obj_lo + O); outputs force (S,R,O),
// gain (R,O,K), click (S,) float32, each written whole. Returns a cudaError_t.
int strike_precompute(const uint8_t* active, const int* obj, const int* expos, const float* j,
                      const float* pulse_step, const float* gamma, const float* accel_amp,
                      const int* age, const int* total, const float* shapes, float* force,
                      float* gain, float* click, int n_imp, int n_obj, int n_points,
                      int n_modes, int n_slots, int n_samples, int obj_lo, float click_gain,
                      void* stream) {
  if (n_imp < 0 || n_obj <= 0 || n_points <= 0 || n_modes <= 0 || n_slots < 0 ||
      n_samples < 0) {
    return cudaErrorInvalidValue;
  }
  const size_t n_gain = static_cast<size_t>(n_slots) * n_obj * n_modes;
  const size_t sample_ctas = (static_cast<size_t>(n_samples) + kThreads - 1) / kThreads;
  const size_t gain_ctas = (n_gain + kGainPerCta - 1) / kGainPerCta;
  size_t blocks = sample_ctas > gain_ctas ? sample_ctas : gain_ctas;
  if (blocks == 0) blocks = 1;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t bytes = 3 * sizeof(int) * static_cast<size_t>(n_imp);
  if (bytes > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        strike_precompute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  strike_precompute_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      active, obj, expos, j, pulse_step, gamma, accel_amp, age, total, shapes, force, gain,
      click, n_imp, n_obj, n_points, n_modes, n_slots, n_samples, obj_lo, click_gain);
  return cudaGetLastError();
}

}  // extern "C"
