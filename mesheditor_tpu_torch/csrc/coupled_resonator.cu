// Coupled (sustained-voice + impact) modal resonator advance for Hopper (sm_90a).
//
// Replaces: mesheditor_tpu/synth/pallas_coupled.py:_make_kernel, the Pallas TPU kernel
// launched by render_block_coupled_pallas. Same function over a whole render call: for every
// sample s, in this order,
//
//   1. each voice v reads its object's Im z row from the previous sample:
//        defl[v] = sum_k read[v,k] * z_im[obj[v],k]
//   2. the contact model steps (Hunt-Crossley with the tanh knee against the load):
//        rm  += (relief[s,v] - rm) * alpha;   rigid = sp + (relief - rm)
//        sep  = max(rigid - defl, 0);         rate  = (sep - pen) * sr
//        force = max(stiff * sep * sqrt(sep) * (1 + damp * rate), 0)
//        normal = force - nf  (-> nf * tanh(normal / nf) when normal > 0 and nf > 0)
//        load = nf + normal;  pen = sep
//   3. the shared resonator update with the factored impact excitation:
//        new_re = zr*cr - zi*ci + sum_r f[s,r,o] * gain[r,o,k];   new_im = zr*ci + zi*cr
//   4. each voice's drive normal*gnf + (load*slope0)*geo0 + (load*slope1)*geo1 is added into
//      its object's new_re, in voice-table order, after the shared update;
//   5. mix[s] = sum_o sum_k out_gain[o] * new_im[o,k].
//
// Every product and sum is written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn and the root
// with __fsqrt_rn, which nvcc never contracts or approximates: a contact at rest computes
// k * delta0^(3/2) == N exactly and stays exactly silent, as the plain PyTorch version
// (synth/coupled.py:_resonate_coupled_plain) does. Only tanhf (the knee, which fires only
// above the load) and the order of the deflection and mix sums differ from the plain version.
//
// What bounds it on this card: LATENCY. Each sample depends on the one before through the
// deflection read, so the loop over samples is sequential; at the main path's shape (64
// objects x 256 modes, one voice on each of 16 objects) a few thousand flops a sample are
// spread over 64 objects, and a voiced object's sample is a chain of a reduction over its
// modes, a scalar contact step and a broadcast of the drive.
//
// What the design does about it. Voices on different objects never interact, so each object
// advances alone, with no grid-wide sync, on one of two paths chosen per launch from the
// shapes (coupled_resonator_plan):
//  - WARP PATH (K <= 256, at most four voices and two impacts per object): ONE WARP PER
//    OBJECT, one object-warp per CTA (1, 2 and 4 measured the same). Lane l owns modes
//    l, l+32, ... (M = ceil(K/32) of them) and keeps z, c, the impact gain rows and every
//    voice's four gain rows for its modes in registers (up to 8 x 4 x 4 floats of gain
//    rows, 255 registers without a spill), so a sample's work is straight-line code on
//    registers. A
//    deflection is a per-lane partial over the lane's modes (fixed pairwise order) and a
//    butterfly shuffle; voice j's contact math runs on lane j and __shfl_sync broadcasts
//    its drive; an object without a voice skips all of that. The sample loop has no block
//    barrier, only warp-synchronous steps.
//  - BLOCK PATH (K up to 1,024, or more voices or impacts on an object): ONE CTA PER OBJECT,
//    thread k owns mode k; gain rows of the first voices in registers, then shared memory,
//    then global memory (L1/L2). One block barrier a sample, with the deflection partials
//    and the drives double-buffered in shared memory; an object with no voice has none.
//  On both paths the deflection of sample s+1 is reduced ONE SAMPLE AHEAD: Im z after sample
//  s does not depend on sample s's drive, so its reduction is issued before the contact
//  step of sample s runs, and the chain from one deflection to the next spans two samples.
//  The schedule changes, not the operations.
//  - A separated contact (zero separation) skips the square root, whose zero input would
//    take __fsqrt_rn's slow path on every sample; on the warp path the butterfly's levels
//    are issued between the contact step's stages (contact_step's hook).
//  - The mix is off the chain: each lane stashes out_gain * Im z (summed over its modes) for
//    a run of 32 samples in its warp's slice of shared memory; at the run's end lane t sums
//    sample t over the warp's 32 lanes in lane order (the block path then over its warps in
//    warp order) into one partial per (object, sample), and a second kernel sums each
//    sample's partials in object order. No float atomics; a sample's sum order does not
//    depend on where a run or a call starts, so rendering 2S samples equals S then S, bit for
//    bit.
//  - Each object-warp (block path: warp 0 of the CTA) finds its own voices by scanning the
//    voice table's object column in table order with a ballot and popcount compaction, and
//    keeps the first nv_cap: the set and order the wrapper's plain version groups.
//  - Relief, slopes and impact forces are staged into shared memory a run of samples at a
//    time (warp path: 32 samples per warp, double-buffered with cp.async).
//
// The kernels launch on the caller's stream, allocate nothing, and the C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kMaxThreads = 1024;   // block path: modes per object (one thread each)
constexpr int kWarpMaxModes = 8;    // warp path: modes a lane holds (K <= 256)
constexpr int kWarpRegSlots = 2;    // warp path: impact slots per object (rows in registers)
constexpr int kRegSlots = 4;        // block path: impact gain rows held in registers
constexpr int kRegVoices = 4;       // block path: voices whose gain rows are in registers
constexpr int kMaxRun = 256;        // block path: samples staged per pass
constexpr int kMixRun = 32;         // samples a warp stashes before it reduces their mix
constexpr int kStashRow = 33;       // floats per stashed sample (32 lanes + 1: no conflicts)
constexpr int kStash = kMixRun * kStashRow;    // floats of one warp's mix stash
constexpr size_t kStageBudget = 32 * 1024;     // block path: bytes of staged rows
constexpr size_t kGainBudget = 160 * 1024;     // block path: bytes of shared gain rows
constexpr size_t kSmemLimit = 227 * 1024;      // shared memory one block can opt into
constexpr size_t kDefaultSmem = 48 * 1024;     // above this the launch needs an opt-in
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  return v;  // valid in lane 0
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

// normal*g0 + (load*slope0)*g1 + (load*slope1)*g2, left to right
__device__ __forceinline__ float drive(float dn, float d0, float d1, float g0, float g1,
                                       float g2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dn, g0), __fmul_rn(d0, g1)), __fmul_rn(d1, g2));
}

// One contact step. c = (sp, stiff, damp, nf, alpha, sr); carries rm, pen; returns the
// normal force and the two load * slope terms of the drive. between(0) .. between(4) run
// between its stages: the warp path issues there the levels of the next deflection's
// butterfly, so the two dependency chains interleave in the warp's in-order stream.
template <class Between>
__device__ __forceinline__ void contact_step(const float* c, float defl, float relief,
                                             float slope0, float slope1, float& rm, float& pen,
                                             float& normal, float& d0, float& d1,
                                             Between between) {
  between(0);
  rm = __fadd_rn(rm, __fmul_rn(__fsub_rn(relief, rm), c[4]));
  const float rigid = __fadd_rn(c[0], __fsub_rn(relief, rm));
  const float sep = fmaxf(__fsub_rn(rigid, defl), 0.f);
  between(1);
  // sqrt(+0) is +0: a separated contact skips __fsqrt_rn, whose zero input takes its slow
  // path.
  float root = 0.f;
  if (sep > 0.f) root = __fsqrt_rn(sep);
  const float rate = __fmul_rn(__fsub_rn(sep, pen), c[5]);
  between(2);
  const float f = __fmul_rn(__fmul_rn(__fmul_rn(c[1], sep), root),
                            __fadd_rn(1.f, __fmul_rn(c[2], rate)));
  const float nf = c[3];
  normal = __fsub_rn(fmaxf(f, 0.f), nf);
  between(3);
  if (normal > 0.f && nf > 0.f) normal = __fmul_rn(nf, tanhf(__fdiv_rn(normal, nf)));
  between(4);
  const float load = __fadd_rn(nf, normal);
  pen = sep;
  d0 = __fmul_rn(load, slope0);
  d1 = __fmul_rn(load, slope1);
}

// Lane u < n of a warp sums sample u of its stash over the 32 lanes (fixed pairwise order).
__device__ __forceinline__ float stash_sum(const float* stash, int u) {
  float row[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) row[j] = stash[u * kStashRow + j];
  return Tree<0, 32>::sum(row);
}

// The first `cap` voices of object o in table order (v_obj[v] == o), found by one warp with
// a ballot and popcount compaction: store(rank, v) runs on the lane that found voice v.
// Returns how many were kept.
template <class Store>
__device__ __forceinline__ int scan_voices(const int* __restrict__ v_obj, int n_voice, int o,
                                           int cap, int lane, Store store) {
  int count = 0;
  for (int base = 0; base < n_voice && count < cap; base += 32) {
    const int v = base + lane;
    const bool hit = v < n_voice && v_obj[v] == o;
    const unsigned mask = __ballot_sync(kFull, hit);
    const int rank = count + __popc(mask & ((1u << lane) - 1u));
    if (hit && rank < cap) store(rank, v);
    count += __popc(mask);
  }
  return min(count, cap);
}

struct Args {
  const float *coeff_re, *coeff_im, *out_gain, *gains4, *consts, *vx, *force, *gain_rok;
  const float *z0_re, *z0_im, *rm0, *pen0;
  const int* v_obj;
  float *z_re, *z_im, *rm_out, *pen_out, *partials;
  int n_obj, n_modes, n_voice, n_slots, n_samples, nv_cap;
};

// ------------------------------------------------------------------------------------------
// Warp path: one warp per object, M modes a lane, at most NV voices (all in registers).

// Floats of one object-warp's shared-memory slice: mix stash, two staged runs of 32
// samples (n_slots forces, then relief, slope0, slope1 of each voice), voice ids.
__host__ __device__ inline size_t warp_slice_floats(int n_slots, int nv) {
  return (size_t)kStash + 2 * kMixRun * (n_slots + 3 * nv) + nv;
}

template <int M, int NV>
__global__ void __launch_bounds__(32)
coupled_warp_kernel(const Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int o = blockIdx.x;
  const int K = a.n_modes, V = a.n_voice, R = a.n_slots, S = a.n_samples;
  const int per = R + 3 * NV;  // staged floats a sample
  float* stash = smem;
  float* stage = stash + kStash;  // [2][kMixRun][per]
  int* s_vid = reinterpret_cast<int*>(stage + 2 * kMixRun * per);

  const int nv = scan_voices(a.v_obj, V, o, min(a.nv_cap, NV), lane,
                             [&](int r, int v) { s_vid[r] = v; });
  __syncwarp();
  int vid[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) vid[j] = j < nv ? s_vid[j] : 0;

  // Voice j's carries and constants live on lane j.
  const bool owner = lane < nv;
  const int jl = owner ? lane : 0;
  const int my_v = owner ? s_vid[lane] : 0;
  float c[6], rm = 0.f, pen = 0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) c[q] = owner ? a.consts[(size_t)q * V + my_v] : 0.f;
  if (owner) {
    rm = a.rm0[my_v];
    pen = a.pen0[my_v];
  }

  float zr[M], zi[M], cr[M], ci[M], gimp[kWarpRegSlots][M], gv[NV][4][M];
  const float g = a.out_gain[o];
  const size_t lanes = (size_t)a.n_obj * K;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int m = i * 32 + lane;
    const bool live = m < K;
    const size_t li = (size_t)o * K + m;
    cr[i] = live ? a.coeff_re[li] : 0.f;
    ci[i] = live ? a.coeff_im[li] : 0.f;
    zr[i] = live ? a.z0_re[li] : 0.f;
    zi[i] = live ? a.z0_im[li] : 0.f;
#pragma unroll
    for (int r = 0; r < kWarpRegSlots; ++r) {
      gimp[r][i] = (live && r < R) ? a.gain_rok[(size_t)r * lanes + li] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gv[j][q][i] = (live && j < nv) ? a.gains4[((size_t)q * V + vid[j]) * K + m] : 0.f;
      }
    }
  }

  // Lane t stages sample s0 + t of a run: the object's forces, then its voices' rows.
  auto stage_run = [&](int s0, float* buf) {
    const int s = s0 + lane;
    if (s < S) {
      float* row = buf + lane * per;
      for (int r = 0; r < R; ++r) cp_async4(row + r, a.force + ((size_t)s * R + r) * a.n_obj + o);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (j < nv) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            cp_async4(row + R + q * NV + j, a.vx + ((size_t)s * 3 + q) * V + vid[j]);
          }
        }
      }
    }
    cp_async_commit();
  };

  // Voice j's deflection from an Im z row: a lane partial over the lane's modes (fixed
  // pairwise order), then a butterfly over the warp that leaves the sum on every lane.
  auto lane_partials = [&](const float* z, float* p) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float q[M];
#pragma unroll
      for (int i = 0; i < M; ++i) q[i] = __fmul_rn(gv[j][3][i], z[i]);
      p[j] = Tree<0, M>::sum(q);
    }
  };
  auto butterfly = [&](float* p, int level) {  // level 0..4: lane distance 16 .. 1
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      p[j] = __fadd_rn(p[j], __shfl_xor_sync(kFull, p[j], 16 >> level));
    }
  };
  auto own = [&](const float* d) {  // lane j keeps voice j's
    float x = d[0];
#pragma unroll
    for (int j = 1; j < NV; ++j) x = lane == j ? d[j] : x;
    return x;
  };

  float p[NV];
  lane_partials(zi, p);  // the first sample's deflections, from the Im z the call starts from
#pragma unroll
  for (int level = 0; level < 5; ++level) butterfly(p, level);
  float dcur = own(p);

  float* part_row = a.partials + (size_t)o * S;
  if (S > 0) stage_run(0, stage);
  for (int s0 = 0, b = 0; s0 < S; s0 += kMixRun, b ^= 1) {
    const int len = min(kMixRun, S - s0);
    cp_async_wait_all();
    __syncwarp();  // this run's rows have landed; the other buffer is no longer read
    if (s0 + kMixRun < S) stage_run(s0 + kMixRun, stage + (b ^ 1) * kMixRun * per);
    const float* run_rows = stage + b * kMixRun * per;
    for (int t = 0; t < len; ++t) {
      const float* st = run_rows + t * per;
      // Im z of this sample (from the previous z).
      float ni[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        ni[i] = __fadd_rn(__fmul_rn(zr[i], ci[i]), __fmul_rn(zi[i], cr[i]));
      }
      float bn[NV], b0[NV], b1[NV];
      if (nv > 0) {  // uniform: an object without a voice skips the contact work
        // This sample's contact step on voice j's lane, with the deflection reduced a sample
        // ago, interleaved with the butterfly of the next sample's deflection; then the
        // broadcast of the drives.
        lane_partials(ni, p);
        float dnorm, d0, d1;
        contact_step(c, dcur, st[R + jl], st[R + NV + jl], st[R + 2 * NV + jl], rm, pen,
                     dnorm, d0, d1, [&](int level) { butterfly(p, level); });
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          bn[j] = __shfl_sync(kFull, dnorm, j);
          b0[j] = __shfl_sync(kFull, d0, j);
          b1[j] = __shfl_sync(kFull, d1, j);
        }
        dcur = own(p);
      }
      // The shared update, then the drives into Re z in table order.
      float f[kWarpRegSlots];
#pragma unroll
      for (int r = 0; r < kWarpRegSlots; ++r) f[r] = r < R ? st[r] : 0.f;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float e = 0.f;
#pragma unroll
        for (int r = 0; r < kWarpRegSlots; ++r) {
          if (r < R) e = __fadd_rn(e, __fmul_rn(f[r], gimp[r][i]));
        }
        zr[i] = __fadd_rn(__fsub_rn(__fmul_rn(zr[i], cr[i]), __fmul_rn(zi[i], ci[i])), e);
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (j < nv) {
#pragma unroll
          for (int i = 0; i < M; ++i) {
            zr[i] = __fadd_rn(zr[i], drive(bn[j], b0[j], b1[j], gv[j][0][i], gv[j][1][i],
                                           gv[j][2][i]));
          }
        }
      }
      float gm[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        zi[i] = ni[i];
        gm[i] = __fmul_rn(g, ni[i]);
      }
      stash[t * kStashRow + lane] = Tree<0, M>::sum(gm);
    }
    __syncwarp();
    if (lane < len) part_row[s0 + lane] = stash_sum(stash, lane);
    __syncwarp();  // the stash is read before the next run writes it
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int m = i * 32 + lane;
    if (m < K) {
      a.z_re[(size_t)o * K + m] = zr[i];
      a.z_im[(size_t)o * K + m] = zi[i];
    }
  }
  if (owner) {
    a.rm_out[my_v] = rm;
    a.pen_out[my_v] = pen;
  }
}

// ------------------------------------------------------------------------------------------
// Block path: one CTA per object, thread k owns mode k.

struct BlockPlan {
  int threads, warps, run, smem_voices;
  size_t bytes;
};

bool make_block_plan(int n_modes, int n_slots, int nv_cap, BlockPlan* p) {
  if (n_modes <= 0 || n_modes > kMaxThreads || n_slots < 0 || nv_cap < 0) return false;
  p->threads = (n_modes + 31) / 32 * 32;
  p->warps = p->threads / 32;
  // red (2 x nv_cap x warps) | consts (6 x nv_cap) | rm, pen | drives (2 x 3 x nv_cap) | ids
  const size_t fixed = (size_t)nv_cap * (2 * p->warps + 6 + 2 + 6 + 1) * sizeof(float) +
                       sizeof(int) +                                          // voice count
                       (size_t)p->warps * kStash * sizeof(float) +            // mix stashes
                       (size_t)2 * p->warps * kMixRun * sizeof(float);        // warp sums
  if (fixed >= kSmemLimit) return false;
  const size_t per_sample = (size_t)(3 * nv_cap + n_slots) * sizeof(float);
  const size_t stage_budget =
      kSmemLimit - fixed < kStageBudget ? kSmemLimit - fixed : kStageBudget;
  p->run = kMaxRun;
  if (per_sample > 0) {
    const size_t fit = stage_budget / per_sample;
    if (fit == 0) return false;
    p->run = fit < (size_t)kMaxRun ? (int)fit : kMaxRun;
  }
  const size_t staged = (size_t)p->run * per_sample;
  const size_t per_voice = (size_t)4 * p->threads * sizeof(float);  // a column per thread
  const int extra = nv_cap > kRegVoices ? nv_cap - kRegVoices : 0;
  size_t budget = kSmemLimit - fixed - staged;
  if (budget > kGainBudget) budget = kGainBudget;
  const size_t fit_voices = budget / per_voice;
  p->smem_voices = (size_t)extra < fit_voices ? extra : (int)fit_voices;
  p->bytes = fixed + staged + p->smem_voices * per_voice;
  return true;
}

__global__ void __launch_bounds__(kMaxThreads)
coupled_block_kernel(const Args a, int smem_voices, int run) {
  extern __shared__ float smem[];
  const int o = blockIdx.x;
  const int k = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int warp = k >> 5;
  const int lane = k & 31;
  const int K = a.n_modes, V = a.n_voice, R = a.n_slots, S = a.n_samples;
  const int nv_cap = a.nv_cap;
  const bool live = k < K;
  const size_t lanes = (size_t)a.n_obj * K;
  const size_t li = (size_t)o * K + k;

  float* s_red = smem;                                // [2][nv_cap][nwarps] deflection partials
  float* s_vc = s_red + (size_t)2 * nv_cap * nwarps;  // [6][nv_cap] sp stiff damp nf alpha sr
  float* s_rm = s_vc + 6 * nv_cap;                    // [nv_cap] relief-mean carry
  float* s_pen = s_rm + nv_cap;                       // [nv_cap] penetration carry
  float* s_drv = s_pen + nv_cap;                      // [2][3][nv_cap] normal, load*slope0/1
  int* s_vid = reinterpret_cast<int*>(s_drv + 6 * nv_cap);  // [nv_cap] table index
  int* s_nv = s_vid + nv_cap;                                // voices kept
  float* s_stash = reinterpret_cast<float*>(s_nv + 1);       // [nwarps][kStash]
  float* s_wsum = s_stash + (size_t)nwarps * kStash;         // [2][nwarps][kMixRun]
  float* s_gain = s_wsum + (size_t)2 * nwarps * kMixRun;     // [smem_voices][4][nthreads]
  float* s_stage = s_gain + (size_t)smem_voices * 4 * nthreads;  // [run][3*nv_cap + R]
  float* stash = s_stash + (size_t)warp * kStash;
  const int stride = 3 * nv_cap + R;

  if (warp == 0) {
    const int n = scan_voices(a.v_obj, V, o, nv_cap, lane, [&](int r, int v) { s_vid[r] = v; });
    if (lane == 0) *s_nv = n;
  }
  __syncthreads();
  const int nv = *s_nv;
  for (int j = k; j < nv; j += nthreads) {
    const int v = s_vid[j];
#pragma unroll
    for (int q = 0; q < 6; ++q) s_vc[q * nv_cap + j] = a.consts[(size_t)q * V + v];
    s_rm[j] = a.rm0[v];
    s_pen[j] = a.pen0[v];
  }

  float cr = 0.f, ci = 0.f, g = 0.f, zr = 0.f, zi = 0.f;
  float gimp[kRegSlots];
  float greg[kRegVoices][4];
#pragma unroll
  for (int r = 0; r < kRegSlots; ++r) gimp[r] = 0.f;
#pragma unroll
  for (int j = 0; j < kRegVoices; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) greg[j][q] = 0.f;
  }
  if (live) {
    cr = a.coeff_re[li];
    ci = a.coeff_im[li];
    g = a.out_gain[o];
    zr = a.z0_re[li];
    zi = a.z0_im[li];
#pragma unroll
    for (int r = 0; r < kRegSlots; ++r) {
      if (r < R) gimp[r] = a.gain_rok[(size_t)r * lanes + li];
    }
#pragma unroll
    for (int j = 0; j < kRegVoices; ++j) {
      if (j < nv) {
        const int v = s_vid[j];
#pragma unroll
        for (int q = 0; q < 4; ++q) greg[j][q] = a.gains4[((size_t)q * V + v) * K + k];
      }
    }
  }
  // Shared-memory tier: each thread (padding threads too) writes and reads only its own
  // column, so the tier needs no barrier.
  const int n_smem = min(max(nv - kRegVoices, 0), smem_voices);
  for (int j = 0; j < n_smem; ++j) {
    const int v = s_vid[kRegVoices + j];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_gain[((size_t)j * 4 + q) * nthreads + k] =
          live ? a.gains4[((size_t)q * V + v) * K + k] : 0.f;
    }
  }
  const int smem_end = kRegVoices + n_smem;  // voices past this read global memory

  auto read_row = [&](int j) {  // voice j's deflection gain for mode k, j >= kRegVoices
    if (j < smem_end) return s_gain[((size_t)(j - kRegVoices) * 4 + 3) * nthreads + k];
    return live ? __ldg(&a.gains4[((size_t)3 * V + s_vid[j]) * K + k]) : 0.f;
  };
  // Each warp's partial of every voice's deflection from an Im z value, into red.
  auto deflections = [&](float z, float* red) {
#pragma unroll
    for (int j = 0; j < kRegVoices; ++j) {
      if (j < nv) {
        const float p = warp_sum(__fmul_rn(greg[j][3], z));
        if (lane == 0) red[j * nwarps + warp] = p;
      }
    }
    for (int j = kRegVoices; j < nv; ++j) {
      const float p = warp_sum(__fmul_rn(read_row(j), z));
      if (lane == 0) red[j * nwarps + warp] = p;
    }
  };

  if (nv > 0) deflections(zi, s_red);  // the first sample's, into buffer 0
  float* part_row = a.partials + (size_t)o * S;
  int u = 0;       // samples advanced (parity of the double buffers)
  int mt = 0;      // samples stashed in the current mix run
  int mix_s0 = 0;  // first sample of the current mix run
  int mp = 0;      // parity of the warp-sum buffer
  for (int s0 = 0; s0 < S; s0 += run) {
    const int len = min(run, S - s0);
    __syncthreads();  // ids, carries, first partials written; previous rows no longer read
    const int per = 3 * nv + R;
    for (int idx = k; idx < len * per; idx += nthreads) {
      const int t = idx / per;
      const int rem = idx - t * per;
      const size_t s = (size_t)s0 + t;
      if (rem < 3 * nv) {
        const int q = rem / nv;
        const int j = rem - q * nv;
        s_stage[t * stride + q * nv_cap + j] = a.vx[(s * 3 + q) * V + s_vid[j]];
      } else {
        const int r = rem - 3 * nv;
        s_stage[t * stride + 3 * nv_cap + r] = a.force[(s * R + r) * a.n_obj + o];
      }
    }
    __syncthreads();

    for (int t = 0; t < len; ++t, ++u) {
      const float* st = s_stage + t * stride;
      float e = 0.f;
#pragma unroll
      for (int r = 0; r < kRegSlots; ++r) {
        if (r < R) e = __fadd_rn(e, __fmul_rn(st[3 * nv_cap + r], gimp[r]));
      }
      for (int r = kRegSlots; r < R; ++r) {
        const float gr = live ? a.gain_rok[(size_t)r * lanes + li] : 0.f;
        e = __fadd_rn(e, __fmul_rn(st[3 * nv_cap + r], gr));
      }
      const float ni = __fadd_rn(__fmul_rn(zr, ci), __fmul_rn(zi, cr));
      float nr = __fadd_rn(__fsub_rn(__fmul_rn(zr, cr), __fmul_rn(zi, ci)), e);
      if (nv > 0) {
        const float* red = s_red + (size_t)(u & 1) * nv_cap * nwarps;
        float* drv = s_drv + (u & 1) * 3 * nv_cap;
        // The next sample's deflection partials, then this sample's contact math (one
        // thread per voice) with the deflection reduced a sample ago.
        deflections(ni, s_red + (size_t)((u + 1) & 1) * nv_cap * nwarps);
        for (int j = k; j < nv; j += nthreads) {
          float defl = red[j * nwarps];
          for (int w = 1; w < nwarps; ++w) defl = __fadd_rn(defl, red[j * nwarps + w]);
          float vc[6];
#pragma unroll
          for (int q = 0; q < 6; ++q) vc[q] = s_vc[q * nv_cap + j];
          float rm = s_rm[j], pen = s_pen[j], dnorm, d0, d1;
          contact_step(vc, defl, st[j], st[nv_cap + j], st[2 * nv_cap + j], rm, pen, dnorm,
                       d0, d1, [](int) {});
          s_rm[j] = rm;
          s_pen[j] = pen;
          drv[j] = dnorm;
          drv[nv_cap + j] = d0;
          drv[2 * nv_cap + j] = d1;
        }
        __syncthreads();  // the only barrier of a sample
        // voice drives, in table order
#pragma unroll
        for (int j = 0; j < kRegVoices; ++j) {
          if (j < nv) {
            nr = __fadd_rn(nr, drive(drv[j], drv[nv_cap + j], drv[2 * nv_cap + j], greg[j][0],
                                     greg[j][1], greg[j][2]));
          }
        }
        for (int j = kRegVoices; j < nv; ++j) {
          float g0, g1, g2;
          if (j < smem_end) {
            const float* row = s_gain + (size_t)(j - kRegVoices) * 4 * nthreads + k;
            g0 = row[0];
            g1 = row[nthreads];
            g2 = row[2 * nthreads];
          } else if (live) {
            const size_t base = (size_t)s_vid[j] * K + k;
            const size_t plane = (size_t)V * K;
            g0 = __ldg(&a.gains4[base]);
            g1 = __ldg(&a.gains4[plane + base]);
            g2 = __ldg(&a.gains4[2 * plane + base]);
          } else {
            g0 = g1 = g2 = 0.f;
          }
          nr = __fadd_rn(nr, drive(drv[j], drv[nv_cap + j], drv[2 * nv_cap + j], g0, g1, g2));
        }
      }
      zr = nr;
      zi = ni;
      stash[mt * kStashRow + lane] = __fmul_rn(g, ni);
      if (++mt == kMixRun || s0 + t + 1 == S) {
        // Each warp sums its lanes per sample, then warp 0 sums the warps in warp order.
        float* ws = s_wsum + (size_t)mp * nwarps * kMixRun;
        __syncwarp();
        if (lane < mt) ws[warp * kMixRun + lane] = stash_sum(stash, lane);
        __syncthreads();
        if (warp == 0 && lane < mt) {
          float acc = ws[lane];
          for (int w = 1; w < nwarps; ++w) acc = __fadd_rn(acc, ws[w * kMixRun + lane]);
          part_row[mix_s0 + lane] = acc;
        }
        mp ^= 1;
        mix_s0 += mt;
        mt = 0;
      }
    }
  }
  if (live) {
    a.z_re[li] = zr;
    a.z_im[li] = zi;
  }
  for (int j = k; j < nv; j += nthreads) {  // the same thread stepped voice j
    a.rm_out[s_vid[j]] = s_rm[j];
    a.pen_out[s_vid[j]] = s_pen[j];
  }
}

// mix[s] = sum over objects o = 0..n_obj-1 of partials[o, s], in object order.
__global__ void mix_kernel(const float* __restrict__ partials, int n_obj, int n_samples,
                           float* __restrict__ mix) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_samples) return;
  float acc = 0.f;
  for (int o = 0; o < n_obj; ++o) acc = __fadd_rn(acc, partials[(size_t)o * n_samples + s]);
  mix[s] = acc;
}

// ------------------------------------------------------------------------------------------
// Launch plan and dispatch.

using WarpKernel = void (*)(const Args);

template <int NV>
WarpKernel warp_kernel_for(int m) {
  switch (m) {
    case 1: return coupled_warp_kernel<1, NV>;
    case 2: return coupled_warp_kernel<2, NV>;
    case 3: return coupled_warp_kernel<3, NV>;
    case 4: return coupled_warp_kernel<4, NV>;
    case 5: return coupled_warp_kernel<5, NV>;
    case 6: return coupled_warp_kernel<6, NV>;
    case 7: return coupled_warp_kernel<7, NV>;
    case 8: return coupled_warp_kernel<8, NV>;
    default: return nullptr;
  }
}

struct Plan {
  bool warp_path;
  int modes_per_lane, threads, run, register_voices, shared_voices, register_slots;
  size_t bytes;
  WarpKernel warp_kernel;
  BlockPlan block;
};

bool make_plan(int n_modes, int n_slots, int nv_cap, Plan* p) {
  if (n_modes <= 0 || n_modes > kMaxThreads || n_slots < 0 || nv_cap < 0) return false;
  const int m = (n_modes + 31) / 32;
  const int nv = nv_cap <= 1 ? 1 : nv_cap <= 2 ? 2 : nv_cap <= 4 ? 4 : 0;
  const size_t slice = warp_slice_floats(n_slots, nv) * sizeof(float);
  p->warp_path =
      m <= kWarpMaxModes && nv > 0 && n_slots <= kWarpRegSlots && slice <= kSmemLimit;
  if (p->warp_path) {
    p->warp_kernel = nv == 1 ? warp_kernel_for<1>(m) : nv == 2 ? warp_kernel_for<2>(m)
                                                               : warp_kernel_for<4>(m);
    p->modes_per_lane = m;
    p->threads = 32;  // one object-warp per CTA
    p->run = kMixRun;
    p->register_voices = nv_cap;
    p->shared_voices = 0;
    p->register_slots = n_slots < kWarpRegSlots ? n_slots : kWarpRegSlots;
    p->bytes = slice;
    return p->warp_kernel != nullptr;
  }
  if (!make_block_plan(n_modes, n_slots, nv_cap, &p->block)) return false;
  p->modes_per_lane = 1;
  p->threads = p->block.threads;
  p->run = p->block.run;
  p->register_voices = nv_cap < kRegVoices ? nv_cap : kRegVoices;
  p->shared_voices = p->block.smem_voices;
  p->register_slots = n_slots < kRegSlots ? n_slots : kRegSlots;
  p->bytes = p->block.bytes;
  return true;
}

}  // namespace

extern "C" {

// The launch plan at these shapes, into out[9]: path (0 warp, 1 block; one object per CTA
// on both), threads per CTA, modes per lane, voices per object whose gain rows are in registers, in
// shared memory, read from global memory, impact gain rows in registers, samples staged per
// pass, dynamic shared-memory bytes per CTA. Returns 0, or -1 when the shapes do not fit.
int coupled_resonator_plan(int n_modes, int n_slots, int nv_cap, int* out) {
  Plan p;
  if (!make_plan(n_modes, n_slots, nv_cap, &p)) return -1;
  out[0] = p.warp_path ? 0 : 1;
  out[1] = p.threads;
  out[2] = p.modes_per_lane;
  out[3] = p.register_voices;
  out[4] = p.shared_voices;
  out[5] = nv_cap - p.register_voices - p.shared_voices;
  out[6] = p.register_slots;
  out[7] = p.run;
  out[8] = (int)p.bytes;
  return 0;
}

// Advance the (n_obj, n_modes) bank and its voices n_samples samples. Shapes (float32 unless
// noted, C-contiguous): coeff_re/coeff_im/z0_*/z_* (O,K); out_gain (O,); gains4 (4,V,K);
// consts (6,V); vx (S,3,V); force (S,R,O); gain_rok (R,O,K); rm0/pen0/rm_out/pen_out (V,);
// v_obj (V,) int32, the object each voice drives (any other value: not stepped); of each
// object's voices the first nv_cap in table order step; partials (O,S); mix (S,).
// rm_out/pen_out rows of voices not stepped are left untouched. Returns a cudaError_t.
int coupled_resonator(const float* coeff_re, const float* coeff_im, const float* out_gain,
                      const float* gains4, const float* consts, const float* vx,
                      const float* force, const float* gain_rok, const float* z0_re,
                      const float* z0_im, const float* rm0, const float* pen0,
                      const int* v_obj, float* z_re, float* z_im, float* rm_out,
                      float* pen_out, float* partials, float* mix, int n_obj, int n_modes,
                      int n_voice, int n_slots, int n_samples, int nv_cap, void* stream) {
  Plan p;
  if (n_obj <= 0 || n_voice < 0 || n_samples < 0 || nv_cap > n_voice ||
      !make_plan(n_modes, n_slots, nv_cap, &p)) {
    return cudaErrorInvalidValue;
  }
  const Args a{coeff_re, coeff_im, out_gain, gains4, consts, vx, force, gain_rok, z0_re,
               z0_im, rm0, pen0, v_obj, z_re, z_im, rm_out, pen_out, partials, n_obj,
               n_modes, n_voice, n_slots, n_samples, nv_cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.warp_path) {
    if (p.bytes > kDefaultSmem) {
      cudaError_t err = cudaFuncSetAttribute(
          p.warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
      if (err != cudaSuccess) return err;
    }
    p.warp_kernel<<<n_obj, p.threads, p.bytes, st>>>(a);
  } else {
    if (p.bytes > kDefaultSmem) {
      cudaError_t err = cudaFuncSetAttribute(
          coupled_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
      if (err != cudaSuccess) return err;
    }
    coupled_block_kernel<<<n_obj, p.threads, p.bytes, st>>>(a, p.block.smem_voices,
                                                             p.block.run);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_samples > 0) {
    mix_kernel<<<(n_samples + 255) / 256, 256, 0, st>>>(partials, n_obj, n_samples, mix);
  }
  return cudaGetLastError();
}

}  // extern "C"
