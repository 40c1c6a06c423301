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
// What bounds it on this card: LATENCY, by design. Each sample depends on the previous one
// through the deflection read, so the loop over samples is sequential; at the bench shape
// (64 objects x 256 modes, 16 voices) a few thousand flops per sample are spread over 64 CTAs,
// and each sample pays two block barriers and a shuffle-tree reduction per voice.
//
// What the design does about it:
//  - voices on different objects never interact, so ONE CTA PER OBJECT advances that object
//    and its voices, with no grid-wide sync: thread k owns mode k and keeps z, c, the output
//    gain and its first impact gain rows in registers for the whole call;
//  - the wrapper sorts the live voices by (object, table index) and passes CSR offsets; a CTA
//    loads its own voice range. A voice's four gain rows (gnf, geo0, geo1, read) for the
//    thread's mode live in registers for the first kRegVoices voices of the object, in shared
//    memory for the next ones (as many as the shared-memory budget holds), and are read from
//    global memory (L1/L2) beyond that;
//  - per sample: each voice's deflection is a warp-shuffle tree per warp, then (one thread per
//    voice) the warp partials summed in warp order and the scalar contact math, carries in
//    shared memory; a barrier; every thread applies the shared update and its object's voice
//    drives in table order; a barrier. An object with no voice skips both phases and their
//    barriers. Relief, slopes and impact forces are staged into shared memory a run of samples
//    at a time;
//  - the mix: one partial per (object, warp, sample), summed by a second kernel in a fixed
//    order, with no float atomics, so rendering 2S samples equals S then S bit for bit.
//
// The kernels launch on the caller's stream, allocate nothing, and the C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kMaxThreads = 1024;  // modes per object the kernel takes (one thread each)
constexpr int kRegSlots = 4;       // impact gain rows held in registers
constexpr int kRegVoices = 4;      // voices whose four gain rows are held in registers
constexpr int kMaxRun = 256;       // samples staged per pass
constexpr size_t kStageBudget = 32 * 1024;     // bytes of staged relief/slope/force rows
constexpr size_t kGainBudget = 160 * 1024;     // bytes of shared-memory gain rows
constexpr size_t kDefaultSmem = 48 * 1024;     // above this the launch needs an opt-in

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;  // valid in lane 0
}

// normal*g0 + (load*slope0)*g1 + (load*slope1)*g2, left to right
__device__ __forceinline__ float drive(float dn, float d0, float d1, float g0, float g1,
                                       float g2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dn, g0), __fmul_rn(d0, g1)), __fmul_rn(d1, g2));
}

struct Plan {
  int threads, warps, run, smem_voices;
  size_t bytes;
};

// Shared-memory plan of a launch; returns false when the shapes do not fit.
bool make_plan(int n_modes, int n_slots, int nv_cap, Plan* p) {
  if (n_modes <= 0 || n_modes > kMaxThreads || n_slots < 0 || nv_cap < 0) return false;
  p->threads = (n_modes + 31) / 32 * 32;
  p->warps = p->threads / 32;
  // red (nv_cap x warps) | consts (6 x nv_cap) | rm, pen | drives (3 x nv_cap) | ids
  const size_t fixed = (size_t)nv_cap * (p->warps + 6 + 2 + 3 + 1) * sizeof(float);
  const size_t per_sample = (size_t)(3 * nv_cap + n_slots) * sizeof(float);
  p->run = kMaxRun;
  if (per_sample > 0) {
    const size_t fit = kStageBudget / per_sample;
    if (fit == 0) return false;
    p->run = fit < (size_t)kMaxRun ? (int)fit : kMaxRun;
  }
  const size_t per_voice = (size_t)4 * p->threads * sizeof(float);  // a column per thread
  const int extra = nv_cap > kRegVoices ? nv_cap - kRegVoices : 0;
  const size_t fit_voices = kGainBudget / per_voice;
  p->smem_voices = (size_t)extra < fit_voices ? extra : (int)fit_voices;
  p->bytes = fixed + p->run * per_sample + p->smem_voices * per_voice;
  return true;
}

__global__ void __launch_bounds__(kMaxThreads)
coupled_kernel(const float* __restrict__ coeff_re, const float* __restrict__ coeff_im,
               const float* __restrict__ out_gain, const float* __restrict__ gains4,
               const float* __restrict__ consts, const float* __restrict__ vx,
               const float* __restrict__ force, const float* __restrict__ gain_rok,
               const float* __restrict__ z0_re, const float* __restrict__ z0_im,
               const float* __restrict__ rm0, const float* __restrict__ pen0,
               const int* __restrict__ order, const int* __restrict__ offsets,
               float* __restrict__ z_re, float* __restrict__ z_im, float* __restrict__ rm_out,
               float* __restrict__ pen_out, float* __restrict__ partials, int n_obj,
               int n_modes, int n_voice, int n_slots, int n_samples, int nv_cap,
               int smem_voices, int run) {
  extern __shared__ float smem[];
  const int o = blockIdx.x;
  const int k = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int warp = k >> 5;
  const int lane = k & 31;
  const bool live = k < n_modes;
  const size_t lanes = (size_t)n_obj * n_modes;
  const size_t li = (size_t)o * n_modes + k;
  const int vbeg = offsets[o];
  const int nv = min(offsets[o + 1] - vbeg, nv_cap);  // the wrapper keeps it within nv_cap

  float* s_red = smem;                          // [nv_cap][nwarps] deflection partials
  float* s_vc = s_red + (size_t)nv_cap * nwarps;  // [6][nv_cap] sp stiff damp nf alpha sr
  float* s_rm = s_vc + 6 * nv_cap;              // [nv_cap] relief-mean carry
  float* s_pen = s_rm + nv_cap;                 // [nv_cap] penetration carry
  float* s_drv = s_pen + nv_cap;                // [3][nv_cap] normal, load*slope0, load*slope1
  int* s_vid = reinterpret_cast<int*>(s_drv + 3 * nv_cap);  // [nv_cap] table index
  float* s_gain = reinterpret_cast<float*>(s_vid + nv_cap);  // [smem_voices][4][nthreads]
  float* s_stage = s_gain + (size_t)smem_voices * 4 * nthreads;  // [run][3*nv_cap + n_slots]
  const int stride = 3 * nv_cap + n_slots;

  for (int j = k; j < nv; j += nthreads) {
    const int v = order[vbeg + j];
    s_vid[j] = v;
#pragma unroll
    for (int c = 0; c < 6; ++c) s_vc[c * nv_cap + j] = consts[(size_t)c * n_voice + v];
    s_rm[j] = rm0[v];
    s_pen[j] = pen0[v];
  }

  float cr = 0.f, ci = 0.f, g = 0.f, zr = 0.f, zi = 0.f;
  float gimp[kRegSlots];
  float greg[kRegVoices][4];
#pragma unroll
  for (int r = 0; r < kRegSlots; ++r) gimp[r] = 0.f;
#pragma unroll
  for (int j = 0; j < kRegVoices; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) greg[j][r] = 0.f;
  }
  if (live) {
    cr = coeff_re[li];
    ci = coeff_im[li];
    g = out_gain[o];
    zr = z0_re[li];
    zi = z0_im[li];
#pragma unroll
    for (int r = 0; r < kRegSlots; ++r) {
      if (r < n_slots) gimp[r] = gain_rok[(size_t)r * lanes + li];
    }
#pragma unroll
    for (int j = 0; j < kRegVoices; ++j) {
      if (j < nv) {
        const int v = order[vbeg + j];
#pragma unroll
        for (int r = 0; r < 4; ++r) greg[j][r] = gains4[((size_t)r * n_voice + v) * n_modes + k];
      }
    }
  }
  // Shared-memory tier: each thread (padding threads too) writes and reads only its own
  // column, so the tier needs no barrier.
  const int n_smem = min(max(nv - kRegVoices, 0), smem_voices);
  for (int j = 0; j < n_smem; ++j) {
    const int v = order[vbeg + kRegVoices + j];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s_gain[((size_t)j * 4 + r) * nthreads + k] =
          live ? gains4[((size_t)r * n_voice + v) * n_modes + k] : 0.f;
    }
  }
  const int smem_end = kRegVoices + n_smem;  // voices past this read global memory

  for (int s0 = 0; s0 < n_samples; s0 += run) {
    const int len = min(run, n_samples - s0);
    __syncthreads();  // ids and carries written; the previous run's rows no longer read
    const int per = 3 * nv + n_slots;
    for (int idx = k; idx < len * per; idx += nthreads) {
      const int t = idx / per;
      const int rem = idx - t * per;
      const size_t s = (size_t)s0 + t;
      if (rem < 3 * nv) {
        const int c = rem / nv;
        const int j = rem - c * nv;
        s_stage[t * stride + c * nv_cap + j] = vx[(s * 3 + c) * n_voice + s_vid[j]];
      } else {
        const int r = rem - 3 * nv;
        s_stage[t * stride + 3 * nv_cap + r] = force[(s * n_slots + r) * n_obj + o];
      }
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      const float* st = s_stage + t * stride;
      if (nv > 0) {
        // 1. deflection partials from the previous sample's Im z
#pragma unroll
        for (int j = 0; j < kRegVoices; ++j) {
          if (j < nv) {
            const float p = warp_sum(__fmul_rn(greg[j][3], zi));
            if (lane == 0) s_red[j * nwarps + warp] = p;
          }
        }
        for (int j = kRegVoices; j < nv; ++j) {
          float rd;
          if (j < smem_end) {
            rd = s_gain[((size_t)(j - kRegVoices) * 4 + 3) * nthreads + k];
          } else {
            rd = live ? __ldg(&gains4[((size_t)3 * n_voice + s_vid[j]) * n_modes + k]) : 0.f;
          }
          const float p = warp_sum(__fmul_rn(rd, zi));
          if (lane == 0) s_red[j * nwarps + warp] = p;
        }
        __syncthreads();
        // 2. contact model, one thread per voice
        for (int j = k; j < nv; j += nthreads) {
          float defl = s_red[j * nwarps];
          for (int w = 1; w < nwarps; ++w) defl = __fadd_rn(defl, s_red[j * nwarps + w]);
          const float relief = st[j];
          const float sp = s_vc[j], stiff = s_vc[nv_cap + j], damp = s_vc[2 * nv_cap + j];
          const float nf = s_vc[3 * nv_cap + j], alpha = s_vc[4 * nv_cap + j];
          const float sr = s_vc[5 * nv_cap + j];
          float rm = s_rm[j];
          rm = __fadd_rn(rm, __fmul_rn(__fsub_rn(relief, rm), alpha));
          const float rigid = __fadd_rn(sp, __fsub_rn(relief, rm));
          const float sep = fmaxf(__fsub_rn(rigid, defl), 0.f);
          const float rate = __fmul_rn(__fsub_rn(sep, s_pen[j]), sr);
          const float f = __fmul_rn(__fmul_rn(__fmul_rn(stiff, sep), __fsqrt_rn(sep)),
                                    __fadd_rn(1.f, __fmul_rn(damp, rate)));
          float normal = __fsub_rn(fmaxf(f, 0.f), nf);
          if (normal > 0.f && nf > 0.f) normal = __fmul_rn(nf, tanhf(__fdiv_rn(normal, nf)));
          const float load = __fadd_rn(nf, normal);
          s_rm[j] = rm;
          s_pen[j] = sep;
          s_drv[j] = normal;
          s_drv[nv_cap + j] = __fmul_rn(load, st[nv_cap + j]);
          s_drv[2 * nv_cap + j] = __fmul_rn(load, st[2 * nv_cap + j]);
        }
        __syncthreads();
      }
      // 3. shared update with the factored impact excitation
      float e = 0.f;
#pragma unroll
      for (int r = 0; r < kRegSlots; ++r) {
        if (r < n_slots) e = __fadd_rn(e, __fmul_rn(st[3 * nv_cap + r], gimp[r]));
      }
      for (int r = kRegSlots; r < n_slots; ++r) {
        const float gr = live ? gain_rok[(size_t)r * lanes + li] : 0.f;
        e = __fadd_rn(e, __fmul_rn(st[3 * nv_cap + r], gr));
      }
      float nr = __fadd_rn(__fsub_rn(__fmul_rn(zr, cr), __fmul_rn(zi, ci)), e);
      const float ni = __fadd_rn(__fmul_rn(zr, ci), __fmul_rn(zi, cr));
      // 4. voice drives, in table order
      if (nv > 0) {
#pragma unroll
        for (int j = 0; j < kRegVoices; ++j) {
          if (j < nv) {
            nr = __fadd_rn(nr, drive(s_drv[j], s_drv[nv_cap + j], s_drv[2 * nv_cap + j],
                                     greg[j][0], greg[j][1], greg[j][2]));
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
            const size_t base = (size_t)s_vid[j] * n_modes + k;
            const size_t plane = (size_t)n_voice * n_modes;
            g0 = __ldg(&gains4[base]);
            g1 = __ldg(&gains4[plane + base]);
            g2 = __ldg(&gains4[2 * plane + base]);
          } else {
            g0 = g1 = g2 = 0.f;
          }
          nr = __fadd_rn(nr, drive(s_drv[j], s_drv[nv_cap + j], s_drv[2 * nv_cap + j], g0, g1,
                                   g2));
        }
      }
      zr = nr;
      zi = ni;
      // 5. this warp's mix partial
      const float m = warp_sum(live ? __fmul_rn(g, ni) : 0.f);
      if (lane == 0) partials[((size_t)o * nwarps + warp) * n_samples + s0 + t] = m;
    }
  }
  if (live) {
    z_re[li] = zr;
    z_im[li] = zi;
  }
  for (int j = k; j < nv; j += nthreads) {  // the same thread stepped voice j
    rm_out[s_vid[j]] = s_rm[j];
    pen_out[s_vid[j]] = s_pen[j];
  }
}

// mix[s] = sum over partial rows w = 0..n_partials-1 of partials[w, s], in row order.
__global__ void coupled_mix_kernel(const float* __restrict__ partials, int n_partials,
                                   int n_samples, float* __restrict__ mix) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_samples) return;
  float acc = 0.f;
  for (int w = 0; w < n_partials; ++w) acc = __fadd_rn(acc, partials[(size_t)w * n_samples + s]);
  mix[s] = acc;
}

}  // namespace

extern "C" {

// Rows of the partials scratch the caller allocates: (coupled_resonator_partials, n_samples).
int coupled_resonator_partials(int n_obj, int n_modes) {
  return n_obj * ((n_modes + 31) / 32);
}

// Where a launch keeps each voice's gain rows: tiers[0] voices per object in registers,
// tiers[1] in shared memory, tiers[2] read from global memory, tiers[3] samples staged per
// pass, tiers[4] dynamic shared-memory bytes. Returns 0, or -1 when the shapes do not fit.
int coupled_resonator_plan(int n_modes, int n_slots, int nv_cap, int* tiers) {
  Plan p;
  if (!make_plan(n_modes, n_slots, nv_cap, &p)) return -1;
  const int reg = nv_cap < kRegVoices ? nv_cap : kRegVoices;
  tiers[0] = reg;
  tiers[1] = p.smem_voices;
  tiers[2] = nv_cap - reg - p.smem_voices;
  tiers[3] = p.run;
  tiers[4] = (int)p.bytes;
  return 0;
}

// Advance the (n_obj, n_modes) bank and its voices n_samples samples. Shapes (float32 unless
// noted, C-contiguous): coeff_re/coeff_im/z0_*/z_* (O,K); out_gain (O,); gains4 (4,V,K);
// consts (6,V); vx (S,3,V); force (S,R,O); gain_rok (R,O,K); rm0/pen0/rm_out/pen_out (V,);
// order (V,) int32, the voices to step sorted by (object, table index); offsets (O+1,) int32,
// object o's voices at order[offsets[o]:offsets[o+1]], at most nv_cap of them;
// partials (coupled_resonator_partials(O,K), S); mix (S,). rm_out/pen_out rows of voices not
// in order are left untouched. Returns a cudaError_t.
int coupled_resonator(const float* coeff_re, const float* coeff_im, const float* out_gain,
                      const float* gains4, const float* consts, const float* vx,
                      const float* force, const float* gain_rok, const float* z0_re,
                      const float* z0_im, const float* rm0, const float* pen0,
                      const int* order, const int* offsets, float* z_re, float* z_im,
                      float* rm_out, float* pen_out, float* partials, float* mix, int n_obj,
                      int n_modes, int n_voice, int n_slots, int n_samples, int nv_cap,
                      void* stream) {
  Plan p;
  if (n_obj <= 0 || n_voice < 0 || n_samples < 0 || nv_cap > n_voice ||
      !make_plan(n_modes, n_slots, nv_cap, &p)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.bytes > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        coupled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
    if (err != cudaSuccess) return err;
  }
  coupled_kernel<<<n_obj, p.threads, p.bytes, st>>>(
      coeff_re, coeff_im, out_gain, gains4, consts, vx, force, gain_rok, z0_re, z0_im, rm0,
      pen0, order, offsets, z_re, z_im, rm_out, pen_out, partials, n_obj, n_modes, n_voice,
      n_slots, n_samples, nv_cap, p.smem_voices, p.run);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_samples > 0) {
    coupled_mix_kernel<<<(n_samples + 255) / 256, 256, 0, st>>>(partials, n_obj * p.warps,
                                                                n_samples, mix);
  }
  return cudaGetLastError();
}

}  // extern "C"
