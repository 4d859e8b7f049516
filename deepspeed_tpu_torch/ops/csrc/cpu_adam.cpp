// SIMD CPU Adam/AdamW step for host-offloaded optimizer states.
//
// The host leg of ZeRO-Offload (reference csrc/adam/cpu_adam.cpp +
// cpu_adam_impl.cpp): the fp32 gradients come down to host RAM and the
// optimizer step runs on the host CPU.  The hot loop is a pure elementwise
// map over four fp32 arrays, so the whole win is vectorization + threads:
// `#pragma omp parallel for simd` lets GCC emit AVX2/AVX-512 (whatever
// -march=native offers) across all cores, the shape of the reference's
// hand-written intrinsics but portable.  A copy of the JAX package's
// ops/csrc/cpu_adam.cpp, bit for bit in its arithmetic.
//
// The optional bf16 output mirrors the reference's fused fp16-param copy
// (cpu_adam.cpp `half* dev_param`): the updated master is rounded
// (nearest-even) to bf16 in the same pass, producing the device compute
// params without a second cast over the buffer.
//
// C ABI for ctypes binding (no PyTorch or pybind11 headers).

#include <cmath>
#include <cstdint>
#include <cstring>

#include <omp.h>

extern "C" {

static inline uint16_t float_to_bf16_rne(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t lsb = (x >> 16) & 1u;
  x += 0x7fffu + lsb;  // round to nearest even
  return (uint16_t)(x >> 16);
}

// params/grads/m/v: fp32 [n].  step is 1-based.  adam_w_mode: 1 = decoupled
// decay (AdamW), 0 = L2 (decay folded into grad).  bf16_out may be null.
void cpu_adam_step(float* params, const float* grads, float* exp_avg,
                   float* exp_avg_sq, int64_t n, float lr, float beta1,
                   float beta2, float eps, float weight_decay, int adam_w_mode,
                   int bias_correction, int step, uint16_t* bf16_out) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, (float)step);
    bc2 = 1.0f - std::pow(beta2, (float)step);
  }
  const float step_size = lr / bc1;
  const float bc2_sqrt = std::sqrt(bc2);
  const float b1 = beta1, b2 = beta2;
  const float omb1 = 1.0f - beta1, omb2 = 1.0f - beta2;
  const float wd = weight_decay;

#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    float p = params[i];
    if (!adam_w_mode && wd != 0.0f) g += wd * p;
    float m = b1 * exp_avg[i] + omb1 * g;
    float v = b2 * exp_avg_sq[i] + omb2 * g * g;
    float denom = std::sqrt(v) / bc2_sqrt + eps;
    // decoupled decay uses the RAW lr (p -= lr*wd*p), not lr/bc1 — scaling
    // it by the bias correction would 10x the decay at step 1 (beta1=0.9)
    float new_p = p - step_size * (m / denom);
    if (adam_w_mode && wd != 0.0f) new_p -= lr * wd * p;
    exp_avg[i] = m;
    exp_avg_sq[i] = v;
    params[i] = new_p;
  }
  if (bf16_out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) bf16_out[i] = float_to_bf16_rne(params[i]);
  }
}

// Adagrad (reference csrc/adagrad/cpu_adagrad.cpp): state is the running
// sum of squared gradients.
void cpu_adagrad_step(float* params, const float* grads, float* sq_sum,
                      int64_t n, float lr, float eps, float weight_decay,
                      uint16_t* bf16_out) {
  const float wd = weight_decay;
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    float p = params[i];
    if (wd != 0.0f) g += wd * p;
    float s = sq_sum[i] + g * g;
    p -= lr * g / (std::sqrt(s) + eps);
    sq_sum[i] = s;
    params[i] = p;
  }
  if (bf16_out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) bf16_out[i] = float_to_bf16_rne(params[i]);
  }
}

// L2 norm over an fp32 buffer (reference multi_tensor_l2norm use in the
// offload path's grad-norm computation).
double cpu_l2_norm(const float* x, int64_t n) {
  double acc = 0.0;
#pragma omp parallel for simd reduction(+ : acc) schedule(static)
  for (int64_t i = 0; i < n; ++i) acc += (double)x[i] * (double)x[i];
  return std::sqrt(acc);
}

// The OpenMP team size a step gets (the runtime this library linked, which
// may not be the one the host process's other libraries use).
int cpu_adam_num_threads() { return omp_get_max_threads(); }

}  // extern "C"
