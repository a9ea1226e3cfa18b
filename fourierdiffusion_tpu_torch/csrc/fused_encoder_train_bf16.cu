// The training layer's forward (B3) and backward (B4) in bf16: x, dy, dx,
// out and the four weight matrices in bf16, the vectors and the gradients
// fp32. The C interface of fused_encoder_train.cuh, which holds the
// kernels, their numerics, bound and design; the same functions and
// arguments as fused_encoder_train.cu's fp32 instance, in a library of
// their own.

#include "fused_encoder_train.cuh"

extern "C" {

int fdiff_train_fwd(const void* x, const void* const* weights, void* out, void* workspace,
                    const void* plan, int B, int L, int D, int H, int F, int group,
                    unsigned int seed, unsigned int thr, float scale, void* stream) {
  return train_fwd_c<__nv_bfloat16>(x, weights, out, workspace, plan, B, L, D, H, F, group,
                                    seed, thr, scale, stream);
}

int fdiff_train_bwd(const void* x, const void* dy, const void* const* weights, void* dx,
                    void* grads, void* workspace, const void* plan, int B, int L, int D,
                    int H, int F, int group, unsigned int seed, unsigned int thr, float scale,
                    void* const* events, void* stream) {
  return train_bwd_c<__nv_bfloat16>(x, dy, weights, dx, grads, workspace, plan, B, L, D, H, F,
                                    group, seed, thr, scale, events, stream);
}

const char* fdiff_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
