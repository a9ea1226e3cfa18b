// The training layer's forward (B3) and backward (B4) in fp32, and the
// helpers of both instances (the packed gradient's size, B4's stages, the
// dropout masks): the C interface of fused_encoder_train.cuh, which holds
// the kernels, their numerics, bound and design. The bf16 instance is
// fused_encoder_train_bf16.cu.

#include "fused_encoder_train.cuh"

extern "C" {

int fdiff_train_grad_floats(int D, int F) { return GradOffsets(D, F).total; }

// B4's stages (events: stages + 1).
int fdiff_train_bwd_stages() { return kBwdStages; }

// The forward (B3) in fp32: weights, the 12 packed tensors in the order
// w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b; out
// (B, L, D); workspace and plan from the wrapper (FwdPlan). Returns
// cudaGetLastError() after the last launch (0 on success), or the error
// that stopped it before.
int fdiff_train_fwd(const void* x, const void* const* weights, void* out, void* workspace,
                    const void* plan, int B, int L, int D, int H, int F, int group,
                    unsigned int seed, unsigned int thr, float scale, void* stream) {
  return train_fwd_c<float>(x, weights, out, workspace, plan, B, L, D, H, F, group, seed, thr,
                            scale, stream);
}

// The backward (B4) in fp32: dx (B, L, D), grads (fdiff_train_grad_floats),
// workspace and plan from the wrapper (BwdPlan); events null or
// fdiff_train_bwd_stages() + 1 CUDA events recorded around the stages.
int fdiff_train_bwd(const void* x, const void* dy, const void* const* weights, void* dx,
                    void* grads, void* workspace, const void* plan, int B, int L, int D,
                    int H, int F, int group, unsigned int seed, unsigned int thr, float scale,
                    void* const* events, void* stream) {
  return train_bwd_c<float>(x, dy, weights, dx, grads, workspace, plan, B, L, D, H, F, group,
                            seed, thr, scale, events, stream);
}

int fdiff_dropout_masks(void* attn, void* out, void* ff, void* ff2, int B, int L, int D,
                        int H, int F, int group, unsigned int seed, unsigned int thr,
                        float scale, void* stream) {
  const Dropout dp{seed, thr, scale, group};
  dropout_masks_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(attn), static_cast<float*>(out), static_cast<float*>(ff),
      static_cast<float*>(ff2), B, L, D, H, F, dp);
  return (int)cudaGetLastError();
}

const char* fdiff_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
