// One whole post-LN transformer encoder layer in one kernel launch, for
// the reverse-diffusion sampling path on Hopper (sm_90a).
//
// Replaces the TPU kernel fourierdiffusion_tpu/ops/fused_encoder.py::
// _encoder_layer_kernel (fp32 and bf16; its int8 variants, B7 and B8, are
// in fused_encoder_int8.cu).
// The kernel body, its numerics, layout, bound and design are in
// encoder_layer.cuh, which the training forward (fused_encoder_train.cu)
// shares; here it runs without dropout: encoder_layer_kernel<T, false, *>,
// with K|V in shared memory where they fit and in a device workspace
// otherwise (kv_proj_kernel first; see encoder_layer.cuh).

#include "encoder_layer.cuh"

extern "C" {

// Shared-memory bytes one CTA needs at sequence length L and width D.
int fdiff_encoder_layer_smem_bytes(int L, int D) {
  return fdiff::encoder_layer_smem_bytes(L, D);
}

// Floats per chain of the K|V workspace the launch needs (0: none).
int fdiff_encoder_layer_kv_floats(int L, int D) {
  return fdiff::encoder_layer_kv_floats(L, D);
}

// dtype_code 0: float32, 1: bfloat16. kv_ws: B x fdiff_encoder_layer_kv_floats
// floats (null when that is 0). Returns cudaGetLastError() after the launch
// (0 on success), or the error that stopped it before.
int fdiff_encoder_layer(int dtype_code, const void* x, const void* w_qkv,
                        const void* b_qkv, const void* w_out, const void* b_out,
                        const void* ln1_s, const void* ln1_b, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* ln2_s, const void* ln2_b, void* out, void* kv_ws,
                        int B, int L, int D, int H, int F, void* stream) {
  const void* const w[] = {w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b,
                           w1,    b1,    w2,    b2,    ln2_s, ln2_b};
  const fdiff::Dropout none{0u, 0u, 1.0f, 1};  // unused without dropout
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return fdiff::launch_encoder_layer<float, false>(
        x, fdiff::weights_of<float>(w), out, kv_ws, B, L, D, H, F, none, s);
  if (dtype_code == 1)
    return fdiff::launch_encoder_layer<__nv_bfloat16, false>(
        x, fdiff::weights_of<__nv_bfloat16>(w), out, kv_ws, B, L, D, H, F, none, s);
  return (int)cudaErrorInvalidValue;
}

const char* fdiff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
