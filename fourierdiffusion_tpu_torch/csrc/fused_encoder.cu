// One whole post-LN transformer encoder layer for the reverse-diffusion
// sampling path on Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel fourierdiffusion_tpu/ops/fused_encoder.py::
// _encoder_layer_kernel (fp32 and bf16; its int8 variants, B7 and B8, are
// in fused_encoder_int8.cu).
// The kernels, their numerics, bound and design are in encoder_layer_tc.cuh
// (three launches: the QKV tile product over all rows, attention per
// (rows, head, chain), and the tail from the out projection to LN2 per row
// tile) on the tensor-core tile products of mma_tile.cuh; here they run
// without dropout.

#include <type_traits>

#include "encoder_layer_tc.cuh"

extern "C" {

// dtype_code 0: float32, 1: bfloat16. qkv_ws (B*L x 3D) and o_ws (B*L x D)
// in the dtype; plan: fdiff::TailPlan (ops/fused_encoder.py tail_plan).
// The tail's workspace (fdiff::TailWs; null where the route takes none):
// fused, x1_ws (B*L x D, fp32) and part_ws (tail_schedule's parts x tm x D,
// fp32), over tail_ctas CTAs; wide, pre_ws (B*L x D, fp32), x1t_ws (B*L x
// D) and h_ws (B*L x F) in the dtype. Returns cudaGetLastError() after the
// last launch (0 on success), or the error that stopped it before.
int fdiff_encoder_layer(int dtype_code, const void* x, const void* w_qkv,
                        const void* b_qkv, const void* w_out, const void* b_out,
                        const void* ln1_s, const void* ln1_b, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* ln2_s, const void* ln2_b, void* out, void* qkv_ws,
                        void* o_ws, void* x1_ws, void* part_ws, void* pre_ws, void* x1t_ws,
                        void* h_ws, const fdiff::TailPlan* plan, int tail_ctas, int B, int L,
                        int D, int H, int F, void* stream) {
  const void* const w[] = {w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b,
                           w1,    b1,    w2,    b2,    ln2_s, ln2_b};
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* t) {
    using T = std::remove_pointer_t<decltype(t)>;
    const fdiff::TailWs<T> tail_ws{static_cast<float*>(x1_ws), static_cast<float*>(part_ws),
                                   static_cast<float*>(pre_ws), static_cast<T*>(x1t_ws),
                                   static_cast<T*>(h_ws)};
    return fdiff::launch_encoder_layer_tc<T>(
        static_cast<const T*>(x), fdiff::weights_of<T>(w), static_cast<T*>(out),
        static_cast<T*>(qkv_ws), static_cast<T*>(o_ws), tail_ws, B, L, D, H, F, *plan,
        tail_ctas, s);
  };
  if (dtype_code == 0) return run(static_cast<float*>(nullptr));
  if (dtype_code == 1) return run(static_cast<__nv_bfloat16*>(nullptr));
  return (int)cudaErrorInvalidValue;
}

const char* fdiff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
