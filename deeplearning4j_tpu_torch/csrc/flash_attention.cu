// Flash-attention forward (admission prefill, K4), for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by
// deeplearning4j_tpu_torch/ops/flash_attention.py. Built into one library
// with csrc/flash_attention_ext.cu (K5), whose entry point it calls: the
// kernels are csrc/flash_fwd.cuh's, compiled once (its note says what
// bounds them and what their design does about it).
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py, _flash_raw
// (kernel body _flash_kernel), reached through flash_attention and
// attention_auto.
//
// Function: q, k, v [N,T,H,D] (read in place through their strides — no
// head-folding transposes); causal or full softmax(q.k / sqrt(D)) v with
// f32 scores and an online softmax. Outputs O [N,T,H,D] in q's dtype and
// the per-row log-sum-exp lse [N,H,T] f32 (the residual a backward
// needs). Any T: q rows >= T and keys >= T are masked in the kernel, so
// every prefill bucket width (96, 192, ...) runs through it — the TPU
// kernel needed T % 128 == 0 and the JAX package fell back to dense XLA
// below that. This is K5's launch with no key bias and offset 0 (causal)
// or T (full), so K4 and K5 give the same bits on the same inputs. A
// window win > 0 (causal only) hides keys with qi - ki >= win: a
// sliding-window layer; 0 is none.

// csrc/flash_attention_ext.cu
extern "C" int flash_attention_ext_fwd(
    const void* q, const void* k, const void* v, const void* kb, void* o,
    void* lse, int N, int Tq, int Tk, int H, int D, long long q_sn,
    long long q_st, long long q_sh, long long k_sn, long long k_st,
    long long k_sh, long long v_sn, long long v_st, long long v_sh, int off,
    int win, int dtype, int device, void* stream);

// dtype codes: 0 = float32, 1 = bfloat16. o must be a contiguous
// [N,T,H,D] buffer of q's dtype, lse a contiguous [N,H,T] float32 one.
// Returns the CUDA error of the launch (0 = success); an unsupported
// head size or dtype returns cudaErrorInvalidValue without launching.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int N,
    int T_len, int H, int D, long long q_sn, long long q_st, long long q_sh,
    long long k_sn, long long k_st, long long k_sh, long long v_sn,
    long long v_st, long long v_sh, int causal, int win, int dtype,
    int device, void* stream) {
  return flash_attention_ext_fwd(q, k, v, nullptr, o, lse, N, T_len, T_len,
                                 H, D, q_sn, q_st, q_sh, k_sn, k_st, k_sh,
                                 v_sn, v_st, v_sh, causal ? 0 : T_len, win,
                                 dtype, device, stream);
}
