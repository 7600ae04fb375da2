// Flash-attention forward with an additive key bias and a visibility
// offset (K5), for Hopper (sm_90a). Plain C interface, loaded with ctypes
// by deeplearning4j_tpu_torch/ops/flash_attention.py; built into one
// library with csrc/flash_attention.cu (K4), which calls this entry point.
// The kernels are csrc/flash_fwd.cuh's (its note says what bounds them
// and what their design does about it).
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py, _flash_ext_raw
// (kernel body _flash_ext_kernel), reached through flash_attention_block
// (the ring's local block product) and flash_attention_masked (a key
// padding mask, from attention_auto).
//
// Function: q [N,Tq,H,D], k, v [N,Tk,H,D] (read in place through their
// strides), an optional additive key bias kb [N,Tk] f32 (0 keeps a key,
// -inf masks it; shared by the heads) and a host integer off. Key ki is
// visible to query qi iff qi + off >= ki: off = 0 is causal, off >= Tk
// shows every key, off <= -Tq hides every key (a ring step whose K/V
// shard lies wholly in the future). A window win > 0 also hides key ki
// from query qi where qi + off - ki >= win (a sliding-window layer); win
// = 0 is none, and launches the kernels compiled without the test.
// Outputs O [N,Tq,H,D] in q's dtype and
// lse [N,H,Tq] f32; a row with no visible key gives O = 0 and lse = -inf
// exactly. Any Tq and Tk (the TPU kernel needed both % 128).

#include "flash_fwd.cuh"

// dtype codes: 0 = float32, 1 = bfloat16. kb is a contiguous [N,Tk]
// float32 bias or null (no bias). o must be a contiguous [N,Tq,H,D]
// buffer of q's dtype, lse a contiguous [N,H,Tq] float32 one. off must
// lie in [-Tq, Tk] (the caller clamps it: the function does not change);
// win >= 0.
// Returns the CUDA error of the launch (0 = success); an unsupported head
// size or dtype returns cudaErrorInvalidValue without launching.
extern "C" int flash_attention_ext_fwd(
    const void* q, const void* k, const void* v, const void* kb, void* o,
    void* lse, int N, int Tq, int Tk, int H, int D, long long q_sn,
    long long q_st, long long q_sh, long long k_sn, long long k_st,
    long long k_sh, long long v_sn, long long v_st, long long v_sh, int off,
    int win, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0 || H == 0 || Tq == 0) return 0;
  if (off < -Tq || off > Tk || win < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Params a{q, k, v, static_cast<const float*>(kb), o,
                        static_cast<float*>(lse), N, Tq, Tk, H, off, win,
                        flash::Strides{q_sn, q_st, q_sh},
                        flash::Strides{k_sn, k_st, k_sh},
                        flash::Strides{v_sn, v_st, v_sh}};
  err = flash::run(a, D, dtype, device, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
