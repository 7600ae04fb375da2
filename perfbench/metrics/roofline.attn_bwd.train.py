"""roofline.attn_bwd.train — layer: kernels. The attention backward's
bound for one call (one layer's backward: 10·D operations per visible
pair and head, at the configuration's attention rate: bf16 989 TFLOP/s,
f32 165, the 3xTF32 rate) over the device time of one call of the kernels
named here, each kernel's mean time per launch recorded in the traced
slice. Today the call is K7's two kernels (``csrc/flash_bwd.cu``).
Moves ``train_tokens_per_s``."""

from perfbench import flops, tracing

KERNELS = ("flash_bwd_dq", "flash_bwd_dkdv")


def read(run):
    call = run.counters.get("attn_bwd_call")
    peak = run.peaks.get(call["peak"]) if call else None
    per_call = tracing.kernel_mean(run.trace, KERNELS)
    if not peak or not per_call:
        return None
    work = flops.attn_bwd_bound(call["heads"], call["head_dim"],
                                call["pairs"])
    return 100.0 * work / peak / per_call
