"""roofline.attn_fwd.train — layer: kernels. The attention forward's
bound for one call (one layer's K4/K5 launch: 4·D operations a visible
pair and head, windowed pairs on sliding layers, the mean over the
model's layers, at the configuration's attention rate: bf16 989 TFLOP/s)
over the mean recorded time of a launch of the kernels named here in the
traced slice (``csrc/flash_fwd.cuh``'s, the forward and the activation
checkpoint's recompute alike). Moves ``train_tokens_per_s``."""

from perfbench import flops_moe, tracing

KERNELS = ("flash_fwd_tc",)


def read(run):
    call = run.counters.get("attn_fwd_call")
    peak = run.peaks.get(call["peak"]) if call else None
    per_call = tracing.kernel_mean(run.trace, KERNELS)
    if not peak or not per_call:
        return None
    work = flops_moe.attn_fwd_bound(call["heads"], call["head_dim"],
                                    call["pairs"])
    return 100.0 * work / peak / per_call
