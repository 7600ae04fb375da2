"""device_idle_pct.train — layer: device. The share of the traced slice
in which no kernel, copy or memset ran on the card (``torch.profiler``,
the union of the device records). Moves ``train_tokens_per_s``."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return run.trace.idle_pct
