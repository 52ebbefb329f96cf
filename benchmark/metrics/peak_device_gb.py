"""``peak_device_gb``: ``torch.cuda.max_memory_allocated()`` over the
window, reset as it opens, so the resident inputs count; in 1e9 bytes."""


def read(ctx):
    peak = ctx.get('peak_window_bytes')
    return None if peak is None else peak / 1e9
