"""peak_device_gib: ``torch.cuda.max_memory_allocated`` over the window,
GiB."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2 ** 30
