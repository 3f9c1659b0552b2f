"""Peak device memory over the window (``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats`` at the window's start), in MiB."""


def read(run):
    return run.peak_bytes / 2**20 if run.peak_bytes else None
