"""The most device memory that torch's allocator held during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), MiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 20 if run.peak_window_bytes else None
