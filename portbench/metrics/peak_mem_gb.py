"""peak_mem_gb: the most the program's tensors held on the card
(torch.cuda.max_memory_allocated) over set-up and window, in GB (1e9
bytes): the set-up's peak holds a captured graph's activations, which
are allocated while it is captured. The same number is the result's
memory_peak_bytes."""


def read(r):
    peak = max(r.record.peak_setup_bytes, r.record.peak_window_bytes)
    return peak / 1e9 if peak else None
