"""device_mem_gib: the most memory the process reserved on the card
(``torch.cuda.max_memory_reserved``) from the localizer's construction to
the end of the window, in GiB: what the localizer takes from everything
else on the card.  The benchmark's own traffic generation comes before the
peak is reset, and its reference after the peak is read."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.cuda else None
