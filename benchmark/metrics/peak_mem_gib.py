"""The allocator's peak over set-up and window, on the fullest card."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30
