"""peak_mem_gb: ``torch.cuda.max_memory_allocated()`` over set-up and window, in GB (1e9 B).

Read from the card's allocator; nothing where no card was used."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
