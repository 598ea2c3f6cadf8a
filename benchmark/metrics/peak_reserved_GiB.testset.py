"""peak_reserved_GiB.testset (device memory, GiB): the most memory the
process's allocator held on the card (``torch.cuda.max_memory_reserved``):
the U program chains' graph pools, the model and the window's tensors."""


def read(run):
    b = run["memory"]["reserved_peak"]
    return b / 2 ** 30 if b else None
