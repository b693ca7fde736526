"""The card's peak allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``), in GB (1e9 bytes)."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["peak_bytes"] else None
