"""Block reads the store's arena missed (``StoreStats.device_reads``, the
reads that went to the file) per query answered in the window."""


def read(ctx):
    store = ctx["store"]
    if store is None or ctx["rows"] == 0:
        return None
    return store.device_reads / ctx["rows"]
