"""The host's chain walk (block fetches and filtering, the external plan's
``fetch_ms`` summed over the window's calls) as a share of the window."""


def read(ctx):
    totals = ctx["plan_totals"]
    if totals is None or totals.calls == 0:
        return None
    return totals.fetch_ms * 1e-3 / ctx["window_s"]
