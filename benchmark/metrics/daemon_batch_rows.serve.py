"""``daemon_batch_rows.serve``: the mean ``batch_size`` the daemon reports
in its 200 replies of the window (the rows of the drain that served each
request)."""


def read(run, trace):
    rows = [r["batch_size"] for r in run.replies() if "batch_size" in r]
    return sum(rows) / len(rows) if rows else None
