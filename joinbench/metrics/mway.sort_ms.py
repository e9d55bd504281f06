"""mway.sort_ms (ms, lower is better; layer: the join model,
``models/mway.py`` and ``models/common.py``): the mean over the window's
joins of the program's ``JoinResult.phases["sort"]``, the K1 block sorts
of R and S timed on the host clock after a device sync.  Only the phased
count route reports it."""


def read(run):
    vals = [j["phases"]["sort"] for j in run.joins
            if "sort" in j.get("phases", {})]
    return 1e3 * sum(vals) / len(vals) if vals else None
