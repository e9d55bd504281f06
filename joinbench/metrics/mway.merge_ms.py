"""mway.merge_ms (ms, lower is better; layer: the join model,
``models/mway.py`` and ``models/common.py``): the mean over the window's
joins of the program's ``phases["merge1"] + phases["mergerest"]``, the K2
merge levels of R and S.  Only the phased count route reports it."""


def read(run):
    vals = [j["phases"]["merge1"] + j["phases"]["mergerest"]
            for j in run.joins if "merge1" in j.get("phases", {})]
    return 1e3 * sum(vals) / len(vals) if vals else None
