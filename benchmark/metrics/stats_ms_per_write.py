"""The mean host time of a statistics write in the window: the host clock
around each tools.dns.write_statistics call (which ends in the tables'
copy to the host and their files)."""


def read(ctx):
    s = ctx["window"].stats_s
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
