"""encode_share: the share of the requests' wall time from the end of the
decision stage (the last `select_many` or `solve_many` span) to the
request's return: the encoders, the copies to the host and the
containers, from the benchmark's spans."""


def read(ctx):
    wall = sum(r["wall_s"] for r in ctx["requests"])
    decided = [r for r in ctx["requests"] if r["decided_s"] is not None]
    if not wall or not decided:
        return None
    return 100.0 * sum(r["wall_s"] - r["decided_s"] for r in decided) / wall
