"""select_share: the share of the requests' wall time spent inside
`select_many` (Algorithm 1, batched), from the benchmark's spans."""


def read(ctx):
    wall = sum(r["wall_s"] for r in ctx["requests"])
    spent = sum(r["select_s"] for r in ctx["requests"])
    if not wall or not spent:
        return None
    return 100.0 * spent / wall
