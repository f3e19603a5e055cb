"""Share of the window's wall spent outside engine steps and routing
decisions: the gateway's own loop (admission, ticks, bookkeeping)."""


def read(r):
    steps, routes, wall = r.steps, r.routes, r.wall_s
    if not steps or wall <= 0:
        return None
    inside = sum(s["t1"] - s["t0"] for s in steps) \
        + sum(b - a for a, b in routes)
    return 100.0 * (wall - inside) / wall
