"""rerank_pairs_per_s: the (query, candidate) pairs scored in the window,
over the whole window (host clock; the window ends when the device has
finished its work)."""


def read(run):
    done = run.work.get("pairs")
    if not done or not run.window_s:
        return None
    return done / run.window_s
