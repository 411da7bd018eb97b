"""Seconds of quantify's set-up before its loop (the index's upload):
map_seconds less map_loop_seconds."""


def read(run):
    c = run.clocks
    if "map_seconds" not in c or "map_loop_seconds" not in c:
        return None
    return c["map_seconds"] - c["map_loop_seconds"]
