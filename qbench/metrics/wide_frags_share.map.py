"""Share of the run's fragments that the batch step marked for the wide
pass (a fixed-shape cap may have cut their labels): the program's
frags_marked over frags_processed, from its clocks record, %; nothing
where the program keeps no such counter."""


def read(run):
    marked = run.clocks.get("frags_marked")
    n = run.clocks.get("frags_processed")
    if marked is None or not n:
        return None
    return 100.0 * marked / n
