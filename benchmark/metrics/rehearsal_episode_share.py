"""The rehearsal families' share of the episodes that finished in the
untraced window: 100 x the episodes of the families stage_1..stage_5,
corridor and cross over the episodes of every family, the scheduled ones
among them, from the change of the program's counters
`rehearsal.episodes[<family>]` over the window (`learn/zoo.py::
count_rehearsal`).  A program without the counters reads nothing."""

PREFIX = "rehearsal.episodes["


def read(run):
    episodes = {k[len(PREFIX):-1]: v for k, v in run.counters.items() if k.startswith(PREFIX)}
    total = sum(episodes.values())
    if "schedule" not in episodes or total <= 0:
        return None
    return 100.0 * (total - episodes["schedule"]) / total
