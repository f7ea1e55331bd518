"""Seconds per drive of ``replicate_workload`` that no stage of
``GreedyStats.stage_s`` books: the harness's span around the call less
its "gate", "update", "revalidate" and "prune" stages (the path dedup,
the class plan, the C(h, t) tables, the packing, uploads and readbacks),
the mean over the window's drives.  "revalidate" holds the gate and
UPDATE stages of its own rounds, which are booked twice and so taken off
twice: the reading is low by those seconds."""

STAGES = ("gate", "update", "revalidate", "prune")


def read(run):
    d = run.drives
    return sum(x["replicate_s"] - sum(x["stage_s"].get(k, 0.0) for k in STAGES)
               for x in d) / len(d)
