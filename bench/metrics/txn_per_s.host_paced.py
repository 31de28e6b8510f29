"""``txn_per_s`` where it is a per-layer metric: committed transactions of
every type in the window over the window's host time (from the first
round's draw to the synchronisation after the driver returns). The host's
Python paces every round, so the rate follows the host's speed."""


def read(ctx):
    s = ctx["stats"]
    commits = sum(v for k, v in s.items() if k.startswith("commits"))
    return commits / ctx["seconds"]
