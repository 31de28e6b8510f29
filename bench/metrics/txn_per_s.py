"""Committed transactions of every type in the window over the window's
host time (from the first round's draw to the synchronisation after the
driver returns)."""


def read(ctx):
    s = ctx["stats"]
    commits = sum(v for k, v in s.items() if k.startswith("commits"))
    return commits / ctx["seconds"]
