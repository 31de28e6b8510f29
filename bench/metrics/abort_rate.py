"""(attempts - commits) / attempts over the window, from the driver's
statistics: the work the protocol wastes and retries."""


def read(ctx):
    s = ctx["stats"]
    att = sum(v for k, v in s.items() if k.startswith("attempts"))
    com = sum(v for k, v in s.items() if k.startswith("commits"))
    return (att - com) / att if att else None
