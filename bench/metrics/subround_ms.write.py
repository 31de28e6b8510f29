"""Host time inside the write sub-rounds (new-order, payment, delivery,
one server or over servers), per traced round."""
NAMES = ("neworder_round", "payment_round", "delivery_round")


def read(ctx):
    spans = ctx["trace"]["spans"]
    t = sum(spans[n][0] for n in NAMES if n in spans)
    return t * 1e3 / ctx["trace_rounds"] if t else None
