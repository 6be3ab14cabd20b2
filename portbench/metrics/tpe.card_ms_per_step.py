"""The card's busy time (the union of the device operations' intervals)
per proposal of the hosted loop, in the traced segment: the hosted twin
of `fleet.card_ms_per_replay`.  Set beside `suggest_p50_ms`, it says
whether the card or the host paces a proposal."""


def read(run):
    t = run.traced
    if t is None or not t.steps:
        return None
    return t.reduced["busy_s"] * 1e3 / t.steps
