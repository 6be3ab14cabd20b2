"""Bytes the history feed uploads to the card per proposal: the registry
counter ``history.upload_bytes``'s growth over the window."""


def read(run):
    w = run.window
    if not w.suggests:
        return None
    return w.counters["history.upload_bytes"] / w.suggests
