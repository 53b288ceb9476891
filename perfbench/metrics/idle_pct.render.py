"""The card's idle share of the traced window: 100 x (1 - the union of
its operations' intervals / the window)."""


def read(rec):
    if not rec["ops"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["traced_s"])
