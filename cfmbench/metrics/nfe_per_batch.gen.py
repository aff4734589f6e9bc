"""Vector-field evaluations a batch over the window, from ``Generated.nfe``."""


def read(trace, outcome):
    return outcome.get("nfe_per_batch")
