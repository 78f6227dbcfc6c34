"""Wall seconds of the configuration's ``create_index`` calls in set-up,
each synchronised with the card."""


def read(r):
    return r["build_s"]
