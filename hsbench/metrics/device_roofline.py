"""Share of the memory roofline the device programs reach over the traced
slice: the bytes the requests answered in it need, each input and output
byte once (each template's ``bytes_once``), at the card's published memory
bandwidth, against the seconds the device was busy. Nothing without a
traced slice, busy time or a known card."""


def read(r):
    s = r["slice"]
    if not s or not s["busy_s"] or not s["bytes"] or not s["hbm_bytes_per_s"]:
        return None
    return 100.0 * (s["bytes"] / s["hbm_bytes_per_s"]) / s["busy_s"]
