"""``lp_rate``: LPs returned with a certified verdict by every call of the
window, over the time from the window's start to the end of its last
call (host clock)."""


def read(record):
    if record["label"] != "batch" or not record["answers"]:
        return None
    n = sum(int(a["certified"].sum()) for a in record["answers"])
    return n / record["window_s"]
