"""Set-up seconds: process start to the first timed unit (host clock)."""


def read(record):
    return record["setup_s"]
