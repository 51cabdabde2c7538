"""Seconds from the start of set-up until every shape is warm: build, weights, inputs, checked updates, warm-up."""


def read(reading):
    return reading.outcome.setup_s
