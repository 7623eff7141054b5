"""Launches of kernel 5 (``csrc/sc_mac.cu``: the moment MAC and its
split-K pass) a step, from the port's launch counters."""

from perfbench import readers


def read(window, cell):
    return readers.sc_mac_launches(window, "steps")
