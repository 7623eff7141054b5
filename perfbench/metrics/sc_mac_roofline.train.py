"""Kernel 5's share of its roofline: the least time of every
``pallas_moment`` call of the traced sub-window (``sc.dispatch`` span
shapes, ``roofline.sc_mac_bound_s``) over the device time of
``sc_mac_kernel`` and ``sc_mac_reduce_kernel``."""

from perfbench import readers


def read(window, cell):
    return readers.sc_mac_roofline(window)
