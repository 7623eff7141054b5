"""Kernel 5's device time (``sc_mac_kernel`` and ``sc_mac_reduce_kernel``)
as a share of the traced sub-window's wall time."""

from perfbench import readers


def read(window, cell):
    return readers.sc_mac_share(window)
