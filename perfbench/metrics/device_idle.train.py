"""Share of the traced sub-window in which no operation ran on the card:
one minus the union of the device operations' intervals over the
window's wall time."""

from perfbench import readers


def read(window, cell):
    return readers.device_idle(window)
