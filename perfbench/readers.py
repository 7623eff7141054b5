"""What the per-layer readers (``metrics/<metric>.py``) share: each
reads one traced sub-window (``trace.Window``) of a cell and returns a
number, or None where the window holds nothing of what it reads."""

from __future__ import annotations

from perfbench import roofline

#: kernel 5, ``csrc/sc_mac.cu``: the moment MAC and its split-K pass
SC_MAC = "sc_mac_"


def mfu(window, cell, tokens: float, flops_per_token: float) -> float:
    """Model FLOPs of ``tokens`` over the window's wall time, as a share
    of the card's dense tensor-core peak in the mix's dtype."""
    peak = roofline.PEAK[cell.mix["dtype"]]
    return 100.0 * flops_per_token * tokens / window.seconds / peak


def sc_mac_launches(window, per: str):
    """Kernel-5 launches (both kernels) a ``per`` unit of the window
    (``steps``), from the port's launch counters."""
    n = sum(v for k, v in window.launches.items()
            if k.startswith(SC_MAC.rstrip("_")))
    return n / window.info[per] if n else None


def sc_mac_roofline(window):
    """Kernel 5's share of its roofline: the least time of every
    ``pallas_moment`` call (shapes from the port's ``sc.dispatch``
    spans) over the device time of its kernels."""
    calls = [s.attrs for s in window.spans if s.name == "sc.dispatch"
             and s.attrs.get("backend") == "pallas_moment"]
    spent = window.device_s(SC_MAC)
    if not calls or spent <= 0:
        return None
    bound = sum(roofline.sc_mac_bound_s(a["m"], a["k"], a["n"])
                for a in calls)
    return 100.0 * bound / spent


def sc_mac_share(window):
    """Kernel 5's device time as a share of the window's wall time."""
    spent = window.device_s(SC_MAC)
    return 100.0 * spent / window.seconds if spent > 0 else None


def device_idle(window):
    """Share of the window in which no operation ran on the card."""
    return 100.0 * (1.0 - window.busy_s() / window.seconds)
