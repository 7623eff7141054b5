"""Model FLOPs of the traced steps (6 x the matmul parameters a token,
``roofline.train_flops_per_token``) over the traced sub-window's wall
time, as a share of the card's dense peak in the mix's dtype."""

from perfbench import readers, roofline


def read(window, cell):
    return readers.mfu(window, cell, window.info["tokens"],
                       roofline.train_flops_per_token(cell.config["sizes"]))
