"""Kernels, row 2: the share of its roofline that the decoder's backward
chain (``kernels.train_scan.backward_chain``) reaches in the traced
steps: the bound of its work (``work.train_scan_work``) over the device
time of every operation it launched."""

from benchmark import readers, work


def read(ctx):
    return readers.roofline(
        ctx, "train_scan_bwd", None,
        lambda c, f: work.train_scan_work(c, f[0], f[1], f[2],
                                          bool(f[3]))[1])
