"""Kernels, row 5: the share of its roofline that the batched decoder
chunk (``persistent_chunk_kernel``) reaches in the traced batches: the
bound of a whole decode's chunks at each batch's shape
(``work.decode_work``) over the kernel's device time in those batches."""

from benchmark import readers, work


def read(ctx):
    return readers.roofline(
        ctx, "serve_batch", "persistent_chunk_kernel",
        lambda c, f: work.decode_work(c, f[0], f[1], f[3]))
