"""csr_build_s: seconds of set-up in the port's fenced ``train.csr_build``
span (``core/dtdg.DTDGBatch.csr_pairs``: the 2 T CSR builds of a rank).
None where the span was not recorded."""


def read(ctx):
    return ctx["spans"].get("train.csr_build")
