"""The hand-written kernels K1-K6 together: the sum of every call's
least time at the card's peaks (slambench/roofline/k1.py .. k6.py) over
the sum of their kernels' device time in the trace.  The list is fixed:
a kernel added later gets a roofline metric of its own."""

KERNELS = ["k1", "k2", "k3", "k4", "k5", "k6"]


def read(ctx):
    return ctx.roofline(KERNELS)
